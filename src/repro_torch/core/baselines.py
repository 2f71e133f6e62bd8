"""Baseline checkpointing planners the paper compares against (§6.1),
the counterparts of the reference's ``core/baselines.py``.

* ``SublinearPlanner`` — static: one conservative plan computed for the
  *largest* input size the task can produce, applied to every batch
  (Chen et al. 2016 as deployed in the paper's Fig. 4 experiment).
* ``DTRSimPlanner`` — dynamic: greedy evict-on-OOM per iteration with no
  plan reuse and with DTR's measured memory-fragmentation inflation
  (paper §3.2 / Fig. 5); the planning cost is paid again on every batch.

Both take ``max_microbatches``: Sublinear's one static plan may pick a
gradient-accumulation split for the largest size, and DTR raises the
split only when even evict-everything cannot fit the budget.
``SublinearPlanner`` also takes ``MimosePlanner``'s ``offload=`` /
``pcie_gbps=`` / ``offload_overlap=`` knobs (its static plan may then
OFFLOAD units); DTR's evict-on-OOM is remat-only by construction.
Both take ``MimosePlanner``'s ``mesh_budget=`` and go through the same
shared accounting (``PlannerBase``), so the comparisons stay like for
like under a mesh.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.collector import ShuttlingCollector, input_size_of
from repro_torch.core.estimator import PolyEstimator
from repro_torch.core.planner import DEGREE, BUCKET_TOL, PlanInfo, PlannerBase
from repro_torch.core.scheduler import Plan, greedy_plan, greedy_plan_adaptive
from repro_torch.core.simulator import dtr_simulate, simulate
from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.sharding.budget import MeshBudget


class SublinearPlanner(PlannerBase):
    name = "sublinear"

    def __init__(self, lm, budget_bytes: Optional[float] = None,
                 max_input_size: int = 0, *,
                 fixed_bytes: Optional[float] = None,
                 mesh_budget: Optional[MeshBudget] = None,
                 warmup_samples: int = 4,
                 cost_aware: bool = True,
                 offload: bool = False,
                 pcie_gbps: Optional[float] = None,
                 offload_overlap: float = 0.5,
                 max_microbatches: int = 1,
                 microbatch_overhead_s: Optional[float] = None):
        if not max_input_size:
            raise ValueError("max_input_size is required")
        self.lm = lm
        self.mesh_budget = mesh_budget
        self.budget_bytes = self.resolve_budget_bytes(budget_bytes)
        self.max_input_size = int(max_input_size)
        self.fixed_bytes = fixed_bytes
        self.cost_aware = cost_aware
        self.max_microbatches = max(int(max_microbatches), 1)
        self.microbatch_overhead_s = microbatch_overhead_s
        self._init_hybrid(offload=offload, pcie_gbps=pcie_gbps,
                          offload_overlap=offload_overlap,
                          cost_aware=cost_aware, min_samples=warmup_samples)
        self.collector = ShuttlingCollector(lm, mesh_budget=mesh_budget)
        self.estimator = PolyEstimator(DEGREE, min_samples=warmup_samples)
        self._plan: Optional[Plan] = None

    def _build_static_plan(self, batch):
        """Collect a few sizes (the static planner may analyse the model
        ahead of time; the collector does it), then plan once at the
        maximum input size."""
        B = int(batch["tokens"].shape[0])
        sizes = np.linspace(max(B, self.max_input_size // 8),
                            self.max_input_size,
                            self.estimator.min_samples).astype(int)
        probe = batch
        for s in sizes:
            probe = dict(batch)
            probe["tokens"] = torch.zeros((B, max(1, int(s) // B)),
                                          dtype=torch.long)
            if "frames" in batch:
                probe["frames"] = torch.zeros(
                    (B, max(1, int(s) // B), self.lm.cfg.d_model))
            res = self.collector.collect(probe)
            self.estimator.add_sample(res.input_size,
                                      self.collected_vector(res))
            self._feed_hybrid_estimators(res.input_size, res)
        est = self.estimator.predict(self.max_input_size)
        # recompute cost at the planning geometry (the largest probe)
        flops = (plan_unit_flops(self.lm, probe) if self.cost_aware
                 else None)
        ks = self.candidate_microbatches(probe)
        if ks == [1]:
            self._plan = greedy_plan(
                est, self.budget_bytes, self.resolve_fixed_bytes(),
                tol=BUCKET_TOL, flops=self.planning_flops(flops),
                **self._hybrid_kwargs(self.max_input_size))
            return

        def vectors_of_k(k):
            # the static plan is for the LARGEST input size, so the
            # per-microbatch vectors are the fits at max_size / k
            probe_k = self.microbatch_probe(probe, k)
            s_k = input_size_of(probe_k)
            d = {"est_mem": self.estimator.predict(s_k)}
            if self.cost_aware:
                d["flops"] = self.planning_flops(
                    plan_unit_flops(self.lm, probe_k))
                d["pad_overhead_s"] = self.pad_waste_s(probe, k,
                                                       d["flops"])
            hv = self._hybrid_vectors(s_k)
            if hv is not None:
                d["output_bytes"], d["offload_bytes"] = hv
            return d

        self._plan = greedy_plan_adaptive(
            vectors_of_k, self.budget_bytes, self.resolve_fixed_bytes(),
            candidate_ks=ks, tol=BUCKET_TOL,
            pcie_bytes_per_s=self.link_bytes_per_s(),
            offload_overlap=self.offload_overlap,
            accum_overhead_s=self.accum_overhead_s())

    def plan(self, batch):
        if self._plan is None:
            self._build_static_plan(batch)
        s = input_size_of(batch)
        return self._plan.as_actions(), PlanInfo(s, self.bucket_key(batch),
                                                 True, False, self._plan)


class DTRSimPlanner(PlannerBase):
    name = "dtr"

    def __init__(self, lm, budget_bytes: Optional[float] = None, *,
                 fixed_bytes: Optional[float] = None,
                 mesh_budget: Optional[MeshBudget] = None,
                 frag_factor: float = 1.25,
                 plan_op_cost_s: float = 2e-5,
                 max_microbatches: int = 1):
        self.lm = lm
        self.mesh_budget = mesh_budget
        self.budget_bytes = self.resolve_budget_bytes(budget_bytes)
        self.fixed_bytes = fixed_bytes
        self.frag_factor = frag_factor
        self.plan_op_cost_s = plan_op_cost_s
        self.max_microbatches = max(int(max_microbatches), 1)
        self.collector = ShuttlingCollector(lm, mesh_budget=mesh_budget)
        self._size_cache: Dict[tuple, np.ndarray] = {}
        self.stats = {"plan_ops": 0, "plan_time_s": 0.0, "replans": 0}

    def _act_vector(self, batch, k: int) -> np.ndarray:
        """Concrete per-unit byte vector at split ``k`` (DTR sees real
        tensor sizes, so one collection per (size, split) geometry)."""
        s = input_size_of(batch)
        if (s, k) not in self._size_cache:
            probe = batch if k == 1 else self.microbatch_probe(batch, k)
            self._size_cache[(s, k)] = self.collected_vector(
                self.collector.collect(probe))
        return self._size_cache[(s, k)]

    def plan(self, batch):
        s = input_size_of(batch)
        # DTR knows tensor sizes at runtime; it just never reuses
        # planning work across iterations
        self.resolve_fixed_bytes()
        t0 = time.perf_counter()
        plan_ops = 0
        # no cost model: raise the split only when the evict-on-OOM
        # replay cannot fit (smallest feasible k; the largest k as best
        # effort when nothing fits)
        ks = self.candidate_microbatches(batch)
        act = mask = None
        chosen = 1
        for k in ks:
            act = self._act_vector(batch, k)
            mask, ops = dtr_simulate(act, self.budget_bytes,
                                     self.fixed_bytes, self.frag_factor)
            plan_ops += ops
            chosen = k
            # feasibility under DTR's OWN memory model: the replayed
            # peak inflated by the same fragmentation factor
            if (len(ks) == 1
                    or simulate(act, mask, self.fixed_bytes).peak_bytes
                    * self.frag_factor <= self.budget_bytes):
                break
        self.stats["plan_ops"] += plan_ops
        self.stats["replans"] += 1
        # model DTR's on-demand eviction search cost (paper: 4.4-6.1% of
        # iteration time); charged every iteration, cache-free
        self.stats["plan_time_s"] += (time.perf_counter() - t0
                                      + plan_ops * self.plan_op_cost_s)
        p = Plan(list(mask), 0.0, float(act[np.asarray(mask)].sum()),
                 float(act.sum()))
        p.microbatch = chosen
        return p.as_actions(), PlanInfo(s, self.bucket_key(batch), False,
                                        False, p)
