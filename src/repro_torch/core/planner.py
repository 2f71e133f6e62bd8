"""MimosePlanner — the input-aware checkpointing planner (paper §4).

Counterpart of the reference's ``core/planner.py`` (single device).
Ties together the shuttling collector, the lightning estimator, the
responsive scheduler and the plan cache:

    planner = MimosePlanner(lm, budget_bytes=6 << 30)
    actions, info = planner.plan(batch)
    loss, _ = lm.loss(batch, actions)

Phases (paper §4.1):
  * sheltered execution — while the estimator has fewer than
    ``warmup_samples`` distinct input sizes, each new size triggers the
    collector, and the collected bytes plan that iteration directly;
  * responsive execution — the estimator predicts per-unit bytes for
    any size, the scheduler plans in O(n log n), and the plan cache
    keyed by the quantised input size makes repeats free.

Adaptive microbatching (``max_microbatches > 1``): the search also
spans the gradient-accumulation split ``k`` per bucket — the per-unit
vectors at split ``k`` are the estimator's predictions at input size
``~s/k`` (or a collection on the split geometry while sheltered), and
the ``(k, action-plan)`` pair with the lowest simulated step overhead
wins (``scheduler.greedy_plan_adaptive``).  ``Plan.microbatch`` tells
the trainer to run the step as ``k`` accumulated microbatches.

Background solver (``solver="dp"``): after greedy served a bucket, a
daemon thread solves its (k, action) assignment exactly and swaps a
strictly better plan into the cache under ``_cache_lock``
(``core/solver.py``).

Plans are KEEP/REMAT only: ``offload=True`` and ``opt_offload=True``
raise until the port executes OFFLOAD.  The reference's OOM escalation
(``escalate``, ``record_oom``) is not ported.  Stats live in a plain
dict under the reference's keys.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import LRUCache
from repro_torch.core.collector import ShuttlingCollector, input_size_of
from repro_torch.core.estimator import PolyEstimator
from repro_torch.core.scheduler import (Plan, greedy_plan,
                                        greedy_plan_adaptive)
from repro_torch.core.solver import BackgroundSolver, SolveRequest
from repro_torch.data.pipeline import bucket_length
from repro_torch.launch.roofline import (MICROBATCH_OVERHEAD_S, PCIE_BW,
                                         PEAK_FLOPS, plan_unit_flops)

# the reference's defaults, fixed here: estimator degree (paper §4.3),
# scheduler bucket tolerance (Algorithm 1), plan-cache bound, and the
# relative drift that triggers a refit
DEGREE = 2
BUCKET_TOL = 0.10
MAX_PLANS = 256
AUDIT_TOL = 0.02


def fixed_train_bytes(params: Iterable[torch.Tensor]) -> int:
    """Resident bytes independent of input size: params + grads (same
    dtype) + fp32 AdamW moments."""
    params = list(params)
    pb = sum(p.numel() * p.element_size() for p in params)
    n = sum(p.numel() for p in params)
    return pb + pb + 2 * 4 * n


@dataclasses.dataclass
class PlanInfo:
    input_size: int
    quantized_size: int
    cache_hit: bool
    collected: bool
    plan: Plan
    estimate_time_s: float = 0.0
    schedule_time_s: float = 0.0
    collect_time_s: float = 0.0


class PlannerBase:
    quantum: int = 1          # batch geometry granularity (1 = no bucketing)
    fixed_bytes: Optional[float] = None
    # adaptive microbatching: the largest gradient-accumulation split the
    # planner may pick per bucket (1 = plain full-batch steps), and the
    # fixed per-extra-microbatch cost it prices the split at (None:
    # ``MICROBATCH_OVERHEAD_S``, read when a plan is made)
    max_microbatches: int = 1
    microbatch_overhead_s: Optional[float] = None
    # host-link pricing in GB/s (None: ``PCIE_BW``, read when a plan is
    # made), part of the plan key as in the reference (no planner of the
    # port plans OFFLOAD yet)
    pcie_gbps: Optional[float] = None
    offload_overlap: float = 0.5

    def plan(self, batch) -> Tuple[tuple, PlanInfo]:
        """Returns ``(Plan.as_actions(), PlanInfo)``."""
        raise NotImplementedError

    def resolve_fixed_bytes(self) -> float:
        """Resident bytes, resolved lazily from the model's parameters."""
        if self.fixed_bytes is None:
            self.fixed_bytes = fixed_train_bytes(self.lm.parameters())
        return self.fixed_bytes

    def bucket_key(self, batch) -> int:
        """The shared bucket id: the quantised input size."""
        return bucket_length(input_size_of(batch), self.quantum)

    def accum_overhead_s(self) -> float:
        """The price of one extra microbatch, in seconds."""
        return float(MICROBATCH_OVERHEAD_S if self.microbatch_overhead_s
                     is None else self.microbatch_overhead_s)

    def link_bytes_per_s(self) -> float:
        """The host link rate plans are priced at, in bytes/s."""
        return float(PCIE_BW if self.pcie_gbps is None
                     else self.pcie_gbps * 1e9)

    def plan_key(self, batch) -> tuple:
        """Plan-cache key: (bucket id, mesh signature (always () on one
        device), microbatch ceiling, link GB/s, offload overlap, the
        accumulation overhead).  A plan built under one knob setting —
        or priced at other roofline constants — is never replayed under
        another; the chosen ``k`` is plan output (``Plan.microbatch``)."""
        return (self.bucket_key(batch), (), self.max_microbatches,
                round(self.link_bytes_per_s() / 1e9, 6),
                round(float(self.offload_overlap), 6),
                self.accum_overhead_s())

    def planning_flops(self, flops):
        """The recompute-cost vector in the frame of the byte vectors.
        On one device both are global, so it is ``flops`` itself; the
        reference divides by the mesh's device count here (A19)."""
        return flops

    # -- shared adaptive-microbatching machinery -------------------------
    def candidate_microbatches(self, batch) -> list:
        """Every ``k`` in ``1..max_microbatches``, capped at the batch
        size (a split cannot make more microbatches than rows)."""
        B = int(batch["tokens"].shape[0])
        kmax = max(min(int(self.max_microbatches), B), 1)
        return list(range(1, kmax + 1))

    @staticmethod
    def pad_waste_s(batch, k: int, flops_mb) -> float:
        """Per-step time a non-divisor split wastes on batch-axis pad
        rows: ``split_batch`` pads ``B`` up to ``ceil(B/k)*k`` rows and
        the step computes a full forward+backward over them.  The
        per-microbatch flops vector is priced at the padded
        ``ceil(B/k)``-row geometry, so the waste is its pad-row share
        across all ``k`` microbatches at ``PEAK_FLOPS`` (backward ~= 2x
        forward).  Zero when ``k`` divides ``B``."""
        B = int(batch["tokens"].shape[0])
        k = max(int(k), 1)
        rows = -(-B // k) * k
        if rows == B or flops_mb is None:
            return 0.0
        frac = (rows - B) / rows
        return frac * 3.0 * k * float(np.sum(flops_mb)) / PEAK_FLOPS

    @staticmethod
    def microbatch_probe(batch, k: int) -> dict:
        """The batch geometry of ONE microbatch at split ``k``: every
        entry's batch axis cut to ``ceil(B/k)`` rows (only shapes matter
        downstream: collection runs on ``meta`` tensors and
        ``plan_unit_flops`` reads geometry)."""
        B = int(batch["tokens"].shape[0])
        Bk = max(-(-B // max(int(k), 1)), 1)
        return {key: v[:Bk] for key, v in batch.items()}


class NonePlanner(PlannerBase):
    """No checkpointing (the paper's PyTorch baseline)."""

    def __init__(self, lm):
        self.lm = lm

    def plan(self, batch):
        n = self.lm.num_plan_units()
        p = Plan([False] * n, 0.0, 0.0, 0.0)
        return p.as_actions(), PlanInfo(input_size_of(batch),
                                        self.bucket_key(batch), True,
                                        False, p)


class MimosePlanner(PlannerBase):
    def __init__(self, lm, budget_bytes: float, *,
                 quantum: int = 256,
                 warmup_samples: int = 4,
                 cost_aware: bool = True,
                 audit_every: int = 0,
                 max_microbatches: int = 1,
                 microbatch_overhead_s: Optional[float] = None,
                 solver: str = "off",
                 solver_budget_ms: float = 50.0,
                 offload: bool = False,
                 opt_offload: bool = False):
        if offload or opt_offload:
            raise ValueError("offload=True / opt_offload=True: the port "
                             "does not execute OFFLOAD yet (ROADMAP A13)")
        if solver not in ("off", "dp"):
            raise ValueError(f"solver must be 'off' or 'dp', got "
                             f"{solver!r}")
        self.lm = lm
        self.budget_bytes = float(budget_bytes)
        self.fixed_bytes = None                 # resolved lazily from params
        self.quantum = quantum
        self.warmup_samples = warmup_samples
        # cost-aware selection (bytes freed per recompute-FLOP, floored
        # by the byte-only oracle); False = the paper's Algorithm 1
        self.cost_aware = cost_aware
        # every ``audit_every``-th unseen size, re-collect and re-fit if
        # the prediction drifted beyond AUDIT_TOL
        self.audit_every = audit_every
        # adaptive microbatching: up to this many accumulation
        # microbatches per bucket, each extra one priced at the overhead
        self.max_microbatches = max(int(max_microbatches), 1)
        self.microbatch_overhead_s = microbatch_overhead_s
        self.collector = ShuttlingCollector(lm)
        self.estimator = PolyEstimator(DEGREE, min_samples=warmup_samples)
        self.cache = LRUCache(MAX_PLANS)
        self.stats = {"cache_hits": 0, "cache_misses": 0, "collections": 0,
                      "collect_time_s": 0.0, "estimate_time_s": 0.0,
                      "schedule_time_s": 0.0, "audits": 0, "refits": 0,
                      "evictions": 0, "solves": 0, "solver_swaps": 0,
                      "solver_wins": 0, "solver_timeouts": 0}
        # optimal-plan tier: a daemon thread solves the (k, action)
        # assignment exactly and swaps strictly better plans into the
        # cache; every cache access goes through _cache_lock so the swap
        # is atomic against the training thread
        self.solver = solver
        self.solver_budget_ms = float(solver_budget_ms)
        self._cache_lock = threading.RLock()
        self.background_solver = (
            BackgroundSolver(self, budget_ms=self.solver_budget_ms)
            if solver == "dp" else None)

    def _collect(self, batch):
        """One online collection, booked in the stats."""
        res = self.collector.collect(batch)
        self.stats["collections"] += 1
        self.stats["collect_time_s"] += res.collect_time_s
        return res

    def _microbatch_vectors(self, batch, k: int, est1, flops1, res) -> dict:
        """Per-microbatch planning vectors at split ``k`` for
        ``greedy_plan_adaptive``: estimator predictions at the
        microbatch input size once the fits are ready, a collection on
        the split geometry while sheltered (this ``plan()`` collected at
        k = 1; the extra sample feeds the fits).  ``k == 1`` reuses the
        vectors the plain path derived."""
        if k == 1:
            est, flops = est1, flops1
        else:
            probe = self.microbatch_probe(batch, k)
            size = input_size_of(probe)
            res_k = None
            if res is None and self.estimator.ready:
                est = self.estimator.predict(size)
            else:
                res_k = self._collect(probe)
                self.estimator.add_sample(size, res_k.activation_vector())
                est = res_k.activation_vector()
            flops = None
            if self.cost_aware:
                flops = (res_k.flops_vector() if res_k is not None
                         else plan_unit_flops(self.lm, probe))
        d = {"est_mem": est}
        if flops is not None:
            d["flops"] = self.planning_flops(flops)
            d["pad_overhead_s"] = self.pad_waste_s(batch, k, d["flops"])
        return d

    def plan(self, batch):
        s = input_size_of(batch)
        qs = bucket_length(s, self.quantum)
        key = self.plan_key(batch)
        with self._cache_lock:
            p = self.cache.get(key)
        if p is not None:
            self.stats["cache_hits"] += 1
            # a background-solved plan lands here on the next step of
            # its bucket — the daemon already swapped it in
            self._maybe_submit_solve(batch, key, p)
            return p.as_actions(), PlanInfo(s, qs, True, False, p)
        self.stats["cache_misses"] += 1

        collected = False
        flops = None
        res = None
        t_est = t_col = 0.0
        if not self.estimator.ready:
            # sheltered execution: collect this size online; the
            # collection carries the recompute-cost vector too
            res = self._collect(batch)
            self.estimator.add_sample(s, res.activation_vector())
            est = res.activation_vector()
            if self.cost_aware:
                flops = res.flops_vector()
            collected = True
            t_col = res.collect_time_s
        else:
            t0 = time.perf_counter()
            est = self.estimator.predict(s)
            t_est = time.perf_counter() - t0
            self.stats["estimate_time_s"] += t_est
            if (self.audit_every
                    and self.stats["cache_misses"] % self.audit_every == 0):
                # drift audit: exact re-collection for this size
                self.stats["audits"] += 1
                audit = self._collect(batch)
                truth = audit.activation_vector()
                err = abs(truth.sum() - est.sum()) / max(truth.sum(), 1.0)
                if err > AUDIT_TOL:
                    self.estimator.add_sample(s, truth)
                    self.estimator.fit()
                    est = truth
                    res = audit                 # exact vectors for this plan
                    self.stats["refits"] += 1
                    with self._cache_lock:
                        # stale plans out — also drops in-flight solves:
                        # their swap is identity-checked
                        self.cache.clear()

        t0 = time.perf_counter()
        if self.cost_aware and flops is None:
            flops = plan_unit_flops(self.lm, batch)
        ks = self.candidate_microbatches(batch)
        if ks == [1]:
            plan = greedy_plan(est, self.budget_bytes,
                               self.resolve_fixed_bytes(), tol=BUCKET_TOL,
                               flops=self.planning_flops(flops))
        else:
            plan = greedy_plan_adaptive(
                lambda k: self._microbatch_vectors(batch, k, est, flops,
                                                   res),
                self.budget_bytes, self.resolve_fixed_bytes(),
                candidate_ks=ks, tol=BUCKET_TOL,
                pcie_bytes_per_s=self.link_bytes_per_s(),
                offload_overlap=self.offload_overlap,
                accum_overhead_s=self.accum_overhead_s())
        t_sch = time.perf_counter() - t0
        self.stats["schedule_time_s"] += t_sch
        with self._cache_lock:
            self.cache[key] = plan
        self.stats["evictions"] = self.cache.evictions
        self._maybe_submit_solve(batch, key, plan)
        return plan.as_actions(), PlanInfo(s, qs, False, collected, plan,
                                           t_est, t_sch, t_col)

    def _maybe_submit_solve(self, batch, key, plan) -> None:
        """Queue an exact background solve for this bucket.  Greedy
        already served the step — this never blocks.  Skipped while the
        estimator is warming up (sheltered plans are exact for their
        collections) and for plans the solver produced or checked.  The
        planning vectors are materialised here, on the training thread,
        so the daemon stays numpy-only."""
        bs = self.background_solver
        if (bs is None or not self.estimator.ready
                or getattr(plan, "solver_checked", False)
                or plan.source == "dp" or bs.pending(key)):
            return
        s = input_size_of(batch)
        est1 = self.estimator.predict(s)
        flops1 = plan_unit_flops(self.lm, batch) if self.cost_aware else None
        ks = self.candidate_microbatches(batch)
        vectors = {int(k): self._microbatch_vectors(batch, k, est1, flops1,
                                                    None)
                   for k in ks}
        req = SolveRequest(key=key, bucket=self.bucket_key(batch),
                           vectors=vectors,
                           budget_bytes=self.budget_bytes,
                           fixed_bytes=self.resolve_fixed_bytes(),
                           candidate_ks=tuple(ks),
                           pcie_bytes_per_s=self.link_bytes_per_s(),
                           offload_overlap=self.offload_overlap,
                           accum_overhead_s=self.accum_overhead_s(),
                           baseline=plan)
        if bs.submit(req):
            # one submission per cached plan object; the daemon re-marks
            # it when the solve completes
            plan.solver_checked = True
