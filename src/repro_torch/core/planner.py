"""MimosePlanner — the input-aware checkpointing planner (paper §4).

Counterpart of the reference's ``core/planner.py`` (single device,
remat-only, one microbatch, no background solver).  Ties together the
shuttling collector, the lightning estimator, the responsive scheduler
and the plan cache:

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

Stats live in a plain dict under the reference's keys.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Tuple

import torch

from repro_torch.core.cache import LRUCache
from repro_torch.core.collector import ShuttlingCollector, input_size_of
from repro_torch.core.estimator import PolyEstimator
from repro_torch.core.scheduler import Plan, greedy_plan
from repro_torch.data.pipeline import bucket_length
from repro_torch.launch.roofline import plan_unit_flops

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

    def plan_key(self, batch) -> tuple:
        """Plan-cache key.  The reference's key also carries the mesh
        signature, microbatch ceiling and offload pricing; all are fixed
        in this port, so the bucket id alone decides."""
        return (self.bucket_key(batch),)


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
                 audit_every: int = 0):
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
        self.collector = ShuttlingCollector(lm)
        self.estimator = PolyEstimator(DEGREE, min_samples=warmup_samples)
        self.cache = LRUCache(MAX_PLANS)
        self.stats = {"cache_hits": 0, "cache_misses": 0, "collections": 0,
                      "collect_time_s": 0.0, "estimate_time_s": 0.0,
                      "schedule_time_s": 0.0, "audits": 0, "refits": 0,
                      "evictions": 0}

    def plan(self, batch):
        s = input_size_of(batch)
        qs = bucket_length(s, self.quantum)
        key = self.plan_key(batch)
        p = self.cache.get(key)
        if p is not None:
            self.stats["cache_hits"] += 1
            return p.as_actions(), PlanInfo(s, qs, True, False, p)
        self.stats["cache_misses"] += 1

        collected = False
        flops = None
        t_est = t_col = 0.0
        if not self.estimator.ready:
            # sheltered execution: collect this size online; the
            # collection carries the recompute-cost vector too
            res = self.collector.collect(batch)
            self.estimator.add_sample(s, res.activation_vector())
            est = res.activation_vector()
            if self.cost_aware:
                flops = res.flops_vector()
            collected = True
            t_col = res.collect_time_s
            self.stats["collections"] += 1
            self.stats["collect_time_s"] += t_col
        else:
            t0 = time.perf_counter()
            est = self.estimator.predict(s)
            t_est = time.perf_counter() - t0
            self.stats["estimate_time_s"] += t_est
            if (self.audit_every
                    and self.stats["cache_misses"] % self.audit_every == 0):
                # drift audit: exact re-collection for this size
                self.stats["audits"] += 1
                truth = self.collector.collect(batch).activation_vector()
                err = abs(truth.sum() - est.sum()) / max(truth.sum(), 1.0)
                if err > AUDIT_TOL:
                    self.estimator.add_sample(s, truth)
                    self.estimator.fit()
                    est = truth
                    self.stats["refits"] += 1
                    self.cache.clear()          # stale plans out

        t0 = time.perf_counter()
        if self.cost_aware and flops is None:
            flops = plan_unit_flops(self.lm, batch)
        plan = greedy_plan(est, self.budget_bytes, self.resolve_fixed_bytes(),
                           tol=BUCKET_TOL, flops=flops)
        t_sch = time.perf_counter() - t0
        self.stats["schedule_time_s"] += t_sch
        self.cache[key] = plan
        self.stats["evictions"] = self.cache.evictions
        return plan.as_actions(), PlanInfo(s, qs, False, collected, plan,
                                           t_est, t_sch, t_col)
