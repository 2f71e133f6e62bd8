"""MimosePlanner — the input-aware checkpointing planner (paper §4).

Counterpart of the reference's ``core/planner.py``.  Ties together
the shuttling collector, the lightning estimator, the responsive
scheduler and the plan cache:

    planner = MimosePlanner(lm, budget_bytes=6 << 30)
    actions, info = planner.plan(batch)
    loss, _ = lm.loss(batch, actions)

Sharding-aware mode: with ``mesh_budget=MeshBudget.from_shape(...)``
every quantity becomes per device -- the collector divides each saved
storage by its sharding divisor, the estimators fit per-device bytes,
the fixed bytes are the parameter / gradient / optimizer shards (ZeRO-1
aware), the recompute FLOPs divide by the device count, and the budget
is ``mesh_budget.hbm_per_device_bytes`` unless ``budget_bytes`` is
given.  Plan keys carry the budget's signature, so plans never cross
mesh shapes.  Without a mesh budget (or on a one-device mesh) the
vectors are the global ones, exactly.  The reference's legacy scalar
``shard_divisor`` is not ported: a mesh budget does its work.

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

Hybrid remat+offload (``offload=True``): every unit may also be
OFFLOADed — its input checkpoint parked in pinned host memory between
the forward and its recompute (``models/lm.py``) — priced at the host
link (``pcie_gbps``; ``None`` reads ``PCIE_BW`` when a plan is made)
with ``offload_overlap`` of the traffic hidden under compute.  Two more
estimators track the per-unit boundary and offloadable byte vectors
the hybrid scheduler needs.  ``opt_offload=True`` adds OFFLOAD_OPT:
a unit's fp32 AdamW moments parked on the host for the whole step
(``train/trainer.py``), priced by the moment vector the first
collection pins.

Telemetry (``repro_torch.obs``): ``stats`` is a ``StatsView`` over the
run's metrics registry under the reference's keys; ``plan`` traces its
``collect`` / ``predict`` / ``schedule`` spans and a ``refit`` instant
on the planner track, keeps the per-bucket ``plan_predicted_peak_bytes``
/ ``plan_actual_peak_bytes`` gauges (actual = the collector's exact
re-collection, not the allocator) and emits ``plan`` and ``drift``
events.

OOM recovery (``train/resilience.py``): ``record_oom`` books a device
OOM against its bucket, and ``MimosePlanner.escalate`` walks the
reference's DTR-style ladder (more remat at a shrunken budget, then
offload, then a doubled microbatch split), replacing the cached plan
under the same key (the old one is poisoned) and emitting the
``plan_poisoned`` / ``escalation`` events and the ``escalation``
instant on the planner track.  The base ``escalate`` returns False, so
the Sublinear and DTR baselines re-raise.  Every sample the estimators
are fed is logged with its batch geometry (``_sample_log``), so a
snapshot's planner state can replay it through the ``meta`` collector.
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
from repro_torch.core.scheduler import (Plan, escalate_plan, greedy_plan,
                                        greedy_plan_adaptive)
from repro_torch.core.solver import BackgroundSolver, SolveRequest
from repro_torch.data.pipeline import bucket_length
from repro_torch.launch.roofline import (MICROBATCH_OVERHEAD_S, PCIE_BW,
                                         PEAK_FLOPS, plan_unit_flops,
                                         recompute_scale)
from repro_torch.obs import StatsView, Telemetry, TRACK_PLANNER
from repro_torch.sharding.budget import (MeshBudget,
                                         fixed_train_bytes_per_device)

# the reference's defaults of MimosePlanner's keywords (the baselines
# use them as they are): estimator degree (paper §4.3), scheduler bucket
# tolerance (Algorithm 1), plan-cache bound, and the relative drift that
# triggers a refit
DEGREE = 2
BUCKET_TOL = 0.10
MAX_PLANS = 256
AUDIT_TOL = 0.02
# OOM recovery: each rung of the ladder plans against the budget shrunk
# by this factor per level (the prediction's error is unknown)
ESCALATE_SHRINK = 0.85


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
    name = "base"
    telemetry: Optional[Telemetry] = None
    quantum: int = 1          # batch geometry granularity (1 = no bucketing)
    fixed_bytes: Optional[float] = None
    # hybrid remat+offload knobs (set by _init_hybrid; off by default)
    offload: bool = False
    # optimizer-state offload: a unit's fp32 AdamW moments may be parked
    # on the host for the whole step
    opt_offload: bool = False
    _opt_vector = None        # pinned: moment bytes are input-independent
    # adaptive microbatching: the largest gradient-accumulation split the
    # planner may pick per bucket (1 = plain full-batch steps), and the
    # fixed per-extra-microbatch cost it prices the split at (None:
    # ``MICROBATCH_OVERHEAD_S``, read when a plan is made)
    max_microbatches: int = 1
    microbatch_overhead_s: Optional[float] = None
    # host-link pricing in GB/s (None: ``PCIE_BW``, read when a plan is
    # made), part of the plan key as in the reference
    pcie_gbps: Optional[float] = None
    offload_overlap: float = 0.5
    # sharding-aware planning: the per-device budget and divisors (None:
    # global bytes)
    mesh_budget: Optional[MeshBudget] = None

    def plan(self, batch) -> Tuple[tuple, PlanInfo]:
        """Returns ``(Plan.as_actions(), PlanInfo)``."""
        raise NotImplementedError

    # -- observability (repro_torch.obs) -----------------------------------
    def bind_telemetry(self, telemetry: Telemetry) -> None:
        """Re-home this planner's metrics into ``telemetry``'s registry
        (the trainer calls it, so a run has one registry)."""
        self.telemetry = telemetry
        st = getattr(self, "stats", None)
        if isinstance(st, StatsView):
            st.attach(telemetry.metrics)

    # -- OOM-watchdog hooks (train/resilience.py) --------------------------
    def record_oom(self, bucket: int) -> None:
        """Book a device OOM against ``bucket`` in ``stats``.  Sharing a
        registry with an ``OOMWatchdog``, whose ``on_oom`` bumps the
        same ``train_oom_events`` counter: call one of them per OOM."""
        st = getattr(self, "stats", None)
        if isinstance(st, StatsView):
            st.inc("oom_events", bucket=bucket)
        elif isinstance(st, dict):
            st["oom_events"] = st.get("oom_events", 0) + 1
            by = st.setdefault("oom_by_bucket", {})
            by[bucket] = by.get(bucket, 0) + 1

    def escalate(self, batch) -> bool:
        """Replace the cached plan for this batch's bucket with a more
        memory-aggressive one after an OOM.  Only a planner with an
        online estimator has the ladder; False tells the watchdog to
        re-raise."""
        return False

    # -- the shared mesh-vs-global accounting (one implementation for
    # Mimose and both baselines) ------------------------------------------
    def resolve_budget_bytes(self, budget_bytes: Optional[float]) -> float:
        """The planning budget: explicit bytes win (per device when a
        mesh budget is set), else the mesh budget's per-device HBM."""
        if budget_bytes is None:
            if self.mesh_budget is None:
                raise ValueError("pass budget_bytes or mesh_budget")
            budget_bytes = self.mesh_budget.hbm_per_device_bytes
        return float(budget_bytes)

    def collected_vector(self, res) -> np.ndarray:
        """The byte vector planning runs on: per-device under a mesh
        budget, global otherwise."""
        return (res.device_activation_vector()
                if self.mesh_budget is not None
                else res.activation_vector())

    def collected_output_vector(self, res) -> np.ndarray:
        """Boundary-tensor bytes per unit (what REMAT keeps), in the
        frame of ``collected_vector``."""
        return (res.device_output_vector()
                if self.mesh_budget is not None else res.output_vector())

    def collected_offload_vector(self, res) -> np.ndarray:
        """Offloadable residual bytes per unit, in the same frame."""
        return (res.device_offloadable_vector()
                if self.mesh_budget is not None
                else res.offloadable_vector())

    def collected_opt_vector(self, res) -> np.ndarray:
        """Optimizer-moment bytes per unit (fp32 AdamW m + v), in the
        same frame."""
        return (res.device_opt_vector()
                if self.mesh_budget is not None else res.opt_vector())

    # -- shared hybrid remat+offload state (Mimose + Sublinear) ----------
    def _init_hybrid(self, *, offload: bool, pcie_gbps: Optional[float],
                     offload_overlap: float, cost_aware: bool,
                     min_samples: int, opt_offload: bool = False,
                     degree: int = DEGREE) -> None:
        """The offload knobs and the two extra per-unit fits (boundary
        and offloadable bytes) the hybrid scheduler needs."""
        if offload and not cost_aware:
            raise ValueError("offload=True needs cost_aware=True: the "
                             "hybrid selection compares remat FLOPs "
                             "against transfer time")
        if opt_offload and not offload:
            raise ValueError("opt_offload=True needs offload=True: "
                             "moment parking rides the same host link "
                             "and link pricing as residual offload")
        self.offload = offload
        self.opt_offload = opt_offload
        self.pcie_gbps = pcie_gbps
        self.offload_overlap = offload_overlap
        self.est_output = PolyEstimator(degree, min_samples=min_samples)
        self.est_offload = PolyEstimator(degree, min_samples=min_samples)
        # not an estimator: moment bytes depend only on the parameter
        # shapes, so the first collection pins the vector exactly
        self._opt_vector = None

    def _feed_hybrid_estimators(self, s: int, res) -> None:
        self.est_output.add_sample(s, self.collected_output_vector(res))
        self.est_offload.add_sample(s, self.collected_offload_vector(res))
        if self._opt_vector is None:
            v = self.collected_opt_vector(res)
            if v is not None and len(v):
                self._opt_vector = np.asarray(v, dtype=np.float64)

    def _hybrid_vectors(self, size: int, res=None):
        """Boundary/offloadable byte vectors: exact from a collection
        when ``res`` is given, predicted otherwise; ``None`` when
        offload is off."""
        if not self.offload:
            return None
        out_v = (self.collected_output_vector(res) if res is not None
                 else self.est_output.predict(size))
        off_v = (self.collected_offload_vector(res) if res is not None
                 else self.est_offload.predict(size))
        return out_v, off_v

    def _opt_bytes_planning(self):
        """The moment-bytes vector, or ``None`` when optimizer offload
        is off, not yet pinned, or the model runs in scan mode (a
        chunk's moments are parked per layer by nothing: the reference
        stacks them in one leaf and cannot free a slice, so the action
        is not offered there either)."""
        if not self.opt_offload or self._opt_vector is None:
            return None
        cfg = getattr(getattr(self, "lm", None), "cfg", None)
        if cfg is not None and getattr(cfg, "remat_mode", "") == "scan":
            return None
        return self._opt_vector

    def _hybrid_kwargs(self, size: int, res=None) -> dict:
        """The extra ``greedy_plan`` arguments for hybrid selection;
        empty when offload is off."""
        v = self._hybrid_vectors(size, res)
        if v is None:
            return {}
        d = dict(output_bytes=v[0], offload_bytes=v[1],
                 pcie_bytes_per_s=self.link_bytes_per_s(),
                 offload_overlap=self.offload_overlap)
        ov = self._opt_bytes_planning()
        if ov is not None:
            d["opt_bytes"] = ov
        return d

    def resolve_fixed_bytes(self) -> float:
        """Resident bytes, resolved lazily from the model's parameters:
        the per-device parameter / gradient / optimizer shards under a
        mesh budget, the global bytes otherwise."""
        if self.fixed_bytes is None:
            if self.mesh_budget is not None:
                self.fixed_bytes = fixed_train_bytes_per_device(
                    self.lm, self.mesh_budget,
                    scanned=self.lm.cfg.remat_mode == "scan")
            else:
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

    def mesh_sig(self) -> tuple:
        """The mesh part of every plan key: () when planning for one
        global budget, the mesh budget's signature otherwise."""
        return (self.mesh_budget.sig()
                if self.mesh_budget is not None else ())

    def plan_key_of(self, bucket: int) -> tuple:
        """Plan-cache key: (bucket id, mesh signature, microbatch
        ceiling, link GB/s, offload overlap, the accumulation overhead).
        A plan built under one knob setting — or priced at other
        roofline constants — is never replayed under another; the
        chosen ``k`` is plan output (``Plan.microbatch``)."""
        return (int(bucket), self.mesh_sig(), self.max_microbatches,
                round(self.link_bytes_per_s() / 1e9, 6),
                round(float(self.offload_overlap), 6),
                self.accum_overhead_s())

    def plan_key(self, batch) -> tuple:
        return self.plan_key_of(self.bucket_key(batch))

    def planning_flops(self, flops):
        """The recompute-cost vector the simulator and scheduler divide
        by ``PEAK_FLOPS``, in the frame of the byte vectors: per device
        under a mesh budget (SPMD divides every unit's recompute over
        the devices), global otherwise.  A bf16 model's recompute runs at
        the bf16 GEMM rate, so its FLOPs are scaled by
        ``recompute_scale`` (fp32: unchanged)."""
        if flops is None:
            return flops
        if self.mesh_budget is not None:
            flops = (np.asarray(flops, dtype=np.float64)
                     / self.mesh_budget.n_devices)
        scale = recompute_scale(self.lm.cfg.dtype)
        if scale == 1.0:
            return flops
        return np.asarray(flops, dtype=np.float64) * scale

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
    name = "none"

    def __init__(self, lm):
        self.lm = lm

    def plan(self, batch):
        n = self.lm.num_plan_units()
        p = Plan([False] * n, 0.0, 0.0, 0.0)
        return p.as_actions(), PlanInfo(input_size_of(batch),
                                        self.bucket_key(batch), True,
                                        False, p)


class MimosePlanner(PlannerBase):
    name = "mimose"

    def __init__(self, lm, budget_bytes: Optional[float] = None, *,
                 fixed_bytes: Optional[float] = None,
                 mesh_budget: Optional[MeshBudget] = None,
                 quantum: int = 256,
                 degree: int = DEGREE,
                 warmup_samples: int = 4,
                 bucket_tol: float = BUCKET_TOL,
                 cost_aware: bool = True,
                 max_plans: int = MAX_PLANS,
                 audit_every: int = 0,
                 audit_tol: float = AUDIT_TOL,
                 escalate_shrink: float = ESCALATE_SHRINK,
                 max_microbatches: int = 1,
                 microbatch_overhead_s: Optional[float] = None,
                 solver: str = "off",
                 solver_budget_ms: float = 50.0,
                 offload: bool = False,
                 opt_offload: bool = False,
                 pcie_gbps: Optional[float] = None,
                 offload_overlap: float = 0.5,
                 telemetry: Optional[Telemetry] = None):
        if solver not in ("off", "dp"):
            raise ValueError(f"solver must be 'off' or 'dp', got "
                             f"{solver!r}")
        self.lm = lm
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.disabled())
        self.mesh_budget = mesh_budget
        self.budget_bytes = self.resolve_budget_bytes(budget_bytes)
        self.fixed_bytes = fixed_bytes          # None: resolved lazily from params
        self.quantum = quantum
        self.warmup_samples = warmup_samples
        self.bucket_tol = bucket_tol
        # cost-aware selection (bytes freed per recompute-FLOP, floored
        # by the byte-only oracle); False = the paper's Algorithm 1
        self.cost_aware = cost_aware
        # hybrid remat+offload: a unit's residuals may also go to pinned
        # host memory, priced at the host link
        self._init_hybrid(offload=offload, pcie_gbps=pcie_gbps,
                          offload_overlap=offload_overlap,
                          cost_aware=cost_aware, min_samples=warmup_samples,
                          opt_offload=opt_offload, degree=degree)
        # every ``audit_every``-th unseen size, re-collect and re-fit if
        # the prediction drifted beyond ``audit_tol``
        self.audit_every = audit_every
        self.audit_tol = audit_tol
        # adaptive microbatching: up to this many accumulation
        # microbatches per bucket, each extra one priced at the overhead
        self.max_microbatches = max(int(max_microbatches), 1)
        self.microbatch_overhead_s = microbatch_overhead_s
        self.collector = ShuttlingCollector(lm, mesh_budget=mesh_budget)
        self.estimator = PolyEstimator(degree, min_samples=warmup_samples)
        self.cache = LRUCache(max_plans)
        # OOM recovery: the escalation level per plan key, and the budget
        # shrink per rung
        self.escalate_shrink = float(escalate_shrink)
        self._escalation: dict = {}
        # every (input size, batch geometry) the estimators were fed: a
        # snapshot carries it, and a restore under another signature
        # replays it through the meta collector
        self._sample_log: list = []
        # stats (paper Table 2), the resilience counters and the solver
        # tier's: a dict-shaped view over the metrics registry, under
        # the reference's keys and metric names
        self.stats = StatsView(
            self.telemetry.metrics,
            scalars={"cache_hits": "plan_cache_hits",
                     "cache_misses": "plan_cache_misses",
                     "collections": "planner_collections",
                     "collect_time_s": "planner_collect_time_s",
                     "estimate_time_s": "planner_estimate_time_s",
                     "schedule_time_s": "planner_schedule_time_s",
                     "audits": "planner_audits",
                     "refits": "planner_refits",
                     "evictions": "plan_cache_evictions",
                     "oom_events": "train_oom_events",
                     "escalations": "train_escalations",
                     "poisoned_plans": "plan_cache_poisoned",
                     "restored_samples": "planner_restored_samples",
                     "restored_plans": "planner_restored_plans",
                     "dropped_plans": "planner_dropped_plans",
                     "solves": "solver_solves",
                     "solver_swaps": "solver_swaps",
                     "solver_wins": "solver_wins",
                     "solver_timeouts": "solver_timeouts",
                     "offload_fallbacks": "offload_fallbacks"},
            labeled={"oom_by_bucket": ("train_oom_events", "bucket"),
                     "escalations_by_bucket": ("train_escalations",
                                               "bucket")})
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
        with self.telemetry.tracer.span("collect", TRACK_PLANNER):
            res = self.collector.collect(batch)
        self.stats["collections"] += 1
        self.stats["collect_time_s"] += res.collect_time_s
        return res

    def _feed_estimators(self, s: int, res, probe=None) -> None:
        """One collection feeds all three per-unit fits (activation,
        boundary, offloadable), so they become ready together.  The
        probe's geometry is logged so a snapshot can replay the sample
        (``train/resilience.py``)."""
        self.estimator.add_sample(s, self.collected_vector(res))
        self._feed_hybrid_estimators(s, res)
        if probe is not None:
            self._sample_log.append(
                {"size": int(s),
                 "probe": {k: [list(v.shape),
                               str(v.dtype).replace("torch.", "")]
                           for k, v in probe.items() if v.dim()}})

    def _record_drift_point(self, bucket: int, size: int, est, truth,
                            rel_err: float = 0.0,
                            refit: bool = False) -> None:
        """One point of the predicted-vs-actual peak-bytes series: the
        estimator's activation bytes against an exact re-collection
        (every sheltered collection is its own truth), as per-bucket
        gauges and a ``drift`` event."""
        fixed = (float(self.fixed_bytes) if self.fixed_bytes is not None
                 else 0.0)
        pred = fixed + float(np.sum(est))
        act = fixed + float(np.sum(truth))
        m = self.telemetry.metrics
        m.gauge("plan_predicted_peak_bytes",
                "predicted per-device peak bytes at the bucket's "
                "geometry").set(pred, bucket=bucket)
        m.gauge("plan_actual_peak_bytes",
                "collected (ground-truth) per-device peak bytes").set(
                    act, bucket=bucket)
        if self.telemetry.events_on:
            self.telemetry.events.emit(
                "drift", bucket=int(bucket), size=int(size),
                predicted_bytes=pred, actual_bytes=act,
                rel_err=float(rel_err), refit=bool(refit))

    def _microbatch_vectors(self, batch, k: int, est1, flops1, res) -> dict:
        """Per-microbatch planning vectors at split ``k`` for
        ``greedy_plan_adaptive``: estimator predictions at the
        microbatch input size once the fits are ready, a collection on
        the split geometry while sheltered (this ``plan()`` collected at
        k = 1; the extra sample feeds the fits).  ``k == 1`` reuses the
        vectors the plain path derived."""
        if k == 1:
            est, flops, size, res_k = est1, flops1, input_size_of(batch), res
        else:
            probe = self.microbatch_probe(batch, k)
            size = input_size_of(probe)
            res_k = None
            if res is None and self.estimator.ready:
                est = self.estimator.predict(size)
            else:
                res_k = self._collect(probe)
                self._feed_estimators(size, res_k, probe)
                est = self.collected_vector(res_k)
            flops = None
            if self.cost_aware:
                flops = (res_k.flops_vector() if res_k is not None
                         else plan_unit_flops(self.lm, probe))
        d = {"est_mem": est}
        if flops is not None:
            d["flops"] = self.planning_flops(flops)
            d["pad_overhead_s"] = self.pad_waste_s(batch, k, d["flops"])
        hv = self._hybrid_vectors(size, res_k)
        if hv is not None:
            d["output_bytes"], d["offload_bytes"] = hv
        ov = self._opt_bytes_planning()
        if ov is not None:
            d["opt_bytes"] = ov
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

        tel = self.telemetry
        collected = False
        audited = False
        flops = None
        res = None
        t_est = t_col = 0.0
        if not self.estimator.ready:
            # sheltered execution: collect this size online; the
            # collection carries the recompute-cost vector too
            res = self._collect(batch)
            self._feed_estimators(s, res, batch)
            est = self.collected_vector(res)
            if self.cost_aware:
                flops = res.flops_vector()
            collected = True
            t_col = res.collect_time_s
            self._record_drift_point(qs, s, est, est)
        else:
            t0 = time.perf_counter()
            with tel.tracer.span("predict", TRACK_PLANNER):
                est = self.estimator.predict(s)
            t_est = time.perf_counter() - t0
            self.stats["estimate_time_s"] += t_est
            if (self.audit_every
                    and self.stats["cache_misses"] % self.audit_every == 0):
                # drift audit: exact re-collection for this size,
                # booked under ``audits`` only, as in the reference
                self.stats["audits"] += 1
                with tel.tracer.span("collect", TRACK_PLANNER):
                    audit = self.collector.collect(batch)
                truth = self.collected_vector(audit)
                err = abs(truth.sum() - est.sum()) / max(truth.sum(), 1.0)
                refit = err > self.audit_tol
                audited = True
                self._record_drift_point(qs, s, est, truth, rel_err=err,
                                         refit=refit)
                if refit:
                    self._feed_estimators(s, audit, batch)
                    self.estimator.fit()
                    self.est_output.fit()
                    self.est_offload.fit()
                    est = truth
                    res = audit                 # exact vectors for this plan
                    self.stats["refits"] += 1
                    with self._cache_lock:
                        # stale plans out — also drops in-flight solves:
                        # their swap is identity-checked
                        self.cache.clear()
                    if tel.events_on:
                        tel.events.emit("refit", bucket=qs, size=s,
                                        rel_err=float(err))
                    tel.tracer.instant("refit", TRACK_PLANNER,
                                       args={"bucket": qs})

        t0 = time.perf_counter()
        if self.cost_aware and flops is None:
            flops = plan_unit_flops(self.lm, batch)
        ks = self.candidate_microbatches(batch)
        with tel.tracer.span("schedule", TRACK_PLANNER):
            if ks == [1]:
                plan = greedy_plan(est, self.budget_bytes,
                                   self.resolve_fixed_bytes(),
                                   tol=self.bucket_tol,
                                   flops=self.planning_flops(flops),
                                   **self._hybrid_kwargs(s, res))
            else:
                plan = greedy_plan_adaptive(
                    lambda k: self._microbatch_vectors(batch, k, est,
                                                       flops, res),
                    self.budget_bytes, self.resolve_fixed_bytes(),
                    candidate_ks=ks, tol=self.bucket_tol,
                    pcie_bytes_per_s=self.link_bytes_per_s(),
                    offload_overlap=self.offload_overlap,
                    accum_overhead_s=self.accum_overhead_s())
        t_sch = time.perf_counter() - t0
        self.stats["schedule_time_s"] += t_sch
        if not collected and not audited:
            # a responsive plan carries a prediction but no truth: keep
            # the predicted-peak gauge current for the drift table
            tel.metrics.gauge("plan_predicted_peak_bytes").set(
                float(self.fixed_bytes or 0.0) + float(np.sum(est)),
                bucket=qs)
        ev_before = self.cache.evictions
        with self._cache_lock:
            self.cache[key] = plan
        self.stats["evictions"] = self.cache.evictions
        if tel.events_on:
            tel.events.emit(
                "plan", bucket=qs, size=s, source=plan.source,
                collected=bool(collected),
                k=int(getattr(plan, "microbatch", 1) or 1),
                n_remat=int(plan.n_remat),
                n_offload=int(plan.n_offload),
                n_opt=int(plan.n_opt),
                recompute_flops=float(plan.recompute_flops),
                offload_bytes=float(plan.offload_bytes),
                schedule_time_s=t_sch)
            if self.cache.evictions > ev_before:
                tel.events.emit("plan_evicted", bucket=qs,
                                evictions=int(self.cache.evictions))
        self._maybe_submit_solve(batch, key, plan)
        return plan.as_actions(), PlanInfo(s, qs, False, collected, plan,
                                           t_est, t_sch, t_col)

    def _maybe_submit_solve(self, batch, key, plan) -> None:
        """Queue an exact background solve for this bucket.  Greedy
        already served the step — this never blocks.  Skipped while the
        estimator is warming up (sheltered plans are exact for their
        collections), for plans the solver produced or checked, and for
        OOM-escalated buckets (their plan survived a real OOM, which the
        simulator does not know of).  The planning vectors are
        materialised here, on the training thread, so the daemon stays
        numpy-only."""
        bs = self.background_solver
        if (bs is None or not self.estimator.ready
                or getattr(plan, "solver_checked", False)
                or plan.source == "dp"
                or self._escalation.get(key, 0)
                or bs.pending(key)):
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

    def escalate(self, batch) -> bool:
        """The DTR-style recovery ladder after a device OOM on this
        batch's bucket (called by the trainer's watchdog loop).

        The plan predicted the bucket fits and the device disagreed, so
        each call replaces the cached plan with a more aggressive one,
        planned against the budget shrunk by ``escalate_shrink ** level``.
        Rungs, in order:

          1. more remat — a remat-only replan at the shrunken budget;
          2. offload — upgrade the failed plan's actions (KEEP -> REMAT
             -> OFFLOAD) in density order (``escalate_plan``) until the
             liveness replay fits;
          3. a higher microbatch split — double ``k``
             (``greedy_plan_adaptive`` with that one candidate), again
             on each call until ``k`` reaches the batch size.

        The escalated plan is cached under the same key, so later steps
        of the bucket reuse it.  Returns False when the ladder is
        exhausted (the watchdog then re-raises).
        """
        key = self.plan_key(batch)
        level = self._escalation.get(key, 0) + 1
        s = input_size_of(batch)
        bucket = self.bucket_key(batch)
        B = int(batch["tokens"].shape[0])
        res = None
        if not self.estimator.ready:
            res = self._collect(batch)
            self._feed_estimators(s, res, batch)
            est = self.collected_vector(res)
        else:
            est = self.estimator.predict(s)
        flops = (res.flops_vector() if res is not None
                 else plan_unit_flops(self.lm, batch))
        fixed = self.resolve_fixed_bytes()
        budget = self.budget_bytes * (self.escalate_shrink ** level)
        with self._cache_lock:
            prev = self.cache.get(key)
        prev_k = max(int(getattr(prev, "microbatch", 1) or 1), 1)

        if level == 1 and prev_k == 1:
            # rung 1: the cost-aware replan at the shrunken budget frees
            # more bytes than the plan that ran out of memory
            plan = greedy_plan(est, budget, fixed, tol=self.bucket_tol,
                               flops=self.planning_flops(flops))
        elif level == 2 and prev_k == 1:
            # rung 2: upgrade the failed plan's actions until the
            # replayed peak fits (the hybrid fits are fed on every
            # collection, so this works with the offload knob off)
            out_v, off_v = (
                (self.collected_output_vector(res),
                 self.collected_offload_vector(res)) if res is not None
                else (self.est_output.predict(s),
                      self.est_offload.predict(s)))
            base = prev.actions if prev is not None else None
            plan = escalate_plan(base, est, self.planning_flops(flops),
                                 budget, fixed, output_bytes=out_v,
                                 offload_bytes=off_v,
                                 pcie_bytes_per_s=self.link_bytes_per_s(),
                                 offload_overlap=self.offload_overlap,
                                 opt_bytes=self._opt_bytes_planning())
        else:
            # rung 3+: gradient accumulation shrinks the per-microbatch
            # footprint itself, below the bucket's k = 1 minimum
            k_new = min(B, max(2, prev_k * 2))
            if k_new <= prev_k:
                self._escalation[key] = level
                return False
            plan = greedy_plan_adaptive(
                lambda k: self._microbatch_vectors(batch, k, est, flops,
                                                   res),
                budget, fixed, candidate_ks=[k_new], tol=self.bucket_tol,
                pcie_bytes_per_s=self.link_bytes_per_s(),
                offload_overlap=self.offload_overlap,
                accum_overhead_s=self.accum_overhead_s())

        plan.source = "escalated"
        tel = self.telemetry
        with self._cache_lock:
            if key in self.cache:
                self.stats["poisoned_plans"] += 1
                if tel.events_on:
                    tel.events.emit("plan_poisoned", bucket=bucket,
                                    level=level)
            # a new object also invalidates an in-flight solve for this
            # key (the solver's swap is identity-checked)
            self.cache[key] = plan
        self._escalation[key] = level
        self.stats.inc("escalations", bucket=bucket)
        if tel.events_on:
            tel.events.emit("escalation", bucket=bucket, level=level,
                            k=int(getattr(plan, "microbatch", 1) or 1),
                            n_remat=int(plan.n_remat),
                            n_offload=int(plan.n_offload))
        tel.tracer.instant("escalation", TRACK_PLANNER,
                           args={"bucket": bucket, "level": level})
        return True
