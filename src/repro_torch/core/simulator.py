"""Forward/backward memory-liveness timeline simulator, copied from the
reference's ``core/simulator.py``.

Given per-unit activation bytes and a plan, replay the training step's
liveness and report the peak footprint plus the plan's overheads.  It
validates scheduler plans against the budget, reproduces the paper's
Fig. 11 (peak memory against which unit is checkpointed), and drives
the DTR-style baseline, whose evict-on-OOM walk needs a memory
timeline to trigger on.

Plans may be a boolean remat mask or a typed ``Action`` tuple.  The
model per action:

* KEEP    — residuals accumulate through the forward pass and are freed
  after the unit's gradient;
* REMAT   — only the unit's boundary (output) tensor is kept; residuals
  are recomputed right before the gradient (``recompute_flops`` /
  ``recompute_time_s`` at ``PEAK_FLOPS``) and freed after;
* OFFLOAD — the offloadable residual bytes go to pinned host memory
  during the forward pass and come back before the gradient, charged
  at the host link (``offload_time_s`` = 2 x bytes / BW); ``overlap``
  is the share hidden under compute, the rest is
  ``exposed_transfer_s``;
* OFFLOAD_OPT — the unit's optimizer moments (``opt_bytes[i]``) are
  parked in host memory across steps: residual liveness as KEEP, the
  fixed footprint drops by the parked bytes, and one round trip of the
  moment bytes per step (not per microbatch) is charged.

Microbatching (``microbatch=k``): the replay covers ONE microbatch —
the byte vectors must be the per-microbatch bytes — while the per-step
totals (recomputed FLOPs, offload traffic) scale by ``k`` and ``(k - 1)
x accum_overhead_s`` is charged on the critical path.

``SimResult.step_overhead_s`` — recompute time + non-overlapped
transfer + accumulation overhead — is the scalar the schedulers and the
solver minimise at equal budget.

The roofline constants are read when a call runs, not bound as default
arguments, so a caller (or a test) that rebinds this module's
``PEAK_FLOPS`` / ``PCIE_BW`` reprices every call.

``simulate_sharded`` replays a plan on the per-device byte vectors of a
mesh (``ShardedSimResult``): under SPMD every device runs the same step
over its shard, so one per-device replay covers the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.actions import Action, as_actions
from repro_torch.launch.roofline import PCIE_BW, PEAK_FLOPS


def link_rate(pcie_bytes_per_s: Optional[float]) -> float:
    """The host link rate to price at: the given one, or ``PCIE_BW``."""
    return float(PCIE_BW if pcie_bytes_per_s is None else pcie_bytes_per_s)


@dataclasses.dataclass
class SimResult:
    peak_bytes: float
    recompute_bytes: float            # total bytes rematerialised
    recompute_units: int
    timeline: List[Tuple[str, float]]  # (event, live_bytes)
    # forward FLOPs re-executed by the plan (0.0 without a cost model)
    recompute_flops: float = 0.0
    # host-offload traffic: one-way bytes moved, units offloaded, and
    # the round-trip transfer time at the host link
    offload_bytes: float = 0.0
    offload_units: int = 0
    offload_time_s: float = 0.0
    # transfer time NOT hidden under compute ((1 - overlap) x round trip)
    exposed_transfer_s: float = 0.0
    # optimizer-state offload (OFFLOAD_OPT): moment bytes parked on the
    # host, units parked, and the per-step round-trip update traffic
    opt_offload_bytes: float = 0.0
    opt_offload_units: int = 0
    opt_transfer_s: float = 0.0
    # gradient-accumulation split of the replayed step and the fixed
    # accumulation cost it adds ((k - 1) x per-microbatch overhead)
    microbatches: int = 1
    accum_overhead_s: float = 0.0

    @property
    def recompute_time_s(self) -> float:
        """Recompute overhead at the roofline compute bound."""
        return self.recompute_flops / PEAK_FLOPS

    @property
    def step_overhead_s(self) -> float:
        """Recompute + non-overlapped transfer + accumulation cost."""
        return (self.recompute_time_s + self.exposed_transfer_s
                + self.accum_overhead_s)

    def fits(self, budget: float) -> bool:
        return self.peak_bytes <= budget


def simulate(act_bytes: Sequence[float], remat: Sequence,
             fixed_bytes: float = 0.0,
             output_bytes: Sequence[float] | None = None,
             flops: Sequence[float] | None = None, *,
             offload_bytes: Sequence[float] | None = None,
             opt_bytes: Sequence[float] | None = None,
             pcie_bytes_per_s: float | None = None,
             overlap: float = 0.5,
             microbatch: int = 1,
             accum_overhead_s: float = 0.0) -> SimResult:
    """Replay one training step's liveness under ``remat`` (a bool mask
    or an ``Action`` plan).  ``offload_bytes[i]`` is the unit's
    offloadable bytes (default all of ``act_bytes[i]``), read for
    OFFLOAD units only; ``opt_bytes[i]`` its optimizer-moment bytes
    (default zeros), read for OFFLOAD_OPT units only.  With
    ``microbatch=k > 1`` the vectors are per-microbatch; the peak covers
    one microbatch, the per-step totals scale by ``k``."""
    actions = as_actions(remat)
    n = len(act_bytes)
    act = [float(a) for a in act_bytes]
    out = ([float(o) for o in output_bytes] if output_bytes is not None
           else [0.0] * n)
    fl = ([float(f) for f in flops] if flops is not None else [0.0] * n)
    off = ([min(float(o), act[i]) for i, o in enumerate(offload_bytes)]
           if offload_bytes is not None else list(act))
    opt = ([max(float(o), 0.0) for o in opt_bytes]
           if opt_bytes is not None else [0.0] * n)
    # OFFLOAD_OPT parks moment shards on the host for the WHOLE step
    opt_moved = sum(opt[i] for i in range(n)
                    if actions[i] is Action.OFFLOAD_OPT)
    n_opt = sum(1 for a in actions if a is Action.OFFLOAD_OPT)
    live = fixed_bytes - opt_moved
    peak = live
    timeline: List[Tuple[str, float]] = []

    # ---- forward ----------------------------------------------------------
    saved = 0.0
    moved = 0.0                          # one-way bytes offloaded to host
    n_off = 0
    for i in range(n):
        # transient working set while unit i runs
        transient = live + saved + act[i] + out[i]
        peak = max(peak, transient)
        a = actions[i]
        if a is Action.REMAT:
            saved += out[i]               # only the boundary tensor is kept
        elif a is Action.OFFLOAD:
            saved += act[i] - off[i]      # non-offloadable residue stays
            moved += off[i]
            n_off += 1
        else:
            saved += act[i]
        timeline.append((f"fwd{i}", live + saved))
    peak = max(peak, live + saved)

    # ---- backward ---------------------------------------------------------
    recompute = 0.0
    recompute_fl = 0.0
    n_re = 0
    for i in reversed(range(n)):
        a = actions[i]
        if a is Action.REMAT:
            # replay forward of unit i: its residuals come back to life
            saved += act[i]
            recompute += act[i]
            recompute_fl += fl[i]
            n_re += 1
        elif a is Action.OFFLOAD:
            saved += off[i]               # fetched back from the host
        peak = max(peak, live + saved + act[i])   # grad working set ~ act_i
        saved -= act[i]
        timeline.append((f"bwd{i}", live + saved))

    # per-step totals: k sequential microbatches each recompute / offload
    # their own share — the peak stays one microbatch's
    k = max(int(microbatch), 1)
    recompute *= k
    recompute_fl *= k
    moved *= k
    pcie = link_rate(pcie_bytes_per_s)
    t_xfer = 2.0 * moved / pcie
    # optimizer-state round trip is per STEP, not per microbatch
    t_opt = 2.0 * opt_moved / pcie
    hidden = max(0.0, min(1.0, 1.0 - overlap))
    exposed = (t_xfer + t_opt) * hidden
    return SimResult(peak, recompute, n_re, timeline, recompute_fl,
                     offload_bytes=moved, offload_units=n_off,
                     offload_time_s=t_xfer, exposed_transfer_s=exposed,
                     opt_offload_bytes=opt_moved, opt_offload_units=n_opt,
                     opt_transfer_s=t_opt,
                     microbatches=k,
                     accum_overhead_s=(k - 1) * float(accum_overhead_s))


@dataclasses.dataclass
class BatchSimResult:
    """Vectorised replay of many action plans over ONE byte vector.
    Row ``j`` of every array is ``simulate(act, plans[j], ...)`` on the
    same inputs, up to float summation order.  The solver scores
    exhaustive enumerations through it."""
    peak_bytes: np.ndarray          # (m,) per-plan peak footprint
    step_overhead_s: np.ndarray     # (m,) recompute + exposed + accum
    recompute_flops: np.ndarray     # (m,) full-step recomputed FLOPs
    offload_bytes: np.ndarray       # (m,) full-step one-way host traffic
    exposed_transfer_s: np.ndarray  # (m,) non-overlapped transfer time
    microbatches: int
    accum_overhead_s: float         # (k - 1) x per-microbatch overhead
    # (m,) optimizer-moment bytes parked on the host
    opt_offload_bytes: np.ndarray = None


def simulate_many(act_bytes: Sequence[float], plans,
                  fixed_bytes: float = 0.0,
                  output_bytes: Sequence[float] | None = None,
                  flops: Sequence[float] | None = None, *,
                  offload_bytes: Sequence[float] | None = None,
                  opt_bytes: Sequence[float] | None = None,
                  pcie_bytes_per_s: float | None = None,
                  overlap: float = 0.5,
                  microbatch: int = 1,
                  accum_overhead_s: float = 0.0) -> BatchSimResult:
    """Replay ``m`` plans at once.  ``plans`` is an ``(m, n)`` array of
    action codes (0 KEEP / 1 REMAT / 2 OFFLOAD / 3 OFFLOAD_OPT).

    With ``c_j`` the forward contribution of unit j (KEEP/OFFLOAD_OPT
    ``act``, REMAT ``out``, OFFLOAD ``act - off``), ``restore_j`` its
    backward restore (0 / ``act`` / ``off`` / 0) and ``fixed' = fixed -
    sum_{j OFFLOAD_OPT} opt_j``:

    * forward transient at i:  ``fixed' + sum_{j<i} c_j + act_i + out_i``
    * end of forward:          ``fixed' + sum_j c_j``
    * backward at i:  ``fixed' + sum_j c_j + sum_{j>i}(restore_j - act_j)
      + restore_i + act_i``
    """
    A = np.asarray(plans, dtype=np.int64)
    if A.ndim != 2:
        raise ValueError(f"plans must be (m, n), got shape {A.shape}")
    m, n = A.shape
    act = np.asarray(act_bytes, dtype=np.float64)
    assert act.size == n, (act.size, n)
    out = (np.asarray(output_bytes, dtype=np.float64)
           if output_bytes is not None else np.zeros(n))
    fl = (np.asarray(flops, dtype=np.float64)
          if flops is not None else np.zeros(n))
    off = (np.minimum(np.asarray(offload_bytes, dtype=np.float64), act)
           if offload_bytes is not None else act.copy())
    opt = (np.maximum(np.asarray(opt_bytes, dtype=np.float64), 0.0)
           if opt_bytes is not None else np.zeros(n))
    fixed = float(fixed_bytes)

    re_mask = A == 1
    off_mask = A == 2
    opt_mask = A == 3
    c = np.where(re_mask, out, np.where(off_mask, act - off, act))
    restore = np.where(re_mask, act, np.where(off_mask, off, 0.0))
    opt_moved = (opt_mask * opt).sum(axis=1)
    fixed_row = fixed - opt_moved

    if n:
        pre = np.cumsum(c, axis=1) - c               # exclusive prefix
        fwd_peak = (pre + act + out).max(axis=1)
        total = c.sum(axis=1)
        d = restore - act
        suf = np.cumsum(d[:, ::-1], axis=1)[:, ::-1] - d  # exclusive suffix
        bwd_peak = (total[:, None] + suf + restore + act).max(axis=1)
        peak = fixed_row + np.maximum(
            0.0, np.maximum(np.maximum(fwd_peak, total), bwd_peak))
    else:
        peak = fixed_row + np.zeros(m)

    k = max(int(microbatch), 1)
    rec_fl = (re_mask * fl).sum(axis=1) * k
    moved = (off_mask * off).sum(axis=1) * k
    pcie = link_rate(pcie_bytes_per_s)
    t_xfer = 2.0 * moved / pcie
    t_opt = 2.0 * opt_moved / pcie
    hidden = max(0.0, min(1.0, 1.0 - overlap))
    exposed = (t_xfer + t_opt) * hidden
    accum = (k - 1) * float(accum_overhead_s)
    overhead = rec_fl / PEAK_FLOPS + exposed + accum
    return BatchSimResult(peak_bytes=peak, step_overhead_s=overhead,
                          recompute_flops=rec_fl, offload_bytes=moved,
                          exposed_transfer_s=exposed, microbatches=k,
                          accum_overhead_s=accum,
                          opt_offload_bytes=opt_moved)


@dataclasses.dataclass
class ShardedSimResult:
    """Per-device replay of one plan across a mesh.

    ``global_peak_bytes`` is the mesh-wide footprint at the per-device
    peak instant (exact when sharding is homogeneous, an upper bound
    when some tensors stay replicated)."""
    per_device: SimResult
    n_devices: int

    @property
    def peak_bytes_per_device(self) -> float:
        return self.per_device.peak_bytes

    @property
    def global_peak_bytes(self) -> float:
        return self.per_device.peak_bytes * self.n_devices

    @property
    def recompute_time_s(self) -> float:
        """Per-device recompute time (every device replays its shard of
        each rematerialised unit concurrently)."""
        return self.per_device.recompute_time_s

    @property
    def offload_time_s(self) -> float:
        """Per-device round-trip offload time (each device drives its
        own host link)."""
        return self.per_device.offload_time_s

    @property
    def step_overhead_s(self) -> float:
        return self.per_device.step_overhead_s

    @property
    def microbatches(self) -> int:
        return self.per_device.microbatches

    def fits(self, budget_per_device: float) -> bool:
        return self.per_device.peak_bytes <= budget_per_device


def simulate_sharded(device_act_bytes: Sequence[float],
                     remat: Sequence,
                     fixed_device_bytes: float = 0.0,
                     n_devices: int = 1,
                     output_bytes: Sequence[float] | None = None,
                     flops: Sequence[float] | None = None, *,
                     offload_bytes: Sequence[float] | None = None,
                     opt_bytes: Sequence[float] | None = None,
                     pcie_bytes_per_s: float | None = None,
                     overlap: float = 0.5,
                     microbatch: int = 1,
                     accum_overhead_s: float = 0.0) -> ShardedSimResult:
    """Replay the step's per-device memory timeline.

    ``device_act_bytes`` is the per-unit byte vector landing on one
    device (``CollectionResult.device_activation_vector``) and
    ``fixed_device_bytes`` the resident shard bytes
    (``sharding.budget.fixed_train_bytes_per_device``).  ``flops``
    should be the per-device recompute FLOPs (global / n_devices),
    ``offload_bytes`` and ``opt_bytes`` per-device vectors; with
    ``microbatch=k`` the vectors are per-microbatch, per device."""
    base = simulate(device_act_bytes, remat, fixed_device_bytes,
                    output_bytes, flops, offload_bytes=offload_bytes,
                    opt_bytes=opt_bytes, pcie_bytes_per_s=pcie_bytes_per_s,
                    overlap=overlap, microbatch=microbatch,
                    accum_overhead_s=accum_overhead_s)
    return ShardedSimResult(base, int(n_devices))


def peak_if_checkpointing_unit(act_bytes: Sequence[float], which: int,
                               fixed_bytes: float = 0.0) -> float:
    """Paper Fig. 11: peak memory when exactly one unit is checkpointed."""
    remat = [i == which for i in range(len(act_bytes))]
    return simulate(act_bytes, remat, fixed_bytes).peak_bytes


def dtr_simulate(act_bytes: Sequence[float], budget: float,
                 fixed_bytes: float = 0.0,
                 frag_factor: float = 1.25) -> Tuple[List[bool], int]:
    """DTR-style greedy evict-on-OOM (paper §3.2).

    Walk the forward pass; whenever live memory (inflated by the
    fragmentation factor the paper measured for DTR) exceeds the budget,
    evict the largest still-saved earlier activation.  Returns the
    effective remat mask and the number of planning (evict-search)
    operations — DTR pays them every iteration, it never caches plans.
    """
    n = len(act_bytes)
    act = [float(a) for a in act_bytes]
    saved = [False] * n                    # becomes True once materialised
    evicted = [False] * n
    plan_ops = 0
    live = fixed_bytes
    for i in range(n):
        live += act[i]
        saved[i] = True
        while live * frag_factor > budget + 1e-9:
            candidates = [j for j in range(i) if saved[j] and not evicted[j]]
            plan_ops += 1 + len(candidates)   # heuristic scan over tensors
            if not candidates:
                break
            victim = max(candidates, key=lambda j: act[j])
            evicted[victim] = True
            saved[victim] = False
            live -= act[victim]
    return evicted, plan_ops
