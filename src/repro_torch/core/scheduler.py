"""Responsive memory scheduler, copied from the reference's
``core/scheduler.py``: Algorithm 1 of the paper, the cost-aware
selection, the hybrid remat+offload selection, the joint (microbatch,
action) search, and ``greedy_plan_sharded`` against a per-device
budget.

Byte-only greedy (Algorithm 1) selects which units to rematerialise:

  1. Sort units by estimated activation bytes, descending.
  2. Group units whose estimate is within -10% of the bucket head into a
     bucket; sort each bucket by forward timestamp, ascending.
  3. excess = sum(est) + fixed - budget.
  4. While excess > 0: among buckets whose max member covers the excess,
     pick the one nearest the excess and take its earliest unit;
     otherwise take the earliest unit of the largest bucket.

Cost-aware selection (the default when a ``flops`` vector is supplied)
scores each unit by bytes freed per recompute-FLOP, picks high-density
units first, trims picks the coverage does not need, and falls back to
the byte-only plan when that recomputes fewer FLOPs at equal coverage.

Hybrid selection (``offload_bytes`` with ``flops``): every (unit,
action) candidate is scored by bytes freed per cost-second — remat cost
= forward FLOPs / ``PEAK_FLOPS``, offload cost = the non-overlapped
share of 2 x bytes over the host link — and the candidate plans are
replayed by the liveness simulator; the feasible plan with the lowest
simulated step overhead wins, and the remat-only plan always competes.

Adaptive microbatching (``greedy_plan_adaptive``): the search spans
``(k, action-plan)`` pairs — split the mini-batch into ``k``
gradient-accumulation microbatches, shrinking the batch-linear
activation terms by ~1/k at ``(k - 1) x accum_overhead_s`` of fixed
cost.  ``k = 1`` always competes.

The roofline constants (``PEAK_FLOPS``, ``PCIE_BW``,
``MICROBATCH_OVERHEAD_S``) are read when a call runs; a ``None`` link
rate or accumulation overhead means this module's constant.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.actions import Action, as_actions
from repro_torch.core.simulator import link_rate, simulate
from repro_torch.launch.roofline import MICROBATCH_OVERHEAD_S, PEAK_FLOPS


@dataclasses.dataclass
class Plan:
    remat: List[bool]                 # bool view: True == REMAT
    excess_bytes: float               # predicted overshoot before planning
    covered_bytes: float              # bytes the plan frees
    est_activation_bytes: float       # predicted total activation bytes
    n_remat: int = 0
    # total forward FLOPs the plan re-executes in the backward pass
    recompute_flops: float = 0.0
    # typed per-unit plan; derived from ``remat`` when not given, and
    # the source of truth when it is (``remat`` is then the bool view,
    # OFFLOAD units reading False)
    actions: Optional[Tuple[Action, ...]] = None
    # one-way bytes the plan streams to host (0.0 without OFFLOAD units)
    offload_bytes: float = 0.0
    n_offload: int = 0
    # optimizer-moment bytes OFFLOAD_OPT units park on the host
    opt_offload_bytes: float = 0.0
    n_opt: int = 0
    # gradient-accumulation split: execute the step as this many
    # sequential microbatches (1 = the plain full-batch step).  When > 1
    # the byte quantities above are PER-MICROBATCH while
    # ``recompute_flops`` / ``offload_bytes`` are full-step totals.
    microbatch: int = 1
    # which tier produced the plan: "greedy" (density heuristic) or
    # "dp" (background solver)
    source: str = "greedy"

    def __post_init__(self):
        if self.actions is None:
            self.actions = tuple(Action.REMAT if r else Action.KEEP
                                 for r in self.remat)
        else:
            self.actions = as_actions(self.actions)
            self.remat = [a is Action.REMAT for a in self.actions]
        self.n_remat = sum(1 for a in self.actions if a is Action.REMAT)
        self.n_offload = sum(1 for a in self.actions if a is Action.OFFLOAD)
        self.n_opt = sum(1 for a in self.actions
                         if a is Action.OFFLOAD_OPT)

    def as_tuple(self) -> Tuple[bool, ...]:
        """Bool view (True == REMAT)."""
        return tuple(self.remat)

    def as_actions(self) -> Tuple[Action, ...]:
        """The typed plan — what planners hand to ``LM.loss``."""
        return self.actions

    def with_flops(self, flops) -> "Plan":
        """Fill ``recompute_flops`` from a per-unit FLOPs vector."""
        f = np.asarray(flops, dtype=np.float64)
        self.recompute_flops = float(f[np.asarray(self.remat, bool)].sum())
        return self


def _bucket_bounds(desc: np.ndarray, tol: float) -> np.ndarray:
    """Bucket boundaries over a descending estimate array (one
    ``searchsorted`` jump per bucket)."""
    n = desc.size
    asc = -desc
    bounds = [0]
    i = 0
    while i < n:
        # first j with desc[j] <= head * (1 - tol): strict '>' keeps a
        # unit in the bucket
        j = int(np.searchsorted(asc, -desc[i] * (1.0 - tol), side="left"))
        j = max(j, i + 1)
        bounds.append(j)
        i = j
    return np.asarray(bounds, dtype=np.int64)


def build_buckets(est_mem: Sequence[float], tol: float = 0.10
                  ) -> List[List[int]]:
    """Bucket unit indices by similar estimated memory (paper lines 2-14)."""
    est = np.asarray(est_mem, dtype=np.float64)
    if est.size == 0:
        return []
    order = np.argsort(-est, kind="stable")
    bounds = _bucket_bounds(est[order], tol)
    return [np.sort(order[s:e]).tolist()            # timestamp ascending
            for s, e in zip(bounds[:-1], bounds[1:])]


@dataclasses.dataclass(frozen=True)
class ActionTables:
    """Per-unit quantities every action-aware tier works from, so the
    density greedy (``_hybrid_plan``), the escalation ladder
    (``escalate_plan``) and the DP solver price KEEP/REMAT/OFFLOAD
    identically.  ``off`` is pre-clipped to ``[0, est]`` as ``simulate``
    clips it."""
    est: np.ndarray        # per-unit activation bytes
    out: np.ndarray        # per-unit boundary-tensor bytes
    off: np.ndarray        # per-unit offloadable bytes, clipped to [0, est]
    fl: np.ndarray         # per-unit forward FLOPs
    t_re: np.ndarray       # per-unit recompute seconds (REMAT cost)
    t_off: np.ndarray      # per-unit exposed transfer seconds (OFFLOAD cost)
    freed_re: np.ndarray   # bytes REMAT frees: max(est - out, 0)
    freed_off: np.ndarray  # bytes OFFLOAD frees: off
    # OFFLOAD_OPT tables; ``t_opt`` is per STEP (the optimizer runs once
    # per step), so unlike ``t_off`` it never scales with the split
    opt: np.ndarray = None        # per-unit optimizer-moment bytes
    t_opt: np.ndarray = None      # per-unit exposed opt round-trip seconds
    freed_opt: np.ndarray = None  # fixed bytes OFFLOAD_OPT frees: opt


def action_tables(est_mem, output_bytes=None, offload_bytes=None,
                  flops=None, *, opt_bytes=None,
                  pcie_bytes_per_s: float | None = None,
                  offload_overlap: float = 0.5) -> ActionTables:
    """Build the shared per-unit cost/freed tables (missing vectors
    default to zeros, which disables the corresponding action)."""
    est = np.asarray(est_mem, dtype=np.float64)
    n = est.size
    out = (np.asarray(output_bytes, dtype=np.float64)
           if output_bytes is not None else np.zeros(n))
    fl = (np.asarray(flops, dtype=np.float64)
          if flops is not None else np.zeros(n))
    off = (np.clip(np.asarray(offload_bytes, dtype=np.float64), 0.0, est)
           if offload_bytes is not None else np.zeros(n))
    opt = (np.maximum(np.asarray(opt_bytes, dtype=np.float64), 0.0)
           if opt_bytes is not None else np.zeros(n))
    assert est.shape == out.shape == off.shape == fl.shape == opt.shape, \
        (est.shape, out.shape, off.shape, fl.shape, opt.shape)
    t_re = fl / PEAK_FLOPS
    pcie = link_rate(pcie_bytes_per_s)
    hidden = max(0.0, min(1.0, 1.0 - offload_overlap))
    t_off = 2.0 * off / pcie * hidden
    t_opt = 2.0 * opt / pcie * hidden
    return ActionTables(est=est, out=out, off=off, fl=fl, t_re=t_re,
                        t_off=t_off,
                        freed_re=np.maximum(est - out, 0.0),
                        freed_off=off,
                        opt=opt, t_opt=t_opt, freed_opt=opt)


def action_candidates(tables: ActionTables,
                      allow_offload: bool = True) -> List[tuple]:
    """(density, unit, action-code) triples, best density first; ties
    break to earlier timestamps, then REMAT before OFFLOAD.  The same
    enumeration orders the greedy walk, the escalation ladder and the
    solver's DP transitions."""
    cand = []
    for i in range(tables.est.size):
        if tables.freed_re[i] > 0:
            cand.append((tables.freed_re[i] / max(tables.t_re[i], 1e-12),
                         i, 1))
        if allow_offload and tables.freed_off[i] > 0:
            cand.append((tables.freed_off[i] / max(tables.t_off[i], 1e-12),
                         i, 2))
        if (allow_offload and tables.freed_opt is not None
                and tables.freed_opt[i] > 0):
            cand.append((tables.freed_opt[i] / max(tables.t_opt[i], 1e-12),
                         i, 3))
    cand.sort(key=lambda c: (-c[0], c[1], c[2]))
    return cand


def greedy_plan(est_mem: Sequence[float], budget_bytes: float,
                fixed_bytes: float = 0.0, tol: float = 0.10, *,
                flops: Sequence[float] | None = None,
                byte_only: bool = False,
                output_bytes: Sequence[float] | None = None,
                offload_bytes: Sequence[float] | None = None,
                opt_bytes: Sequence[float] | None = None,
                pcie_bytes_per_s: float | None = None,
                offload_overlap: float = 0.5) -> Plan:
    """Plan which units to rematerialise/offload under ``budget_bytes``.

    est_mem[i] = predicted activation bytes of unit i.  With ``flops``
    (per-unit forward FLOPs) the selection is cost-aware; ``byte_only``
    (or ``flops=None``) runs the paper's Algorithm 1, with
    ``recompute_flops`` still filled in when ``flops`` is given.  With
    ``offload_bytes`` (and ``output_bytes``) and ``flops`` the plan may
    also OFFLOAD units (``_hybrid_plan``); ``opt_bytes`` adds
    OFFLOAD_OPT.
    """
    if (offload_bytes is not None and flops is not None
            and not byte_only):
        return _hybrid_plan(est_mem, output_bytes, offload_bytes, flops,
                            budget_bytes, fixed_bytes, tol,
                            link_rate(pcie_bytes_per_s), offload_overlap,
                            opt_bytes=opt_bytes)
    if flops is not None and not byte_only:
        return _cost_aware_plan(est_mem, flops, budget_bytes, fixed_bytes,
                                tol)
    plan = _byte_greedy_plan(est_mem, budget_bytes, fixed_bytes, tol)
    return plan.with_flops(flops) if flops is not None else plan


def _hybrid_plan(est_mem, output_bytes, offload_bytes, flops,
                 budget_bytes: float, fixed_bytes: float, tol: float,
                 pcie: float, overlap: float, *,
                 opt_bytes=None) -> Plan:
    """Action-aware density greedy: score every (unit, action) candidate
    by bytes freed per cost-second, validate the resulting plans with
    the liveness simulator, and return the feasible plan with the
    lowest simulated step overhead (min peak when nothing fits).  REMAT
    frees ``est - out`` (the boundary tensor stays as the recompute
    checkpoint), OFFLOAD frees the offloadable bytes outright."""
    tabs = action_tables(est_mem, output_bytes, offload_bytes, flops,
                         opt_bytes=opt_bytes,
                         pcie_bytes_per_s=pcie, offload_overlap=overlap)
    est, out, off, fl = tabs.est, tabs.out, tabs.off, tabs.fl
    freed_re, freed_off = tabs.freed_re, tabs.freed_off
    opt, freed_opt = tabs.opt, tabs.freed_opt
    n = est.size
    total = float(est.sum())
    excess = total + float(fixed_bytes) - float(budget_bytes)
    if n == 0:
        return Plan([], excess, 0.0, total)
    freed_of_code = {1: freed_re, 2: freed_off, 3: freed_opt}

    def density_greedy(allow_offload: bool) -> Plan:
        actions = [Action.KEEP] * n
        freed_by = [0.0] * n
        covered = 0.0
        picks: List[int] = []
        for _, i, code in action_candidates(tabs, allow_offload):
            if covered >= excess:
                break
            if actions[i] is not Action.KEEP:
                continue
            actions[i] = Action(code)
            freed_by[i] = freed_of_code[code][i]
            covered += freed_by[i]
            picks.append(i)
        # trim: drop the worst-density picks the coverage does not need
        for i in reversed(picks):
            if covered - freed_by[i] >= excess:
                covered -= freed_by[i]
                actions[i] = Action.KEEP
                freed_by[i] = 0.0
        return _finish(tabs, actions, excess, total)

    def replay(plan: Plan):
        return simulate(est, plan.actions, fixed_bytes, out, fl,
                        offload_bytes=off, opt_bytes=opt,
                        pcie_bytes_per_s=pcie, overlap=overlap)

    # candidates: the hybrid density greedy and its replay-repaired
    # escalation, remat-only under the same accounting, and the
    # cost-aware remat plan; the feasible one with the lowest simulated
    # step overhead wins, ties preferring fewer host actions
    hyb = density_greedy(True)
    cands = [hyb,
             escalate_plan(hyb.actions, est, fl, budget_bytes, fixed_bytes,
                           output_bytes=out, offload_bytes=off,
                           opt_bytes=opt, pcie_bytes_per_s=pcie,
                           offload_overlap=overlap),
             density_greedy(False),
             _cost_aware_plan(est, fl, budget_bytes, fixed_bytes, tol)]
    sims = [replay(p) for p in cands]
    fits = [s.peak_bytes <= budget_bytes + 1e-6 for s in sims]
    if any(fits):
        best = min((i for i in range(len(cands)) if fits[i]),
                   key=lambda i: (sims[i].step_overhead_s,
                                  cands[i].n_offload + cands[i].n_opt))
    else:
        best = min(range(len(cands)), key=lambda i: sims[i].peak_bytes)
    return cands[best]


def _finish(tabs: ActionTables, actions, excess: float,
            total: float) -> Plan:
    """A plan with its freed bytes, recompute FLOPs and host bytes
    stamped from the tables."""
    arr = np.array([int(a) for a in actions], dtype=np.int64)
    covered = float(tabs.freed_re[arr == 1].sum()
                    + tabs.freed_off[arr == 2].sum()
                    + tabs.freed_opt[arr == 3].sum())
    plan = Plan([], excess, covered, total, actions=tuple(actions))
    plan.recompute_flops = float(tabs.fl[arr == 1].sum())
    plan.offload_bytes = float(tabs.off[arr == 2].sum())
    plan.opt_offload_bytes = float(tabs.opt[arr == 3].sum())
    return plan


def escalate_plan(actions, est_mem, flops, budget_bytes: float,
                  fixed_bytes: float = 0.0, *,
                  output_bytes: Sequence[float] | None = None,
                  offload_bytes: Sequence[float] | None = None,
                  opt_bytes: Sequence[float] | None = None,
                  pcie_bytes_per_s: float | None = None,
                  offload_overlap: float = 0.5) -> Plan:
    """DTR-style escalation of an existing action plan.

    Starting from ``actions`` (typed tuple, bool mask, or ``None`` for
    all-KEEP), walk every (unit, action) candidate in density order and
    upgrade one rung at a time — KEEP -> REMAT (or OFFLOAD when that is
    the denser move), REMAT -> OFFLOAD — until the liveness replay fits
    ``budget_bytes``.  Returns the (possibly still infeasible) plan with
    full byte/FLOP accounting stamped.
    """
    pcie = link_rate(pcie_bytes_per_s)
    tabs = action_tables(est_mem, output_bytes, offload_bytes, flops,
                         opt_bytes=opt_bytes, pcie_bytes_per_s=pcie,
                         offload_overlap=offload_overlap)
    n = tabs.est.size
    total = float(tabs.est.sum())
    excess = total + float(fixed_bytes) - float(budget_bytes)
    acts = (list(as_actions(actions)) if actions is not None
            else [Action.KEEP] * n)
    assert len(acts) == n, (len(acts), n)
    for _, i, code in action_candidates(tabs, allow_offload=True):
        peak = simulate(tabs.est, tuple(acts), fixed_bytes, tabs.out,
                        tabs.fl, offload_bytes=tabs.off, opt_bytes=tabs.opt,
                        pcie_bytes_per_s=pcie,
                        overlap=offload_overlap).peak_bytes
        if peak <= budget_bytes:
            break
        if code == 1 and acts[i] is Action.KEEP:
            acts[i] = Action.REMAT
        elif code == 2 and acts[i] in (Action.KEEP, Action.REMAT):
            # upgrade rung — never downgrade an OFFLOAD_OPT unit: its
            # freed fixed bytes would come back, raising the peak
            acts[i] = Action.OFFLOAD
        elif code == 3 and acts[i] is Action.KEEP:
            acts[i] = Action.OFFLOAD_OPT
    return _finish(tabs, acts, excess, total)


def _cost_aware_plan(est_mem: Sequence[float], flops: Sequence[float],
                     budget_bytes: float, fixed_bytes: float,
                     tol: float) -> Plan:
    """Bytes-per-recompute-FLOP greedy with a trim pass, floored by the
    byte-only oracle (whichever plan recomputes fewer FLOPs wins)."""
    est = np.asarray(est_mem, dtype=np.float64)
    fl = np.asarray(flops, dtype=np.float64)
    assert est.shape == fl.shape, (est.shape, fl.shape)
    n = est.size
    total = float(est.sum())
    excess = total + float(fixed_bytes) - float(budget_bytes)
    if excess <= 0 or n == 0:
        return Plan([False] * n, excess, 0.0, total)

    # 1. pick in descending density until the excess is covered (ties:
    # earlier timestamp first)
    density = est / np.maximum(fl, 1.0)
    order = np.argsort(-density, kind="stable")
    csum = np.cumsum(est[order])
    k = min(int(np.searchsorted(csum, excess, side="left")) + 1, n)
    picked = order[:k]
    covered = float(csum[k - 1])

    # 2. trim: drop the worst-density picks the coverage does not need
    keep = np.ones(k, dtype=bool)
    for j in range(k - 1, -1, -1):
        b = est[picked[j]]
        if covered - b >= excess:
            keep[j] = False
            covered -= b
    picked = picked[keep]

    plan = [False] * n
    for i in picked:
        plan[int(i)] = True
    cost = Plan(plan, excess, covered, total)
    cost.recompute_flops = float(fl[picked].sum())

    # 3. the byte-only floor: never recompute more FLOPs than Algorithm 1
    byte = _byte_greedy_plan(est, budget_bytes, fixed_bytes,
                             tol).with_flops(fl)
    if (byte.covered_bytes >= excess) == (cost.covered_bytes >= excess) \
            and byte.recompute_flops < cost.recompute_flops:
        return byte
    return cost


def _byte_greedy_plan(est_mem: Sequence[float], budget_bytes: float,
                      fixed_bytes: float = 0.0, tol: float = 0.10) -> Plan:
    """Algorithm 1 (byte-only).  est_mem[i] = predicted bytes of unit i."""
    est = np.asarray(est_mem, dtype=np.float64)
    n = est.size
    total = float(est.sum())
    excess = total + float(fixed_bytes) - float(budget_bytes)
    plan = [False] * n
    if excess <= 0 or n == 0:
        return Plan(plan, excess, 0.0, total)

    order = np.argsort(-est, kind="stable")
    desc = est[order]
    bounds = _bucket_bounds(desc, tol)
    nb = bounds.size - 1
    starts, ends = bounds[:-1], bounds[1:]
    # bucket state in flat arrays indexed by sorted position:
    #   ts_flat  — unit ids grouped by bucket, timestamp-ascending within
    #   ts_ptr   — per bucket, next timestamp pick
    #   alive    — per sorted position, unit not yet rematerialised
    #   heads    — per bucket, sorted position of its current max
    bid = np.repeat(np.arange(nb), np.diff(bounds))
    ts_flat = order[np.lexsort((order, bid))]
    ts_ptr = starts.copy()
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[order] = np.arange(n)
    alive = np.ones(n, dtype=bool)
    heads = starts.copy()
    bmax = desc[starts].copy()

    remaining = excess
    covered = 0.0
    n_alive = n
    while remaining > 0 and n_alive > 0:
        cand = bmax > remaining
        if cand.any():
            # nearest above the excess (paper line 21)
            b = int(np.argmin(np.where(cand, bmax, np.inf)))
        else:
            # largest activation as soon as possible (paper line 19)
            b = int(np.argmax(bmax))
        pick = int(ts_flat[ts_ptr[b]])
        ts_ptr[b] += 1
        plan[pick] = True
        remaining -= est[pick]
        covered += est[pick]
        n_alive -= 1
        alive[pos_of[pick]] = False
        h, e = int(heads[b]), int(ends[b])
        while h < e and not alive[h]:
            h += 1
        heads[b] = h
        bmax[b] = desc[h] if h < e else -np.inf
    return Plan(plan, excess, covered, total)


def greedy_plan_sharded(device_est_mem: Sequence[float], mesh_budget,
                        fixed_device_bytes: float = 0.0,
                        tol: float = 0.10, *,
                        flops: Sequence[float] | None = None,
                        byte_only: bool = False,
                        output_bytes: Sequence[float] | None = None,
                        offload_bytes: Sequence[float] | None = None,
                        opt_bytes: Sequence[float] | None = None,
                        pcie_bytes_per_s: float | None = None,
                        offload_overlap: float = 0.5) -> Plan:
    """``greedy_plan`` against a per-device budget.

    ``device_est_mem[i]`` is the bytes unit i lands on one device and
    ``fixed_device_bytes`` the parameter / gradient / optimizer shard
    bytes; the budget is ``mesh_budget.hbm_per_device_bytes`` (any
    object with that attribute).  Under SPMD every device runs the same
    plan over its shard, so one per-device schedule covers the mesh.
    ``flops`` may stay global (SPMD divides every unit's recompute by
    the same count, so the selection is unchanged); ``output_bytes`` and
    ``offload_bytes`` are per-device vectors."""
    return greedy_plan(device_est_mem, mesh_budget.hbm_per_device_bytes,
                       fixed_device_bytes, tol=tol, flops=flops,
                       byte_only=byte_only, output_bytes=output_bytes,
                       offload_bytes=offload_bytes, opt_bytes=opt_bytes,
                       pcie_bytes_per_s=pcie_bytes_per_s,
                       offload_overlap=offload_overlap)


def greedy_plan_adaptive(vectors_of_k, budget_bytes: float,
                         fixed_bytes: float = 0.0, *,
                         max_microbatches: int = 1,
                         candidate_ks: Optional[Sequence[int]] = None,
                         tol: float = 0.10,
                         byte_only: bool = False,
                         pcie_bytes_per_s: float | None = None,
                         offload_overlap: float = 0.5,
                         accum_overhead_s: float | None = None) -> Plan:
    """Joint (microbatch factor, action plan) selection.

    ``vectors_of_k(k)`` returns the per-microbatch planning vectors at
    split ``k`` as a dict with ``est_mem`` (required) and optional
    ``flops`` / ``output_bytes`` / ``offload_bytes`` / ``opt_bytes``,
    plus an optional ``pad_overhead_s`` scalar (time the split wastes on
    batch-axis pad rows).  For each candidate ``k`` (``candidate_ks`` or
    ``1..max_microbatches``) ``greedy_plan`` picks the actions against
    the same budget, then the liveness simulator replays them with
    ``microbatch=k``; the feasible candidate with the lowest step
    overhead + pad overhead wins, ties preferring smaller ``k``, and the
    lowest replayed peak wins when nothing fits.
    """
    pcie = link_rate(pcie_bytes_per_s)
    accum = float(MICROBATCH_OVERHEAD_S if accum_overhead_s is None
                  else accum_overhead_s)
    ks = sorted(set(int(k) for k in
                    (candidate_ks if candidate_ks is not None
                     else range(1, max(int(max_microbatches), 1) + 1))))
    assert ks and ks[0] >= 1, ks

    def plan_at(k: int):
        v = vectors_of_k(k)
        plan = greedy_plan(v["est_mem"], budget_bytes, fixed_bytes,
                           tol=tol, flops=v.get("flops"),
                           byte_only=byte_only,
                           output_bytes=v.get("output_bytes"),
                           offload_bytes=v.get("offload_bytes"),
                           opt_bytes=v.get("opt_bytes"),
                           pcie_bytes_per_s=pcie,
                           offload_overlap=offload_overlap)
        plan.microbatch = k
        sim = simulate(v["est_mem"], plan.actions, fixed_bytes,
                       v.get("output_bytes"), v.get("flops"),
                       offload_bytes=v.get("offload_bytes"),
                       opt_bytes=v.get("opt_bytes"),
                       pcie_bytes_per_s=pcie,
                       overlap=offload_overlap, microbatch=k,
                       accum_overhead_s=accum)
        # stamp full-step totals (greedy_plan filled per-microbatch)
        plan.recompute_flops = sim.recompute_flops
        plan.offload_bytes = sim.offload_bytes
        return plan, sim, float(v.get("pad_overhead_s", 0.0))

    if len(ks) == 1 and ks[0] == 1:
        # no search: the plain scheduler's plan
        return plan_at(1)[0]
    cands = [plan_at(k) for k in ks]
    fits = [s.peak_bytes <= budget_bytes + 1e-6 for _, s, _ in cands]
    if any(fits):
        best = min((i for i in range(len(cands)) if fits[i]),
                   key=lambda i: (cands[i][1].step_overhead_s
                                  + cands[i][2],
                                  cands[i][0].microbatch))
    else:
        best = min(range(len(cands)), key=lambda i: cands[i][1].peak_bytes)
    return cands[best][0]


def greedy_plan_reference(est_mem: Sequence[float], budget_bytes: float,
                          fixed_bytes: float = 0.0,
                          tol: float = 0.10) -> Plan:
    """The seed's python-list Algorithm 1 — the equivalence oracle of
    the vectorised ``_byte_greedy_plan``.  Its bucketing is its own, not
    ``build_buckets``, so a bucketing fault in the fast path shows."""
    est = [float(m) for m in est_mem]
    total = sum(est)
    excess = total + fixed_bytes - budget_bytes
    plan = [False] * len(est)
    if excess <= 0:
        return Plan(plan, excess, 0.0, total)
    order = sorted(range(len(est)), key=lambda i: -est[i])
    buckets: List[List[int]] = []
    i = 0
    while i < len(order):
        head = order[i]
        bucket = [head]
        j = i + 1
        while j < len(order) and est[order[j]] > est[head] * (1 - tol):
            bucket.append(order[j])
            j += 1
        bucket.sort()                       # timestamp ascending
        buckets.append(bucket)
        i = j
    remaining = excess
    covered = 0.0
    while remaining > 0 and any(buckets):
        # buckets whose largest member alone covers the remaining excess
        candidates = [b for b in buckets
                      if b and max(est[i] for i in b) > remaining]
        if candidates:
            bucket = min(candidates, key=lambda b: max(est[i] for i in b))
        else:
            bucket = max((b for b in buckets if b),
                         key=lambda b: max(est[i] for i in b))
        pick = bucket[0]                    # earliest timestamp in the bucket
        bucket.remove(pick)
        plan[pick] = True
        remaining -= est[pick]
        covered += est[pick]
        buckets = [b for b in buckets if b]
    return Plan(plan, excess, covered, total)
