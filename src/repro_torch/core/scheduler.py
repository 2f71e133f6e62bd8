"""Responsive memory scheduler — Algorithm 1 of the paper plus the
cost-aware selection, copied from the reference's ``core/scheduler.py``.

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
Selection depends only on ratios of FLOPs, so no device peak rate
enters it.

The hybrid remat+offload, adaptive-microbatch and sharded paths of the
reference are not part of this port yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.actions import Action, as_actions


@dataclasses.dataclass
class Plan:
    remat: List[bool]                 # bool view: True == REMAT
    excess_bytes: float               # predicted overshoot before planning
    covered_bytes: float              # bytes the plan frees
    est_activation_bytes: float       # predicted total activation bytes
    n_remat: int = 0
    # total forward FLOPs the plan re-executes in the backward pass
    recompute_flops: float = 0.0
    actions: Optional[Tuple[Action, ...]] = None

    def __post_init__(self):
        if self.actions is None:
            self.actions = tuple(Action.REMAT if r else Action.KEEP
                                 for r in self.remat)
        else:
            self.actions = as_actions(self.actions)
            self.remat = [a is Action.REMAT for a in self.actions]
        self.n_remat = sum(1 for a in self.actions if a is Action.REMAT)

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


def greedy_plan(est_mem: Sequence[float], budget_bytes: float,
                fixed_bytes: float = 0.0, tol: float = 0.10, *,
                flops: Sequence[float] | None = None,
                byte_only: bool = False) -> Plan:
    """Plan which units to rematerialise under ``budget_bytes``.

    est_mem[i] = predicted activation bytes of unit i.  With ``flops``
    (per-unit forward FLOPs) the selection is cost-aware; ``byte_only``
    (or ``flops=None``) runs the paper's Algorithm 1, with
    ``recompute_flops`` still filled in when ``flops`` is given.
    """
    if flops is not None and not byte_only:
        return _cost_aware_plan(est_mem, flops, budget_bytes, fixed_bytes,
                                tol)
    plan = _byte_greedy_plan(est_mem, budget_bytes, fixed_bytes, tol)
    return plan.with_flops(flops) if flops is not None else plan


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
