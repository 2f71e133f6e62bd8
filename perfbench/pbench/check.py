"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's.

Three numbers, each with its own limit in the cell's file:

* ``loss_gap``: the largest relative gap between the program's loss and
  the reference's over the checked steps;
* ``grad_gap``: over every leaf, the gap between the norm of the
  program's first gradient as the optimizer took it (its first moment
  after step 1 over 1 - beta1, so the clipped gradient) and the
  reference's, over the larger of that leaf's reference norm and the
  median leaf's;
* ``update_gap``: the same for the change of each leaf over the checked
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with no gradient moves by
  round-off alone).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

EXCLUDE_BELOW = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              names) -> tuple:
    """(largest gap, its leaf) of norms over ``names``."""
    med = float(np.median([ref[n] for n in names]))
    worst, where = 0.0, None
    for n in names:
        p = prog[n]
        if not math.isfinite(p):
            return float("inf"), n
        gap = abs(p - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, where = gap, n
    return worst, where


def compare(prog: dict, ref: dict) -> Dict[str, dict]:
    """``{number: {"value", "leaf"}}`` of the program's readings against
    the reference's (both ``{"losses", "grad_norms", "update_norms"}``)."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program and the reference name other leaves")
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else float("inf")
              for p, r in zip(prog["losses"], ref["losses"])]
    names = list(ref["grad_norms"])
    grad, g_leaf = _leaf_gap(prog["grad_norms"], ref["grad_norms"], names)
    med = float(np.median([ref["grad_norms"][n] for n in names]))
    moved = [n for n in names if ref["grad_norms"][n] >= EXCLUDE_BELOW * med]
    upd, u_leaf = _leaf_gap(prog["update_norms"], ref["update_norms"], moved)
    return {"loss_gap": {"value": max(losses) if losses else float("inf")},
            "grad_gap": {"value": grad, "leaf": g_leaf},
            "update_gap": {"value": upd, "leaf": u_leaf,
                           "excluded": len(names) - len(moved)}}


def judge(numbers: Dict[str, dict], limits: Dict[str, float]) -> tuple:
    """(correct, {number: {"value", "limit"}}): each number the cell
    gives a limit within it.  A number without one is reported, not
    compared (no limit separates its sound readings from its faults);
    a cell with no limit at all is not correct."""
    out, ok = {}, bool(limits)
    for name, d in numbers.items():
        lim = limits.get(name)
        v = d["value"]
        if lim is not None:
            ok &= math.isfinite(v) and v <= lim
        out[name] = {"value": v if math.isfinite(v) else None,
                     "limit": lim}
    return ok, out
