"""Typed per-unit plan actions — the planner/executor contract.

A copy of the reference's ``Action`` enum.  ``KEEP == 0`` and
``REMAT == 1`` on purpose, so a plain bool mask converts value-exactly
(``True -> REMAT``) through ``as_actions``.  All four are executed:
OFFLOAD by ``models/lm.py`` (the unit's input checkpoint waits in host
memory), OFFLOAD_OPT by ``train/trainer.py`` (the unit's optimizer
moments are parked on the host).
"""
from __future__ import annotations

import enum
from typing import Iterable, Tuple


class Action(enum.IntEnum):
    """What to do with one plan unit's saved residuals."""
    KEEP = 0
    REMAT = 1
    OFFLOAD = 2
    OFFLOAD_OPT = 3


def as_actions(mask: Iterable) -> Tuple[Action, ...]:
    """Normalise a plan (bools, ints or ``Action`` values) to a tuple
    of ``Action``."""
    return tuple(Action(int(m)) for m in mask)
