"""Small arithmetic the metric readers share."""
from __future__ import annotations

import math
from typing import List, Sequence

_ELEM = {"torch.float32": 4, "torch.bfloat16": 2, "torch.float16": 2}


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q n)-th smallest value."""
    xs = sorted(values)
    return xs[max(math.ceil(q * len(xs)), 1) - 1]


def elem_size(dtype: str) -> int:
    return _ELEM[dtype]


def call_lengths(args: list, index: int, B: int, S: int) -> List[int]:
    """The true lengths a call got as its ``index``-th tensor argument
    (clamped to the call's S), or S for every row without one."""
    if len(args) > index and args[index][2] is not None:
        return [min(int(n), S) for n in args[index][2]]
    return [S] * B
