"""AdamW with a cosine schedule and global-norm clipping, written out
to match the reference's ``optim/adamw.py`` (not ``torch.optim.AdamW``,
whose clip epsilon and decay order differ):

* grads are scaled by ``min(1, clip_norm / (gnorm + 1e-9))``;
* fp32 moments with bias correction;
* decoupled decay added inside the update ``u`` on every leaf;
* the learning rate is taken at the incremented step.

The update writes parameters and moments in place (one copy of each
instead of the reference's functional new trees), one parameter at a
time and each all or nothing: everything that allocates (the fp32
gradient, the new m and v, u, the new parameter) is computed before the
first write, and the writes are ``copy_`` calls, which allocate nothing.
So an out-of-memory error leaves every parameter either updated or
untouched, and ``apply`` resumes at the first one not written
(``UpdateCursor.done``) with the same clip scale, step and learning
rate: the resumed update equals, bit for bit, one that did not fail.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass
class UpdateCursor:
    """One update's fixed inputs, taken before any write, and how many
    parameters (in the params dict's order) it has written."""
    step: int
    scale: Optional[torch.Tensor]       # the clip scale (None: no clip)
    lr: float
    bc1: float
    bc2: float
    done: int = 0


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        def zeros():
            return {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}
        return AdamWState(0, zeros(), zeros())

    def _lr(self, step: int) -> float:
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def begin(self, grads: Dict[str, torch.Tensor],
              state: AdamWState) -> UpdateCursor:
        """The step's clip scale (the global norm over every gradient),
        step and learning rate, before any parameter is written."""
        step = state.step + 1
        scale = None
        if self.clip_norm:
            gnorm = torch.sqrt(sum(g.float().square().sum()
                                   for g in grads.values()))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        return UpdateCursor(step, scale, self._lr(step),
                            1 - self.b1 ** step, 1 - self.b2 ** step)

    @torch.no_grad()
    def apply(self, cur: UpdateCursor, grads: Dict[str, torch.Tensor],
              state: AdamWState, params: Dict[str, torch.Tensor],
              moments: Optional[Callable[[str], Tuple[torch.Tensor,
                                                      torch.Tensor]]] = None
              ) -> AdamWState:
        """Update ``params`` from the ``cur.done``-th on, in place, each
        all or nothing, counting each in ``cur.done`` once written;
        ``moments(name)`` gives a parameter's (m, v) (default: the
        state's).  Returns the new state (whose moment tensors are the
        ones written in place)."""
        for name in list(params)[cur.done:]:
            p = params[name]
            m, v = (moments(name) if moments is not None
                    else (state.m[name], state.v[name]))
            g = grads[name].float()
            if cur.scale is not None:
                g = g * cur.scale
            m_new = m.mul(self.b1).add_(g, alpha=1 - self.b1)
            v_new = v.mul(self.b2).add_(g.square(), alpha=1 - self.b2)
            u = (m_new / cur.bc1) / (torch.sqrt(v_new / cur.bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            p_new = (p.float() - cur.lr * u).to(p.dtype)
            # nothing below allocates
            m.copy_(m_new)
            v.copy_(v_new)
            p.copy_(p_new)
            cur.done += 1
        return AdamWState(cur.step, state.m, state.v)

    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]) -> AdamWState:
        """Apply one step to ``params`` in place; returns the new state
        (whose moment tensors are the old ones, updated in place)."""
        return self.apply(self.begin(grads, state), grads, state, params)


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[int], float]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then cosine
    decay to 0 at ``total``."""
    def lr(step: int) -> float:
        s = float(step)
        if s < warmup:
            return base_lr * s / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * 0.5 * (1 + math.cos(math.pi * prog))
    return lr
