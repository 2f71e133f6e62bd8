"""AdamW with a cosine schedule and global-norm clipping, written out
to match the reference's ``optim/adamw.py`` (not ``torch.optim.AdamW``,
whose clip epsilon and decay order differ):

* grads are scaled by ``min(1, clip_norm / (gnorm + 1e-9))``;
* fp32 moments with bias correction;
* decoupled decay added inside the update ``u`` on every leaf;
* the learning rate is taken at the incremented step.

The update writes parameters and moments in place (one copy of each
instead of the reference's functional new trees).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Union

import torch


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


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
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]) -> AdamWState:
        """Apply one step to ``params`` in place; returns the new state
        (whose moment tensors are the old ones, updated in place)."""
        step = state.step + 1
        scale = None
        if self.clip_norm:
            gnorm = torch.sqrt(sum(g.float().square().sum()
                                   for g in grads.values()))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        bc1 = 1 - self.b1 ** step
        bc2 = 1 - self.b2 ** step
        lr = self._lr(step)
        for name, p in params.items():
            g = grads[name].float()
            if scale is not None:
                g = g * scale
            m, v = state.m[name], state.v[name]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g.square(), alpha=1 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
        return AdamWState(step, state.m, state.v)


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
