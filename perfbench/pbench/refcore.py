"""What every plain reference shares: products in a stated precision,
RMSNorm, rotary embeddings, AdamW with its schedule, and the loop that
follows the program's first training steps.

Plain PyTorch; imports nothing of the program.  AdamW and the schedule
follow ``src/repro_torch/optim/adamw.py`` at commit e8a885f (the
reference's algorithm: global-norm clip with epsilon 1e-9, fp32
moments with bias correction, decoupled decay inside the update, the
learning rate at the incremented step); the parameters are stored in
the configuration's dtype after every update, as the program stores
them.

``precision``:

* ``"fp32"``: every product in float32 with TF32 off (the reference);
* ``"fp8"``: every product's operands rounded to float8 with a scale per
  tensor (e4m3 for activations and weights, e5m2 for gradients) and
  accumulated in float32, forward and backward -- the control one step
  below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp32_matmuls() -> None:
    """Float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _quant(t: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one scale (amax -> fmax), back
    in float32."""
    t = t.float()
    amax = t.abs().amax().clamp_min(1e-30)
    scale = fmax / amax
    return (t * scale).to(dtype).float() / scale


class _Fp8Einsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, a, b):
        qa = _quant(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _quant(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.eq = eq
        ctx.save_for_backward(qa, qb)
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _quant(g, torch.float8_e5m2, E5M2_MAX)
        with torch.enable_grad():
            a = qa.detach().requires_grad_(True)
            b = qb.detach().requires_grad_(True)
            out = torch.einsum(ctx.eq, a, b)
            ga, gb = torch.autograd.grad(out, (a, b), qg)
        return None, ga, gb


def einsum_for(precision: str) -> Callable:
    """``ein(eq, a, b)``: a two-operand einsum in ``precision``."""
    if precision == "fp32":
        return lambda eq, a, b: torch.einsum(eq, a.float(), b.float())
    if precision == "fp8":
        return lambda eq, a, b: _Fp8Einsum.apply(eq, a, b)
    if precision == "fp64":           # the tests' finite differences
        return lambda eq, a, b: torch.einsum(eq, a.double(), b.double())
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, H, hd) at positions 0..S-1, the halves
    of the head rotated against each other."""
    S, _, hd = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def row_ce(logits: torch.Tensor, labels: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    """Sum over positions of weight x (logsumexp - the label's logit)."""
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, labels[:, None])[:, 0]
    return ((lse - lab) * weights).sum()


def cosine_lr(base: float, warmup: int, total: int, step: int) -> float:
    s = float(step)
    if s < warmup:
        return base * s / max(warmup, 1)
    prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * 0.5 * (1 + math.cos(math.pi * prog))


class AdamWRef:
    """The update of ``optim/adamw.py``: b1 0.9, b2 0.999, eps 1e-8,
    weight decay 0.01, clip 1.0, lr from ``cosine_lr``."""

    def __init__(self, opt: dict, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, clip_norm=1.0):
        self.opt = opt
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm

    def lr(self, step: int) -> float:
        o = self.opt
        return cosine_lr(float(o["lr"]), int(o["warmup_steps"]),
                         int(o["total_steps"]), step)

    @torch.no_grad()
    def update(self, step: int, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor],
               v: Dict[str, torch.Tensor], store: Dict[str, torch.dtype]
               ) -> Dict[str, torch.Tensor]:
        """One update at ``step`` (1-based) in place; returns the norm of
        each leaf's clipped gradient, as the moments took it."""
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(self.clip / (gnorm + 1e-9), max=1.0)
        lr = self.lr(step)
        bc1, bc2 = 1 - self.b1 ** step, 1 - self.b2 ** step
        norms = {}
        for n, p in params.items():
            g = grads[n] * scale
            norms[n] = g.norm()
            m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            v[n].mul_(self.b2).add_(g.square(), alpha=1 - self.b2)
            u = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + self.eps)
            u = u + self.wd * p
            p.copy_((p - lr * u).to(store[n]).float())
        return {n: float(t) for n, t in norms.items()}


def follow_steps(ref_module, model: dict, init_params: Callable,
                 batches: List[dict], opt: dict, precision: str,
                 device, half_batch: bool = False) -> dict:
    """The reference's first ``len(batches)`` steps from the initial
    parameters ``init_params()`` ({name: tensor in its stored dtype}).

    Each step's loss is the weighted mean of the rows' cross entropy
    over the step's true tokens, and its gradient is accumulated row by
    row at each row's true length (blocks of one row, so it fits).
    ``half_batch`` leaves out the second half of every batch and takes
    the mean over the rest (a fault the check must catch).  Returns
    ``{"losses", "grad_norms" (step 1's clipped gradient per leaf),
    "update_norms" (the change of each leaf after the last step),
    "ref_grad_norms"}``."""
    ein = einsum_for(precision)
    p0 = init_params()
    store = {n: t.dtype for n, t in p0.items()}
    params = {n: t.float().requires_grad_(True) for n, t in p0.items()}
    del p0
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    adam = AdamWRef(opt)
    losses, grad_norms = [], None
    for step, batch in enumerate(batches, start=1):
        lengths = [int(n) for n in batch["lengths"]]
        rows = range(len(lengths) // 2 if half_batch else len(lengths))
        total_w = max(float(sum(float(np.sum(batch["weights"][r]))
                                for r in rows)), 1.0)
        loss = 0.0
        for r in rows:
            L = lengths[r]
            tok = torch.as_tensor(batch["tokens"][r, :L], dtype=torch.long,
                                  device=device)
            lab = torch.as_tensor(batch["labels"][r, :L], dtype=torch.long,
                                  device=device)
            w = torch.as_tensor(batch["weights"][r, :L], dtype=torch.float32,
                                device=device)
            part = ref_module.row_loss(params, model, tok, lab, w, ein) \
                / total_w
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        grads = {n: p.grad for n, p in params.items()}
        norms = adam.update(step, {n: p.data for n, p in params.items()},
                            grads, m, v, store)
        if step == 1:
            grad_norms = norms
        del grads
        for p in params.values():
            p.grad = None
    ref_grad = dict(grad_norms)
    start = init_params()
    update_norms = {n: float((params[n].detach() - start[n].float()).norm())
                    for n in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "update_norms": update_norms, "ref_grad_norms": ref_grad}
