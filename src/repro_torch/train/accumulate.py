"""Adaptive microbatching: gradient accumulation as a planner action,
the counterpart of the reference's ``train/accumulate.py``.

Splitting a mini-batch into ``k`` microbatches with gradient
accumulation scales the batch-linear activation terms by ~1/k while
keeping the optimizer semantics of the full mini-batch, so the planner
treats ``k`` as one more knob chosen per bucket, jointly with the
per-unit action plan (``scheduler.greedy_plan_adaptive``).  This module
executes it:

* ``split_batch`` — split (and, when ``B % k != 0``, zero-pad) a batch
  dict into ``k`` equal microbatches along the batch axis, ``lengths``
  included.  Pad rows carry token 0, weight 0 and length 0, so they add
  nothing to the loss, the gradients or the length-aware kernels' work.
* ``accumulated_grads`` — one forward+backward per microbatch in an
  eager loop (the reference scans with ``lax.scan``), accumulating the
  token-weighted loss and gradients in fp32, so the result matches the
  full-batch step: the full-batch loss is ``sum(nll * w) / sum(w)``,
  and weighting each microbatch's mean by its token count recovers it.
  Each microbatch's backward completes before the next forward, so
  activation liveness is bounded by ONE microbatch.

The cross-entropy keeps that exactness for every family.  The MoE
load-balance loss is a nonlinear statistic of the router's
probabilities, so the k-way step carries the token-weighted mean of the
per-microbatch aux, as the reference does: it balances the experts per
microbatch, not per mini-batch (an all-pad microbatch adds nothing).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def split_batch(batch: Dict[str, torch.Tensor], k: int
                ) -> Dict[str, torch.Tensor]:
    """Split a batch dict into ``k`` equal microbatches along axis 0.

    Every entry ``(B, ...)`` becomes ``(k, ceil(B/k), ...)``.  When
    ``k`` does not divide ``B`` the batch axis is zero-padded first —
    pad rows get token 0, weight 0.0 and length 0.  ``weights`` is
    materialised (ones over the original rows) when absent, because the
    loss would otherwise give the pad rows weight 1.
    """
    k = max(int(k), 1)
    B = int(batch["tokens"].shape[0])
    out = dict(batch)
    if "weights" not in out:
        out["weights"] = torch.ones(tuple(batch["tokens"].shape),
                                    dtype=torch.float32,
                                    device=batch["tokens"].device)
    Bp = -(-B // k) * k
    split = {}
    for key, v in out.items():
        a = torch.as_tensor(v)
        assert a.dim() >= 1 and a.shape[0] == B, (
            f"batch entry {key!r} has no batch axis to split: "
            f"shape {tuple(a.shape)}, batch {B}")
        if Bp != B:
            pad = a.new_zeros((Bp - B,) + tuple(a.shape[1:]))
            a = torch.cat([a, pad])
        split[key] = a.reshape((k, Bp // k) + tuple(a.shape[1:]))
    return split


def accumulated_grads(lm, batch: Dict[str, torch.Tensor], k: int,
                      actions=None) -> Tuple[torch.Tensor, dict, dict]:
    """Loss, metrics and gradients of ``lm.loss`` over ``k`` microbatches.

    Returns ``(loss, metrics, grads)`` — ``grads`` by parameter name, in
    the parameters' dtypes — matching the full-batch loss and
    gradients to fp32 allclose (families without an aux loss; with one,
    ``metrics["aux"]`` is the token-weighted mean of the microbatches'
    aux and ``metrics["ce"]`` is ``loss - aux``).  Each microbatch adds
    its unnormalised
    quantities (``loss_i * t_i`` recovers its nll sum whatever the
    loss's weight clamp, ``grads_i * t_i`` likewise) to fp32
    accumulators, with ``t_i`` the loss's token count, or 0 for an
    all-pad microbatch; the final division by ``max(sum w, 1)`` restores
    the full-batch mean.
    """
    k = max(int(k), 1)
    mbs = split_batch(batch, k)
    params = dict(lm.named_parameters())
    names = list(params)
    g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    l_acc = a_acc = w_acc = None
    for i in range(k):
        mb = {key: v[i] for key, v in mbs.items()}
        loss, metrics = lm.loss(mb, actions)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        w_raw = mb["weights"].float().sum()
        # an all-pad microbatch (w_raw == 0, tokens clamped to 1) must
        # contribute nothing
        t = torch.where(w_raw > 0, metrics["tokens"].float(),
                        torch.zeros_like(w_raw))
        for n, g in zip(names, grads):
            if g is not None:
                g_acc[n].addcmul_(g.float(), t)
        term = loss.detach().float() * t
        a_term = metrics["aux"].detach().float() * t
        l_acc = term if l_acc is None else l_acc + term
        a_acc = a_term if a_acc is None else a_acc + a_term
        w_acc = w_raw if w_acc is None else w_acc + w_raw
    denom = w_acc.clamp_min(1.0)
    grads = {n: (g_acc[n] / denom).to(params[n].dtype) for n in names}
    loss = l_acc / denom
    aux = a_acc / denom
    return loss, {"ce": loss - aux, "aux": aux, "tokens": denom}, grads
