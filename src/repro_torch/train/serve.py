"""Batched serving: chunked prefill and token-by-token decode over the
LM's KV / SSM caches.

Counterpart of the reference's ``train/serve.py``.  The reference jits
one serve step per LM and caches it on the model so every geometry
compiles once; eager PyTorch compiles nothing, so ``cached_serve_step``
is the LM's ``decode_step``; ``make_serve_step`` keeps the reference's
functional form, the parameters an argument.  The continuous-batching
engine on top of this is ``train/engine.py``.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch.models.lm import LM


class _DecodeStep(nn.Module):
    """``lm.decode_step`` as a module's forward, so ``functional_call``
    can run it on other parameters."""

    def __init__(self, lm: LM):
        super().__init__()
        self.lm = lm

    def forward(self, tokens, cache, index):
        return self.lm.decode_step(tokens, cache, index)


def make_serve_step(lm: LM):
    """The uncached decode step: (params, tokens (B, C), cache, index)
    -> (logits, cache), ``params`` a ``{name: tensor}`` mapping of the
    LM's parameters (``dict(lm.named_parameters())``) swapped in for
    the call."""
    module = _DecodeStep(lm)

    def serve_step(params: Mapping[str, torch.Tensor], tokens, cache,
                   index):
        return torch.func.functional_call(
            module, {f"lm.{n}": t for n, t in params.items()},
            (tokens, cache, index))
    return serve_step


def cached_serve_step(lm: LM):
    """The LM's serve step: (tokens (B, C), cache, index) -> (logits,
    cache).  Eager PyTorch has no executable to cache, so this is
    ``lm.decode_step`` itself."""
    return lm.decode_step


def prefill_into_cache(lm: LM, tokens: torch.Tensor, cache, chunk: int = 32):
    """Advance the cache over the prompt ``tokens`` (B, S) a ``chunk``-token
    block at a time: the full chunk, then the remainder (``chunk=1`` is the
    token-by-token path).  Returns (the last block's logits, cache)."""
    S = tokens.shape[1]
    chunk = max(int(chunk), 1)
    step = cached_serve_step(lm)
    logits = None
    for t in range(0, S, chunk):
        logits, cache = step(tokens[:, t:t + chunk], cache, t)
    return logits, cache


def generate(lm: LM, prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0, seed: int = 0,
             prefill_chunk: int = 32, cache_len: Optional[int] = None
             ) -> torch.Tensor:
    """Greedy or sampled generation: (B, max_new_tokens) token ids.

    ``prompt`` (B, S) integer, on the model's device.  ``cache_len``:
    the cache length to allocate (default ``S + max_new_tokens``); a
    bucketed length gives the same tokens, since the decode mask never
    reads past a query's own position.  Greedy decode is the reference's
    argmax.  Sampling (``temperature > 0``) draws from a
    ``torch.Generator`` seeded with ``seed``: the same stream on every
    run here, but not ``jax.random``'s, so sampled tokens differ from the
    reference's."""
    B, S = prompt.shape
    if cache_len is None:
        cache_len = S + max_new_tokens
    if cache_len < S + max_new_tokens:
        raise ValueError(f"cache_len {cache_len} < prompt {S} + "
                         f"{max_new_tokens} new tokens")
    prompt = prompt.to(lm.device)
    cache = lm.init_cache(B, cache_len)
    logits, cache = prefill_into_cache(lm, prompt, cache,
                                       chunk=prefill_chunk)
    step = cached_serve_step(lm)
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=lm.device).manual_seed(seed)
    toks = []
    for i in range(max_new_tokens):
        lg = logits[:, -1]
        if gen is not None:
            probs = torch.softmax(lg / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)
        else:
            nxt = torch.argmax(lg, dim=-1)[:, None]
        toks.append(nxt)
        logits, cache = step(nxt, cache, S + i)
    return torch.cat(toks, dim=1)
