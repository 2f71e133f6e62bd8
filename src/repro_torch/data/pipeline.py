"""Synthetic data pipeline with input-size dynamics (paper §2.1, Fig. 3).

A numpy copy of the reference's pipeline: the same length
distributions, the same bucketing and the same generator, so one seed
gives the same batches in both packages.

  * ``swag``  — lengths ~ N(88, 18) clipped to [35, 141]
  * ``squad`` — lengths ~ N(330, 60) clipped to [153, 512]
  * ``qqp``   — power-law in [30, 332]

Batches are padded up to a multiple of ``quantum`` tokens, so the
number of distinct shapes (and Mimose plan-cache entries) stays bounded.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


def bucket_length(max_len: int, quantum: int) -> int:
    """Smallest quantum multiple >= max_len (the batch's bucket seq-len)."""
    q = max(int(quantum), 1)
    return ((int(max_len) + q - 1) // q) * q


def pad_batch(batch: dict, quantum: int) -> dict:
    """Pad a ragged batch's sequence axis up to its bucket length.

    tokens/labels pad with 0 (the pad id), weights with 0.0 so the loss
    mask stays exact — the true ``lengths`` ride along untouched.  If
    ``weights`` is absent but ``lengths`` is present, exact weights are
    rebuilt from the true lengths.
    """
    q = max(int(quantum), 1)
    tokens = np.asarray(batch["tokens"])
    B, S = tokens.shape
    Sp = bucket_length(S, q)
    out = dict(batch)
    if "weights" not in out:
        if "lengths" in out:
            lens = np.asarray(out["lengths"])
            out["weights"] = (np.arange(S)[None, :]
                              < lens[:, None]).astype(np.float32)
        elif Sp != S:
            # the implicit all-ones mask over the real positions, or the
            # padding would enter the loss with weight 1
            out["weights"] = np.ones((B, S), np.float32)
    if Sp == S:
        return out
    pad = Sp - S
    for key in ("tokens", "labels", "weights"):
        if key in out:
            out[key] = np.pad(np.asarray(out[key]), ((0, 0), (0, pad)))
    return out


@dataclasses.dataclass(frozen=True)
class LengthDistribution:
    name: str
    lo: int
    hi: int
    kind: str            # "normal" | "powerlaw" | "uniform"
    mean: float = 0.0
    std: float = 1.0
    alpha: float = 2.0   # power-law exponent

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "normal":
            x = rng.normal(self.mean, self.std, n)
        elif self.kind == "powerlaw":
            u = rng.random(n)
            x = self.lo * (1 - u) ** (-1.0 / (self.alpha - 1.0))
        else:
            x = rng.uniform(self.lo, self.hi, n)
        return np.clip(np.round(x), self.lo, self.hi).astype(np.int32)


DISTRIBUTIONS: Dict[str, LengthDistribution] = {
    "swag": LengthDistribution("swag", 35, 141, "normal", mean=88, std=18),
    "squad": LengthDistribution("squad", 153, 512, "normal", mean=330, std=60),
    "qqp": LengthDistribution("qqp", 30, 332, "powerlaw", alpha=2.5),
    "fixed": LengthDistribution("fixed", 128, 128, "uniform"),
}


def top_buckets(dataset: str, *, batch_size: int, quantum: int, k: int,
                seed: int = 0, samples: int = 256) -> List[Tuple[int, float]]:
    """The ``k`` most likely bucket seq-lens with their empirical
    frequency (a copy of the reference's): ``Trainer.prewarm`` plans
    them before step 0."""
    dist = DISTRIBUTIONS[dataset]
    rng = np.random.default_rng(seed)
    counts: Dict[int, int] = {}
    for _ in range(samples):
        lens = dist.sample(rng, batch_size)
        S = bucket_length(int(lens.max()), quantum)
        counts[S] = counts.get(S, 0) + 1
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return [(S, c / samples) for S, c in ranked]


def make_batches(dataset: str, *, batch_size: int, vocab_size: int,
                 num_batches: int, quantum: int = 32,
                 seed: int = 0,
                 extra: Optional[Dict[str, Callable]] = None
                 ) -> Iterator[dict]:
    """Yield padded mini-batches with dynamic sequence lengths.

    Each batch dict has ``tokens`` (B, S), ``labels`` (B, S) (next-token),
    ``weights`` (B, S) zeroing the padding and ``lengths`` (B,) — S
    varies across batches.  ``extra`` maps more batch keys to functions
    ``fn(B, S) -> array``, called once per batch after the tokens (the
    stub frontends' ``frames`` and ``vision_embeds``).
    """
    dist = DISTRIBUTIONS[dataset]
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        lens = dist.sample(rng, batch_size)
        S = bucket_length(int(lens.max()), quantum)
        # learnable synthetic language: deterministic successor
        # (token_{t+1} = a*token_t + c mod V) from a random start
        start = rng.integers(1, vocab_size, (batch_size, 1), dtype=np.int64)
        mult = 31 % (vocab_size - 1) or 1
        tokens = np.empty((batch_size, S), dtype=np.int64)
        tokens[:, 0] = start[:, 0]
        for t in range(1, S):
            tokens[:, t] = (tokens[:, t - 1] * mult + 7) % (vocab_size - 1) + 1
        tokens = tokens.astype(np.int32)
        weights = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
        tokens = tokens * weights.astype(np.int32)          # pad id 0
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        batch = {"tokens": tokens, "labels": labels, "weights": weights,
                 "lengths": lens}
        if extra:
            batch.update({k: fn(batch_size, S) for k, fn in extra.items()})
        yield batch
