"""The one traffic generator: training batches from a mix file
(``perfbench/traffic/<name>.json``).

The length distributions, the bucketing and the token rule are frozen
copies of ``src/repro_torch/data/pipeline.py`` at commit e8a885f
(``LengthDistribution.sample``, ``bucket_length``, ``bucket_edges``,
``make_batches``' successor tokens), so the benchmark reads the same
traffic whatever the program's pipeline becomes.

A mix fixes the *work*; the seed fixes the order and the content:

* the window runs whole cycles of ``cycle_batches`` batches whose true
  lengths are drawn once from ``layout_seed`` (the mix's own);
  ``--seed`` shuffles each cycle's batches and draws every row's tokens,
  so every seed gives the same sizes in another order;
* the warm-up runs one batch at every bucket the window uses,
  likeliest bucket first (a real job meets the common sizes first),
  with lengths from ``warmup_seed``, then one cycle of the window's
  sizes, so each of the window's buckets is planned and each of its
  sizes has met the allocator's cap (and escalated) before the window;
  its tokens come from ``--seed`` on a stream apart from the window's.
  Buckets the window never uses are not warmed.

The mix's ``quantum`` is the padding quantum, the planner's too: it
fixes the padded shapes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"

# stream ids of one --seed, so warm-up, window and weights never share
# random numbers
STREAM_WARMUP, STREAM_WINDOW, STREAM_WEIGHTS = 1, 2, 3


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one stream of ``seed`` (any integer)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` on one stream."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def bucket_length(max_len: int, quantum: int) -> int:
    q = max(int(quantum), 1)
    return ((int(max_len) + q - 1) // q) * q


def sample_lengths(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` true lengths from ``spec`` (normal, powerlaw or uniform)."""
    lo, hi, kind = int(spec["lo"]), int(spec["hi"]), spec["kind"]
    if kind == "normal":
        x = rng.normal(float(spec["mean"]), float(spec["std"]), n)
    elif kind == "powerlaw":
        u = rng.random(n)
        x = lo * (1 - u) ** (-1.0 / (float(spec["alpha"]) - 1.0))
    elif kind == "uniform":
        x = rng.uniform(lo, hi, n)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.round(x), lo, hi).astype(np.int32)


class Mix:
    def __init__(self, spec: dict):
        self.spec = spec
        self.name = spec["name"]
        self.quantum = int(spec["quantum"])
        self.batch_size = int(spec["batch_size"])
        self.lengths = spec["lengths"]
        if spec.get("tokens", "successor") != "successor":
            raise ValueError(f"unknown token rule {spec['tokens']!r}")

    @classmethod
    def load(cls, name: str, directory: Path = TRAFFIC_DIR):
        return cls(json.loads((directory / f"{name}.json").read_text()))

    # -- sizes ------------------------------------------------------------
    def buckets(self) -> List[int]:
        """Every padded length the distribution can produce."""
        lo = bucket_length(self.lengths["lo"], self.quantum)
        hi = bucket_length(self.lengths["hi"], self.quantum)
        return list(range(lo, hi + 1, self.quantum))

    def cycle(self) -> List[np.ndarray]:
        """The true lengths of one cycle's batches, fixed by the mix."""
        rng = np.random.default_rng(int(self.spec["layout_seed"]))
        return [sample_lengths(self.lengths, rng, self.batch_size)
                for _ in range(int(self.spec["cycle_batches"]))]

    def bucket_odds(self, samples: int = 4096) -> Dict[int, float]:
        """How often each bucket holds a batch's longest row."""
        rng = np.random.default_rng(int(self.spec["warmup_seed"]))
        counts = {S: 0 for S in self.buckets()}
        for _ in range(samples):
            n = int(sample_lengths(self.lengths, rng, self.batch_size).max())
            counts[bucket_length(n, self.quantum)] += 1
        return {S: c / samples for S, c in counts.items()}

    def window_buckets(self) -> List[int]:
        """The buckets of the cycle's batches, the window's shapes."""
        return sorted({bucket_length(int(lens.max()), self.quantum)
                       for lens in self.cycle()})

    def warmup_layout(self) -> List[np.ndarray]:
        """One batch of true lengths per bucket the window uses,
        likeliest bucket first: rows drawn from the distribution and
        cut to the bucket, and row 0 set inside it, so the batch's
        bucket is that bucket.  The draws run over every bucket in that
        order and the window's are kept, so a bucket's batch does not
        depend on which others the window uses."""
        odds = self.bucket_odds()
        order = sorted(odds, key=lambda S: (-odds[S], S))
        used = set(self.window_buckets())
        rng = np.random.default_rng([int(self.spec["warmup_seed"]), 1])
        lo = int(self.lengths["lo"])
        out = []
        for S in order:
            lens = np.minimum(sample_lengths(self.lengths, rng,
                                             self.batch_size), S)
            lens[0] = rng.integers(max(S - self.quantum + 1, lo), S + 1)
            if S in used:
                out.append(lens.astype(np.int32))
        return out

    # -- batches ------------------------------------------------------------
    def batch(self, lengths: np.ndarray, rng: np.random.Generator,
              vocab_size: int) -> dict:
        """``make_batches``' batch for these true lengths: successor
        tokens from a random start per row, next-token labels, weights
        zeroing the padding, padded to the bucket."""
        B = len(lengths)
        S = bucket_length(int(lengths.max()), self.quantum)
        start = rng.integers(1, vocab_size, (B, 1), dtype=np.int64)
        mult = 31 % (vocab_size - 1) or 1
        tokens = np.empty((B, S), dtype=np.int64)
        tokens[:, 0] = start[:, 0]
        for t in range(1, S):
            tokens[:, t] = (tokens[:, t - 1] * mult + 7) % (vocab_size - 1) + 1
        tokens = tokens.astype(np.int32)
        weights = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
        tokens = tokens * weights.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": tokens, "labels": labels, "weights": weights,
                "lengths": np.asarray(lengths, np.int32)}

    def warmup_batches(self, seed: int, vocab_size: int) -> List[dict]:
        """A batch per bucket of the window, then the cycle's batches
        in order."""
        rng = rng_for(seed, STREAM_WARMUP)
        return [self.batch(lens, rng, vocab_size)
                for lens in self.warmup_layout() + self.cycle()]

    def window_batches(self, seed: int, vocab_size: int
                       ) -> Iterator[List[dict]]:
        """Cycle after cycle: each a shuffled list of the cycle's
        batches with fresh tokens."""
        rng = rng_for(seed, STREAM_WINDOW)
        layout = self.cycle()
        while True:
            order = rng.permutation(len(layout))
            yield [self.batch(layout[i], rng, vocab_size) for i in order]
