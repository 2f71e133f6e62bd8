"""Deterministic synthetic open-loop serve traces (request arrivals).

A numpy copy of the reference's ``data/trace.py``: one seed gives the
same requests, prompts and arrival times in both packages.  An open-loop
trace fixes every request's arrival time up front, so admission pressure
is real: when the engine falls behind, the queue grows.  Prompt lengths
come from the training pipeline's length distributions
(``data/pipeline.DISTRIBUTIONS``: the cache footprint of a request
follows its length, as the activation bytes of a batch do), gaps between
arrivals are exponential (Poisson arrivals), and ``tools/gen_trace.py``
writes such a trace as JSON.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.data.pipeline import DISTRIBUTIONS


@dataclasses.dataclass
class TraceRequest:
    """One serve request of an open-loop trace."""
    rid: int
    arrival_s: float
    prompt: np.ndarray           # (S,) int32 token ids, no padding
    max_new_tokens: int

    def to_json(self) -> dict:
        return {"rid": self.rid, "arrival_s": round(self.arrival_s, 6),
                "prompt": [int(t) for t in self.prompt],
                "max_new_tokens": int(self.max_new_tokens)}

    @classmethod
    def from_json(cls, rec: dict) -> "TraceRequest":
        return cls(rid=int(rec["rid"]), arrival_s=float(rec["arrival_s"]),
                   prompt=np.asarray(rec["prompt"], np.int32),
                   max_new_tokens=int(rec["max_new_tokens"]))


def gen_trace(*, num_requests: int, vocab_size: int,
              dataset: str = "swag", rate_rps: float = 8.0,
              max_new_tokens: int = 32, min_new_tokens: int = 0,
              prompt_scale: float = 1.0, seed: int = 0,
              ) -> List[TraceRequest]:
    """Deterministic open-loop trace.

    * prompt lengths ~ ``DISTRIBUTIONS[dataset]`` times ``prompt_scale``,
      at least 1 token;
    * arrivals: exponential gaps at ``rate_rps`` requests/s (``rate_rps
      <= 0``: everything arrives at t = 0, a burst);
    * decode lengths: uniform in [min_new, max_new] when
      ``min_new_tokens`` is set, else exactly ``max_new_tokens``;
    * tokens: uniform ids in [1, vocab) from the same generator.
    """
    dist = DISTRIBUTIONS[dataset]
    rng = np.random.default_rng(seed)
    lens = dist.sample(rng, num_requests)
    lens = np.maximum((lens * float(prompt_scale)).astype(np.int64), 1)
    if rate_rps > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, num_requests))
    else:
        arrivals = np.zeros(num_requests)
    out: List[TraceRequest] = []
    for i in range(num_requests):
        new = (int(rng.integers(min_new_tokens, max_new_tokens + 1))
               if min_new_tokens else int(max_new_tokens))
        prompt = rng.integers(1, vocab_size, int(lens[i]),
                              dtype=np.int64).astype(np.int32)
        out.append(TraceRequest(rid=i, arrival_s=float(arrivals[i]),
                                prompt=prompt, max_new_tokens=max(new, 1)))
    return out
