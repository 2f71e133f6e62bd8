"""Continuous-batching serve engine with input-aware admission.

Counterpart of the reference's ``train/engine.py``, with its logic
unchanged.  Mimose predicts per-bucket activation bytes to plan
training; serving has the same input dynamics (prompt lengths vary per
request, so the KV / SSM cache footprint does), and here the prediction
drives admission:

* **Bucketed cache pools.**  A request is bucketed by its padded total
  length (prompt + decode budget, rounded up to the quantum).  The
  in-flight requests of a bucket share one pooled cache
  (``LM.init_cache(slots, bucket)``) whose batch rows are request
  slots; slot counts grow through a power-of-two tier ladder, and
  prefill chunks are powers of two.  So the device shapes come from
  O(#buckets) geometries.  Eager PyTorch compiles none of them;
  ``compile_keys`` records the distinct geometries under the
  reference's keys, so the two packages' sets can be compared.
* **Input-aware admission.**  A ``PolyEstimator`` (paper §4.3) is fitted
  on per-cache-leaf bytes against bucket length (counted on ``meta``
  tensors, where the reference uses ``jax.eval_shape``) and predicts
  the bytes of admitting each queued request: its staging row, its
  pool slot (tier growth included) and its prefill-chunk workspace.
  The engine admits when ``predicted_bytes + cost <= hbm_bytes``; else
  the request waits (deferred), and one that can never fit is rejected.
  A request is rejected only after it failed to fit on an empty card:
  idle pools are released first, and admission runs again once the
  last request in flight is done (the reference rejects at once, so it
  rejects requests that fit alone).
* **Measured workspace on CUDA.**  The reference charges a formula per
  token for a call's transient work.  On CUDA the engine measures it
  before serving (``_calibrate``): the allocator's transient bytes of
  one prefill chunk and of a decode row at the trace's largest bucket,
  and the bytes allocated beside the parameters (cuBLAS's workspace,
  the caller's tensors).  Each charge is the larger of the
  formula and the measurement, so the allocator's peak stays within
  the budget; off CUDA the ledger is the reference's.
* **Scheduler loop.**  Each iteration releases due arrivals, admits
  what fits (FIFO), advances every prefilling request by one chunk,
  then runs ``decode_steps`` batched decode steps over every active
  pool: one call decodes a token for every slot (per-row positions
  through ``decode_step``'s (B,) index; empty slots park at index ==
  bucket and write nothing).  Greedy tokens equal sequential
  ``train.serve.generate``'s.

Caches are updated in place where the reference rebinds a functional
update.  The engine clock fast-forwards over idle gaps, so nothing
sleeps; latency percentiles use the same clock.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.estimator import PolyEstimator
from repro_torch.data.pipeline import bucket_length
from repro_torch.data.trace import TraceRequest
from repro_torch.models.lm import LM
from repro_torch.obs import StatsView, Telemetry, TRACK_SERVE
from repro_torch.train.serve import cached_serve_step

# the admission estimator is fitted on this many lengths (quantum x 1,
# 3, 5, ...), at this degree: KV bytes are linear in the length, SSM
# state bytes constant
FIT_LENGTHS = 3
FIT_DEGREE = 2


def _leaves(tree):
    """The tensors of a nested list / dict tree (dict keys in sorted
    order, as ``jax.tree_util`` flattens them), or of a module's
    parameters."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for node in tree:
            yield from _leaves(node)


def tree_device_bytes(tree) -> int:
    """Total bytes of every tensor of ``tree`` (live device state)."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(tree)))


def cache_leaf_bytes(lm: LM, max_len: int) -> np.ndarray:
    """Exact per-leaf bytes of a one-slot cache at ``max_len``: what the
    admission estimator is fitted on.  Counted on ``meta`` tensors, so
    nothing allocates."""
    cache = lm.init_cache(1, int(max_len), device="meta")
    return np.array([t.numel() * t.element_size() for t in _leaves(cache)],
                    dtype=np.float64)


def _percentile(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def _transient_bytes(fn, device) -> int:
    """The CUDA allocator's peak during ``fn()`` above what was
    allocated before it: the call's transient work, its outputs
    included."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = fn()
    torch.cuda.synchronize(device)
    del out
    return torch.cuda.max_memory_allocated(device) - base


def _make_decode_core(lm: LM):
    """Greedy batched decode step: the next token of every row and the
    advanced cache.  The argmax runs on the device, so only (slots,)
    int32 crosses to the host per step, not (slots, vocab) logits."""
    def decode_core(tokens, cache, index):
        logits, cache = lm.decode_step(tokens, cache, index)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return decode_core


@dataclasses.dataclass
class _Live:
    """Engine-side state of one admitted request."""
    req: TraceRequest
    bucket: int
    arrival_s: float
    t_admit: float
    staging: Any = None            # (1, bucket) cache during prefill
    pos: int = 0                   # prompt tokens prefilled so far
    pool: Optional["BucketPool"] = None
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    t_done: float = 0.0


class BucketPool:
    """One bucket's pooled cache: batch rows are request slots."""

    def __init__(self, lm: LM, bucket: int, slots: int, cache=None):
        self.bucket = bucket
        self.slots = slots
        self.cache = lm.init_cache(slots, bucket) if cache is None \
            else cache
        # empty slots park one past the last cache row: decode writes at
        # their index are dropped, their reads masked
        self.index = np.full((slots,), bucket, np.int32)
        self.last_tok = np.zeros((slots,), np.int32)
        self.live: List[Optional[_Live]] = [None] * slots

    def n_active(self) -> int:
        """Rows actually decoding (a reserved row still prefilling has
        ``staging`` set and is skipped by the decode harvest)."""
        return sum(l is not None and l.staging is None for l in self.live)

    def free_slot(self) -> int:
        for i, l in enumerate(self.live):
            if l is None:
                return i
        return -1

    def cache_bytes(self) -> int:
        return tree_device_bytes(self.cache)


class ServeEngine:
    """Continuous-batching scheduler over bucketed cache pools.

    Parameters
    ----------
    hbm_bytes:       serve memory budget (params + caches + workspace).
    quantum:         bucket granularity of the padded total length.
    max_slots:       per-bucket slot ceiling (tier ladder 1, 2, 4, ..).
    prefill_chunk:   largest prefill chunk (power of two).
    decode_steps:    decode iterations per scheduler loop.

    The encoder-decoder family is refused (by ``LM.init_cache``).
    """

    def __init__(self, lm: LM, *, hbm_bytes: float,
                 quantum: int = 64, max_slots: int = 4,
                 prefill_chunk: int = 32, decode_steps: int = 4,
                 telemetry: Optional[Telemetry] = None):
        self.lm = lm
        self.hbm_bytes = float(hbm_bytes)
        self.quantum = max(int(quantum), 1)
        self.max_slots = max(int(max_slots), 1)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.decode_steps = max(int(decode_steps), 1)
        self.tiers = self._slot_tiers(self.max_slots)
        cfg = lm.cfg
        itemsize = torch.empty((), dtype=lm.dtype).element_size()
        self._token_ws = 4 * cfg.vocab_size + 8 * cfg.d_model * itemsize
        # the charges for a prefill chunk's token, a decode slot and the
        # bytes allocated beside the parameters: the reference's until
        # ``_calibrate`` measures them on CUDA
        self.prefill_ws = self.slot_ws = float(self._token_ws)
        self.fixed_bytes = 0
        self._chunks = [1 << i for i in
                        range(int(math.log2(self.prefill_chunk)) + 1)]

        # the paper's estimator, aimed at cache bytes: per-leaf bytes
        # against bucket length (linear for KV, constant for SSM state;
        # degree 2 covers both), fitted on a few exact samples
        self.estimator = PolyEstimator(degree=FIT_DEGREE)
        for i in range(FIT_LENGTHS):
            s = self.quantum * (1 + 2 * i)
            self.estimator.add_sample(s, cache_leaf_bytes(lm, s))
        self.estimator.fit()

        self.param_bytes = tree_device_bytes(lm)
        if self.param_bytes >= self.hbm_bytes:
            raise ValueError(
                f"serve budget {self.hbm_bytes / 1e9:.3f} GB below the "
                f"model's parameter bytes ({self.param_bytes / 1e9:.3f} GB)")

        self.pools: Dict[int, BucketPool] = {}
        self.waiting: List[_Live] = []       # admitted = removed from here
        self.prefilling: List[_Live] = []
        self.done: List[_Live] = []
        self.rejected: List[_Live] = []

        # eager PyTorch compiles nothing; ``compile_keys`` holds the
        # geometries each kind of call saw
        self._decode_fn = _make_decode_core(lm)
        self._prefill_fn = cached_serve_step(lm)
        self.compile_keys: set = set()

        self.telemetry = telemetry if telemetry is not None \
            else Telemetry.disabled()
        self.stats = StatsView(
            self.telemetry.metrics,
            scalars={
                "admitted": "serve_admitted",
                "deferrals": "serve_deferrals",
                "rejected": "serve_rejected",
                "completed": "serve_completed",
                "prefill_chunks": "serve_prefill_chunks",
                "decode_batches": "serve_decode_batches",
                "decode_tokens": "serve_decode_tokens",
                "pool_grows": "serve_pool_grows",
                "admission_checks": "serve_admission_checks",
                "peak_predicted_bytes": "serve_peak_predicted_bytes",
                "peak_actual_bytes": "serve_peak_actual_bytes",
            },
            float_keys=("peak_predicted_bytes",))
        self._t0 = time.perf_counter()
        self._clock_skip = 0.0

    # -- geometry / prediction --------------------------------------------
    @staticmethod
    def _slot_tiers(max_slots: int) -> List[int]:
        tiers, t = [], 1
        while t < max_slots:
            tiers.append(t)
            t *= 2
        tiers.append(max_slots)
        return tiers

    def bucket_of(self, req: TraceRequest) -> int:
        return bucket_length(len(req.prompt) + req.max_new_tokens,
                             self.quantum)

    def slot_bytes(self, bucket: int) -> float:
        """Predicted per-slot cache bytes at ``bucket`` (estimator)."""
        return float(self.estimator.predict_total(bucket))

    def predicted_bytes(self) -> float:
        """The admission ledger: params + every pool + every staging
        cache + in-flight workspace, all through the estimator's per-slot
        prediction (never the allocated tensors: admission decides
        before allocating)."""
        total = float(self.param_bytes + self.fixed_bytes)
        for pool in self.pools.values():
            total += pool.slots * (self.slot_bytes(pool.bucket)
                                   + self.slot_ws)
        for lv in self.prefilling:
            total += self.slot_bytes(lv.bucket)
            total += self.prefill_chunk * self.prefill_ws
        return total

    def actual_bytes(self) -> int:
        """Bytes of the device state the engine holds (tensor sizes, not
        the allocator's view)."""
        total = self.param_bytes
        for pool in self.pools.values():
            total += pool.cache_bytes()
        for lv in self.prefilling:
            if lv.staging is not None:
                total += tree_device_bytes(lv.staging)
        return total

    def _note_bytes(self) -> None:
        self.stats["peak_predicted_bytes"] = max(
            self.stats["peak_predicted_bytes"], self.predicted_bytes())
        self.stats["peak_actual_bytes"] = max(
            self.stats["peak_actual_bytes"], self.actual_bytes())

    # -- admission ---------------------------------------------------------
    def _admit_cost(self, bucket: int) -> Optional[float]:
        """Predicted extra bytes of admitting one request at ``bucket``:
        staging row + chunk workspace + pool slot (tier growth included).
        None when the bucket has no free capacity at ``max_slots``."""
        cost = self.slot_bytes(bucket) + self.prefill_chunk * self.prefill_ws
        pool = self.pools.get(bucket)
        if pool is None:
            cost += self.tiers[0] * (self.slot_bytes(bucket) + self.slot_ws)
        elif pool.free_slot() < 0:
            if pool.slots >= self.max_slots:
                return None
            new = next(t for t in self.tiers if t > pool.slots)
            cost += (new - pool.slots) * (self.slot_bytes(bucket)
                                          + self.slot_ws)
        return cost

    def _grow_pool(self, bucket: int) -> BucketPool:
        pool = self.pools.get(bucket)
        if pool is None:
            pool = BucketPool(self.lm, bucket, self.tiers[0])
            self.pools[bucket] = pool
            self.compile_keys.add(("pool", bucket, pool.slots))
            return pool
        if pool.free_slot() >= 0:
            return pool
        new_slots = next(t for t in self.tiers if t > pool.slots)
        self.compile_keys.add(("insert", bucket, pool.slots, new_slots))
        grown = BucketPool(self.lm, bucket, new_slots,
                           cache=self.lm.cache_grow(pool.cache, new_slots))
        grown.index[:pool.slots] = pool.index
        grown.last_tok[:pool.slots] = pool.last_tok
        grown.live[:pool.slots] = pool.live
        for lv in grown.live:
            if lv is not None:
                lv.pool = grown
        self.pools[bucket] = grown
        self.stats.inc("pool_grows")
        if self.telemetry.events_on:
            self.telemetry.events.emit("pool_grow", bucket=bucket,
                                       slots=new_slots)
        self.compile_keys.add(("pool", bucket, new_slots))
        return grown

    def _try_admit(self, lv: _Live, now: float) -> bool:
        tel = self.telemetry
        self.stats.inc("admission_checks")
        cost = self._admit_cost(lv.bucket)
        if cost is None or self.predicted_bytes() + cost > self.hbm_bytes:
            return False
        pool = self._grow_pool(lv.bucket)
        slot = pool.free_slot()
        if slot < 0:
            raise RuntimeError("admission grew no slot for this request")
        lv.staging = self.lm.init_cache(1, lv.bucket)
        pool.live[slot] = lv              # claim the slot up front:
        lv.pool, lv.slot = pool, slot     # parked (index == bucket)
        lv.t_admit = now                  # until prefill completes
        self.prefilling.append(lv)
        self.stats.inc("admitted")
        if tel.events_on:
            tel.events.emit("admit", rid=lv.req.rid, bucket=lv.bucket,
                            cost_bytes=float(cost),
                            predicted_bytes=self.predicted_bytes(),
                            wait_s=max(now - lv.arrival_s, 0.0))
        if tel.trace_on:
            wait = max(now - lv.arrival_s, 0.0)
            if wait > 0:
                # retroactive: the span covers the engine-clock interval
                # the request spent queued (arrival -> admission)
                tel.tracer.complete(
                    "queue_wait", time.perf_counter() - wait, wait,
                    TRACK_SERVE,
                    args={"rid": lv.req.rid, "bucket": lv.bucket})
        return True

    # -- prefill -----------------------------------------------------------
    def _next_chunk(self, remaining: int) -> int:
        """Largest power-of-two chunk <= remaining whose predicted
        workspace fits the headroom (admission charged the base chunk,
        so the smallest candidate always fits)."""
        head = self.hbm_bytes - (self.predicted_bytes()
                                 - self.prefill_chunk * self.prefill_ws)
        for c in reversed(self._chunks):
            if c <= remaining and c * self.prefill_ws <= head:
                return c
        return 1

    def _advance_prefill(self, lv: _Live, now: float) -> None:
        tel = self.telemetry
        S = len(lv.req.prompt)
        c = self._next_chunk(S - lv.pos)
        tok = torch.as_tensor(lv.req.prompt[lv.pos:lv.pos + c][None, :],
                              dtype=torch.long, device=self.lm.device)
        width = int(tok.shape[1])
        self.compile_keys.add(("prefill", lv.bucket, width))
        with tel.tracer.span(
                "prefill_chunk", TRACK_SERVE,
                args={"rid": lv.req.rid, "bucket": lv.bucket,
                      "chunk": width} if tel.trace_on else None):
            logits, lv.staging = self._prefill_fn(tok, lv.staging, lv.pos)
        lv.pos += width
        self.stats.inc("prefill_chunks")
        if lv.pos < S:
            return
        # prefill complete: the first token comes from the prompt's last
        # logits (greedy), then the slot joins the pool's decode batch
        first = int(torch.argmax(logits[0, -1]))
        pool, slot = lv.pool, lv.slot     # claimed at admission (and
        self.compile_keys.add(("insert", lv.bucket, 1, pool.slots))
        pool.cache = self.lm.cache_insert(pool.cache, lv.staging, slot)
        pool.index[slot] = S              # re-pointed by pool growth)
        pool.last_tok[slot] = first
        lv.staging = None                 # row is now decoding
        lv.tokens.append(first)
        lv.token_times.append(now)
        self.prefilling.remove(lv)
        self._finish_if_done(lv, now)

    # -- decode ------------------------------------------------------------
    def _finish_if_done(self, lv: _Live, now: float) -> None:
        if len(lv.tokens) < lv.req.max_new_tokens:
            return
        pool, slot = lv.pool, lv.slot
        self.compile_keys.add(("evict", pool.bucket, pool.slots))
        pool.cache = self.lm.cache_evict(pool.cache, slot)
        pool.index[slot] = pool.bucket          # park: writes drop
        pool.live[slot] = None
        lv.pool, lv.slot = None, -1
        lv.t_done = now
        self.done.append(lv)
        self.stats.inc("completed")
        if self.telemetry.events_on:
            self.telemetry.events.emit(
                "serve_complete", rid=lv.req.rid, bucket=pool.bucket,
                tokens=len(lv.tokens),
                latency_s=max(now - lv.arrival_s, 0.0))
        if pool.n_active() == 0 and not any(
                w.bucket == pool.bucket
                for w in self.waiting + self.prefilling):
            del self.pools[pool.bucket]         # release the memory

    def _decode_pools(self, now: float) -> None:
        dev = self.lm.device
        for pool in list(self.pools.values()):
            if pool.n_active() == 0:
                continue
            self.compile_keys.add(("decode", pool.bucket, pool.slots))
            tel = self.telemetry
            for _ in range(self.decode_steps):
                if pool.n_active() == 0:
                    break
                toks = torch.as_tensor(pool.last_tok[:, None],
                                       dtype=torch.long, device=dev)
                idx = torch.as_tensor(pool.index, dtype=torch.long,
                                      device=dev)
                with tel.tracer.span(
                        "decode_batch", TRACK_SERVE,
                        args={"bucket": pool.bucket,
                              "active": pool.n_active()}
                        if tel.trace_on else None):
                    nxt, pool.cache = self._decode_fn(toks, pool.cache, idx)
                    nxt = nxt.cpu().numpy()
                t_emit = self._now()
                self.stats.inc("decode_batches")
                for s, lv in enumerate(pool.live):
                    if lv is None or lv.staging is not None:
                        continue    # empty, or reserved + still prefilling
                    pool.index[s] += 1
                    pool.last_tok[s] = int(nxt[s])
                    lv.tokens.append(int(nxt[s]))
                    lv.token_times.append(t_emit)
                    self.stats.inc("decode_tokens")
                    self._finish_if_done(lv, t_emit)

    # -- scheduler loop ----------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0 + self._clock_skip

    def _calibrate(self, trace: Sequence[TraceRequest]) -> None:
        """On CUDA, measure the workspace charges at the trace's largest
        bucket that fits the budget: a prefill chunk's transient bytes
        per token, a decode row's, and the bytes allocated beside the
        parameters.  A decode row is the larger of one row alone and
        half of two rows: batched rows need layout copies that one row
        skips, and past two a batch of n moves n times a row's tensors.
        Each charge is the larger of the reference's formula and the
        measurement."""
        dev = self.lm.device
        fits = [b for b in map(self.bucket_of, trace)
                if self.param_bytes + self.slot_bytes(b) <= self.hbm_bytes]
        if dev.type != "cuda" or not fits:
            return
        L = max(fits)
        C = min(self.prefill_chunk, L)
        tok = torch.ones((2, C), dtype=torch.long, device=dev)

        def transient(rows, width, index):
            cache = self.lm.init_cache(rows, L)
            fn = self._prefill_fn if width > 1 else self._decode_fn
            return _transient_bytes(
                lambda: fn(tok[:rows, :width], cache, index), dev)

        prefill = transient(1, C, 0)
        rows = [transient(n, 1, torch.zeros((n,), dtype=torch.long,
                                            device=dev)) / n
                for n in (1, 2)[:self.max_slots]]
        self.prefill_ws = max(float(self._token_ws), prefill / C)
        self.slot_ws = max([float(self._token_ws)] + rows)
        self.fixed_bytes = max(
            torch.cuda.memory_allocated(dev) - self.actual_bytes(), 0)

    def run(self, trace: Sequence[TraceRequest]) -> "ServeResult":
        """Serve an open-loop trace to completion and report."""
        pending = sorted(trace, key=lambda r: (r.arrival_s, r.rid))
        on_cuda = self.lm.device.type == "cuda"
        if on_cuda:
            self._calibrate(trace)
            torch.cuda.reset_peak_memory_stats(self.lm.device)
        self._t0 = time.perf_counter()
        self._clock_skip = 0.0
        wall0 = time.perf_counter()
        while pending or self.waiting or self.prefilling or any(
                p.n_active() for p in self.pools.values()):
            now = self._now()
            while pending and pending[0].arrival_s <= now:
                req = pending.pop(0)
                self.waiting.append(_Live(req=req,
                                          bucket=self.bucket_of(req),
                                          arrival_s=req.arrival_s,
                                          t_admit=0.0))
            # whether this pass admits from an empty card (params only)
            empty = not self.pools and not self.prefilling
            # FIFO admission: defer what the prediction says won't fit
            still: List[_Live] = []
            for lv in self.waiting:
                if not self._try_admit(lv, now):
                    if lv.pool is None:
                        self.stats.inc("deferrals")
                        if self.telemetry.events_on:
                            self.telemetry.events.emit(
                                "defer", rid=lv.req.rid, bucket=lv.bucket,
                                predicted_bytes=self.predicted_bytes())
                    still.append(lv)
            self.waiting = still
            for lv in list(self.prefilling):
                self._advance_prefill(lv, self._now())
            self._decode_pools(self._now())
            self._note_bytes()
            if (not self.prefilling and not any(
                    p.n_active() for p in self.pools.values())):
                if self.waiting and self.pools:
                    # nothing in flight, so every pool is idle, kept for
                    # a waiting request of its bucket that did not fit
                    # beside the others: release them all and admit
                    # again from nothing
                    self.pools.clear()
                elif self.waiting and empty:
                    # the head did not fit on an empty card: it never
                    # will; reject instead of spinning or OOMing.  (The
                    # reference rejects as soon as nothing is in
                    # flight, before admitting again, so it rejects
                    # requests that fit alone.)
                    lv = self.waiting.pop(0)
                    self.rejected.append(lv)
                    self.stats.inc("rejected")
                    if self.telemetry.events_on:
                        self.telemetry.events.emit(
                            "reject", rid=lv.req.rid, bucket=lv.bucket,
                            predicted_bytes=self.predicted_bytes(),
                            hbm_bytes=self.hbm_bytes)
                elif not self.waiting and pending:
                    # idle until the next arrival: fast-forward
                    gap = pending[0].arrival_s - self._now()
                    if gap > 0:
                        self._clock_skip += gap
        if on_cuda:
            torch.cuda.synchronize(self.lm.device)
        wall = time.perf_counter() - wall0
        allocated = (torch.cuda.max_memory_allocated(self.lm.device)
                     if on_cuda else None)
        return ServeResult.collect(self, wall, allocated)


@dataclasses.dataclass
class ServeResult:
    """Summary of one ``ServeEngine.run``.  ``peak_allocated_bytes``: the
    CUDA caching allocator's peak over the run (params included), None
    off CUDA."""
    wall_s: float
    completed: int
    rejected: int
    total_tokens: int
    tokens_per_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    itl_p50_s: float
    itl_p99_s: float
    stats: dict
    outputs: Dict[int, List[int]]
    compile_counts: Dict[str, int]
    peak_allocated_bytes: Optional[int] = None

    @classmethod
    def collect(cls, eng: ServeEngine, wall: float,
                peak_allocated_bytes: Optional[int] = None
                ) -> "ServeResult":
        ttft, itl, total = [], [], 0
        outputs: Dict[int, List[int]] = {}
        for lv in eng.done:
            outputs[lv.req.rid] = list(lv.tokens)
            total += len(lv.tokens)
            if lv.token_times:
                ttft.append(lv.token_times[0] - lv.arrival_s)
                itl.extend(np.diff(lv.token_times).tolist())
        kinds: Dict[str, int] = {}
        for key in eng.compile_keys:
            kinds[key[0]] = kinds.get(key[0], 0) + 1
        return cls(
            wall_s=wall, completed=len(eng.done), rejected=len(eng.rejected),
            total_tokens=total,
            tokens_per_s=total / wall if wall > 0 else 0.0,
            ttft_p50_s=_percentile(ttft, 50), ttft_p99_s=_percentile(ttft, 99),
            itl_p50_s=_percentile(itl, 50), itl_p99_s=_percentile(itl, 99),
            stats=dict(eng.stats), outputs=outputs, compile_counts=kinds,
            peak_allocated_bytes=peak_allocated_bytes)

    def summary(self) -> dict:
        out = {
            "wall_s": round(self.wall_s, 4),
            "completed": self.completed,
            "rejected": self.rejected,
            "total_tokens": self.total_tokens,
            "tokens_per_s": round(self.tokens_per_s, 1),
            "ttft_p50_ms": round(self.ttft_p50_s * 1e3, 2),
            "ttft_p99_ms": round(self.ttft_p99_s * 1e3, 2),
            "itl_p50_ms": round(self.itl_p50_s * 1e3, 3),
            "itl_p99_ms": round(self.itl_p99_s * 1e3, 3),
            "admitted": self.stats["admitted"],
            "deferrals": self.stats["deferrals"],
            "pool_grows": self.stats["pool_grows"],
            "decode_batches": self.stats["decode_batches"],
            "peak_predicted_mb": round(
                self.stats["peak_predicted_bytes"] / 1e6, 3),
            "peak_actual_mb": round(
                self.stats["peak_actual_bytes"] / 1e6, 3),
            "compile_counts": dict(self.compile_counts),
        }
        if self.peak_allocated_bytes is not None:
            out["peak_allocated_mb"] = round(
                self.peak_allocated_bytes / 1e6, 3)
        return out
