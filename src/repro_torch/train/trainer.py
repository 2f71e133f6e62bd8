"""Training loop with the Mimose planner on the critical path (paper §4.1).

Counterpart of the reference's ``train/trainer.py`` (eager, single
device):

  1. Each batch is padded up to the planner's quantum (``pad_batch``);
     the true ``lengths`` ride along so attention masks (and the flash
     kernels skip) the padded tail, and padded positions carry zero
     loss weight.
  2. ``planner.plan`` maps the bucket to a KEEP/REMAT action tuple.
  3. The step runs forward + backward under that plan and an AdamW
     update in place.  A plan with ``Plan.microbatch = k > 1`` runs as
     ``k`` accumulated microbatches (``train/accumulate.py``).  Step
     functions are cached per (batch shapes, plan, k) like the
     reference's jit cache, so ``StepStats.compile`` marks the first
     step of each key — and a plan the background solver swapped in
     builds a new step function for its bucket only.

On CUDA each step records ``torch.cuda.max_memory_allocated`` next to
the plan's predicted peak (fixed bytes + predicted activations - bytes
the plan frees, per microbatch under a split) — the paper's headline
comparison.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cache import LRUCache
from repro_torch.core.planner import PlannerBase
from repro_torch.data.pipeline import pad_batch
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.accumulate import accumulated_grads

MAX_CACHED_STEPS = 64     # step-function cache bound, as the reference's

@dataclasses.dataclass
class StepStats:
    loss: float
    step_time_s: float
    plan_time_s: float
    compile: bool              # first step of its (bucket, plan) key
    remat_units: int
    tokens: int                # effective (unpadded) tokens in the step
    bucket: int = 0
    padded_tokens: int = 0     # bucket-shape tokens computed over
    cache_hit: bool = False    # plan served from the planner's cache
    collected: bool = False    # plan made from an online collection
    # fixed + predicted activation bytes - bytes the plan frees
    predicted_peak_bytes: float = 0.0
    # torch.cuda.max_memory_allocated over the step (0 off CUDA)
    max_memory_bytes: int = 0
    microbatches: int = 1      # gradient-accumulation split of the step


class Trainer:
    def __init__(self, lm, planner: PlannerBase,
                 optimizer: Optional[AdamW] = None):
        self.lm = lm
        self.planner = planner
        self.optimizer = optimizer or AdamW()
        self.params = dict(lm.named_parameters())
        self._step_cache = LRUCache(MAX_CACHED_STEPS)
        self.history: list[StepStats] = []
        self.cache_stats = {"compiles": 0, "jit_hits": 0, "evictions": 0,
                            "bucket_steps": {}}

    def _batch_key(self, batch) -> tuple:
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in batch.items() if k != "lengths"))

    def _prepare(self, batch) -> dict:
        """Bucket-pad one batch and move it to the model's device; the
        true ``lengths`` default to the full sequence."""
        batch = pad_batch(batch, self.planner.quantum)
        B, S = np.shape(batch["tokens"])
        if "lengths" not in batch:
            batch = dict(batch, lengths=np.full((B,), S, np.int32))
        dtypes = {"tokens": torch.long, "labels": torch.long,
                  "lengths": torch.int32}
        return {k: torch.as_tensor(np.asarray(v)).to(
                    device=self.lm.device,
                    dtype=dtypes.get(k, torch.float32))
                for k, v in batch.items()}

    def _build_step(self, actions, microbatch: int = 1):
        lm, opt, params = self.lm, self.optimizer, self.params

        if microbatch > 1:
            def train_step(opt_state: AdamWState, batch):
                loss, metrics, grads = accumulated_grads(lm, batch,
                                                         microbatch, actions)
                opt_state = opt.update(grads, opt_state, params)
                return opt_state, loss, metrics
            return train_step

        def train_step(opt_state: AdamWState, batch):
            loss, metrics = lm.loss(batch, actions)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            opt_state = opt.update(grads, opt_state, params)
            for p in params.values():
                p.grad = None
            return opt_state, loss, metrics

        return train_step

    def _step_key(self, actions, batch, microbatch: int = 1) -> tuple:
        return (self._batch_key(batch), tuple(int(a) for a in actions),
                int(microbatch))

    def _get_step_fn(self, actions, batch, microbatch: int = 1):
        key = self._step_key(actions, batch, microbatch)
        fn = self._step_cache.get(key)
        if fn is None:
            fn = self._build_step(actions, microbatch)
            self._step_cache[key] = fn
            self.cache_stats["compiles"] += 1
            self.cache_stats["evictions"] = self._step_cache.evictions
            return fn, True
        self.cache_stats["jit_hits"] += 1
        return fn, False

    def step(self, opt_state: AdamWState, batch):
        """One training step; returns ``(opt_state, loss)``."""
        batch = self._prepare(batch)
        t0 = time.perf_counter()
        actions, info = self.planner.plan(batch)
        t_plan = time.perf_counter() - t0
        bucket = self.planner.bucket_key(batch)
        k = max(int(info.plan.microbatch), 1)
        fn, is_new = self._get_step_fn(actions, batch, k)
        cuda = self.lm.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.lm.device)
            torch.cuda.reset_peak_memory_stats(self.lm.device)
        t1 = time.perf_counter()
        opt_state, loss, metrics = fn(opt_state, batch)
        loss = float(loss.detach())            # waits for the device
        if cuda:
            torch.cuda.synchronize(self.lm.device)
        t_step = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(self.lm.device) if cuda else 0
        plan = info.plan
        predicted = (float(self.planner.fixed_bytes or 0.0)
                     + plan.est_activation_bytes - plan.covered_bytes)
        B, S = batch["tokens"].shape
        # a non-divisor split computes over ceil(B/k)*k rows
        padded_tokens = int(-(-B // k) * k * S)
        buckets = self.cache_stats["bucket_steps"]
        buckets[bucket] = buckets.get(bucket, 0) + 1
        self.history.append(StepStats(
            loss, t_step, t_plan, is_new, plan.n_remat,
            int(metrics["tokens"]), bucket, padded_tokens,
            cache_hit=info.cache_hit, collected=info.collected,
            predicted_peak_bytes=predicted, max_memory_bytes=int(peak),
            microbatches=k))
        return opt_state, loss

    def run(self, batches, opt_state: Optional[AdamWState] = None):
        if opt_state is None:
            opt_state = self.optimizer.init(self.params)
        for batch in batches:
            opt_state, _ = self.step(opt_state, batch)
        return opt_state

    def summary(self) -> dict:
        """Throughput over warm steps (not the first of a (bucket, plan)
        key), plan time, remat and padding counts."""
        h = self.history
        if not h:
            return {}
        warm = [s for s in h if not s.compile]
        warm_s = max(float(np.sum([s.step_time_s for s in warm])), 1e-9)
        eff = float(np.sum([s.tokens for s in warm]))
        padded = float(np.sum([s.padded_tokens for s in warm]))
        return {
            "steps": len(h),
            "mean_step_s": (float(np.mean([s.step_time_s for s in warm]))
                            if warm else 0.0),
            "total_plan_s": float(np.sum([s.plan_time_s for s in h])),
            "compiles": int(sum(s.compile for s in h)),
            "jit_hits": int(self.cache_stats["jit_hits"]),
            "buckets": len(self.cache_stats["bucket_steps"]),
            "mean_remat_units": float(np.mean([s.remat_units for s in h])),
            "mean_microbatches": float(np.mean([s.microbatches
                                                for s in h])),
            "tokens_per_s": eff / warm_s if warm else 0.0,
            "padded_tokens_per_s": padded / warm_s if warm else 0.0,
            "pad_fraction": (1.0 - eff / max(padded, 1.0)) if warm else 0.0,
            "final_loss": h[-1].loss,
            # background-solver counters (0 without the solver tier)
            **{key: int(getattr(self.planner, "stats", {}).get(key, 0))
               for key in ("solves", "solver_swaps", "solver_wins",
                           "solver_timeouts")},
        }
