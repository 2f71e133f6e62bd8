"""Training loop with the Mimose planner on the critical path (paper §4.1).

Counterpart of the reference's ``train/trainer.py`` (eager, one
device executes the step):

  1. Each batch is padded up to the planner's quantum (``pad_batch``);
     the true ``lengths`` ride along so attention masks (and the flash
     kernels skip) the padded tail, and padded positions carry zero
     loss weight.
  2. ``planner.plan`` maps the bucket to a typed action tuple (KEEP /
     REMAT / OFFLOAD / OFFLOAD_OPT).
  3. The step runs forward + backward under that plan and an AdamW
     update in place.  A plan with ``Plan.microbatch = k > 1`` runs as
     ``k`` accumulated microbatches (``train/accumulate.py``).  Step
     functions are cached per (batch shapes, typed actions, k) like the
     reference's jit cache, so ``StepStats.compile`` marks the first
     step of each key — and a plan the background solver swapped in
     builds a new step function for its bucket only.
  4. OFFLOAD units send their input checkpoints to the host through the
     trainer's ``TransferLane`` (``models/lm.py``).  A plan with
     OFFLOAD_OPT units (unrolled mode; the planner does not offer them
     in scan mode) runs as a split step: gradients first, then the
     parked units' fp32 AdamW moments come back to the device on the
     lane, the update runs, and the moments of the plan's OFFLOAD_OPT
     units go back to pinned host memory, where they stay through the
     next step's forward and backward.
  5. ``prewarm`` plans the likeliest buckets before step 0 (eager
     PyTorch has nothing to compile), so the first batch of each is a
     plan-cache hit.

Resilience (``train/resilience.py``): with an ``OOMWatchdog`` the
step's forward and backward run in a bounded retry loop.  The window
ends once the gradients are computed: until then nothing of the
parameters or the optimizer state has changed, so an OOM there is
booked against the bucket, the failed step function is dropped, the
planner escalates and the step runs again under the new plan — after
the failed attempt's memory is freed (its frames released, ``.grad``
dropped, the transfer lane drained, the allocator's cache emptied).
An OOM in the update (which writes parameters and moments in place) is
re-raised.  With a ``SnapshotManager`` a snapshot is written when one
is due after a step; ``restore`` copies a snapshot into the live
parameters in place and puts parked moments back on the host.

Telemetry (``repro_torch.obs``): ``cache_stats`` is a ``StatsView``
over the run's registry; each step traces ``plan``, ``build_step`` and
``execute`` spans on the step track (one per attempt, with an ``oom``
instant and event after a failed one) and emits a ``train_step`` event
numbered by ``global_step``;
the lane's exposed time and the simulator's price of the same bytes
land in ``train_exposed_transfer_s`` / ``train_sim_transfer_s``.

Sharding: ``mesh`` (a ``DeviceMesh``) is kept for the run, and the
step-function cache key carries the planner's mesh signature, so a step
built under one mesh shape is never reused under another -- the
execution side of the planner's (bucket, mesh) plan key.  Nothing reads
``mesh`` yet: the step runs whole on this process's device with the
inputs replicated, as the reference's launcher runs it, until a sharded
step is ported.

On CUDA each step records ``torch.cuda.max_memory_allocated`` next to
the plan's predicted peak (fixed bytes + predicted activations - bytes
the plan frees, per microbatch under a split) — the paper's headline
comparison.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.actions import Action
from repro_torch.core.cache import LRUCache
from repro_torch.core.planner import PlannerBase
from repro_torch.data.pipeline import pad_batch
from repro_torch.launch.roofline import PCIE_BW
from repro_torch.models.lm import configure_offload
from repro_torch.obs import LabelView, StatsView, Telemetry, TRACK_STEP
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.accumulate import accumulated_grads
from repro_torch.train.transfer import TransferLane

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
    offload_units: int = 0     # units whose input went to host memory
    opt_offload_units: int = 0  # units whose optimizer moments are parked
    # the plan had OFFLOAD units but ran them as REMAT (offload_exec off)
    offload_degraded: bool = False
    # host time this step spent blocked on the transfer lane, and the
    # simulator's (1 - overlap) price of the bytes the lane moved
    exposed_transfer_s: float = 0.0
    sim_transfer_s: float = 0.0
    # the loss's parts: cross entropy and the auxiliary (MoE
    # load-balance) loss, 0 for families without one
    ce: float = 0.0
    aux: float = 0.0
    # layers whose forward runs again in the backward (every layer of a
    # REMAT or OFFLOAD unit, the encoder's included), per microbatch,
    # and those of them in the decoder
    recompute_layers: int = 0
    recompute_dec_layers: int = 0


class StepFn(NamedTuple):
    """A built step.  ``grads(batch)`` runs the forward and backward and
    returns ``(loss, metrics, grads)`` without touching the parameters
    or the optimizer state (the window the watchdog retries);
    ``Trainer._update`` then applies AdamW in place.  With
    ``opt_units`` (OFFLOAD_OPT units, unrolled mode) the step is split:
    the parked moments come to the device only for the update and the
    plan's units go back out after it."""
    grads: Callable
    opt_units: tuple = ()


class Trainer:
    def __init__(self, lm, planner: PlannerBase,
                 optimizer: Optional[AdamW] = None,
                 telemetry: Optional[Telemetry] = None,
                 watchdog=None, snapshots=None, mesh=None):
        self.lm = lm
        self.planner = planner
        self.mesh = mesh                  # a DeviceMesh, or None; unread
        # one registry per run: the planner re-homes its stats into it
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.disabled())
        planner.bind_telemetry(self.telemetry)
        self.optimizer = optimizer or AdamW()
        self.params = dict(lm.named_parameters())
        # parameter names of each plan unit (its layers' trees, the
        # encoder's units first), for moment parking
        self._unit_names = [
            [n for n in self.params
             if any(n.startswith(f"{stack}.{i}.") for i in range(s, e))]
            for stack, s, e in lm.plan_unit_layers()]
        # the transfer lane, made when a plan first moves something; the
        # parked-unit set records whose moments live on the host
        self.transfer_lane: Optional[TransferLane] = None
        self._parked: set = set()
        self._step_cache = LRUCache(MAX_CACHED_STEPS)
        self.history: list[StepStats] = []
        # resilience: the OOM watchdog, the snapshot manager, and the
        # counters a resumed run carries on
        self.watchdog = watchdog
        self.snapshots = snapshots
        self.global_step = 0              # across restarts (set on resume)
        self.data_cursor = 0              # batches consumed from the stream
        self.restores = 0                 # snapshots restored into this run
        reg = self.telemetry.metrics
        self._m_padded_tokens = reg.counter(
            "train_bucket_padded_tokens",
            "bucket-shape tokens actually computed over")
        self._m_eff_tokens = reg.counter(
            "train_bucket_tokens", "effective (unpadded) tokens")
        self._g_bucket_k = reg.gauge(
            "train_bucket_microbatch",
            "largest gradient-accumulation split seen per bucket")
        self._h_step_s = reg.histogram(
            "train_step_time_s", "wall time per executed train step")
        self.cache_stats = StatsView(
            reg,
            scalars={"compiles": "train_jit_compiles",
                     "prewarm_compiles": "train_jit_prewarm_compiles",
                     "jit_hits": "train_jit_hits",
                     "evictions": "train_jit_evictions"},
            labeled={"bucket_steps": ("train_bucket_steps", "bucket")},
            composite={
                "bucket_tokens": self._bucket_tokens_view,
                "bucket_microbatch":
                    lambda: LabelView(self._g_bucket_k, "bucket")})

    # properties, so that a later assignment also re-homes the
    # component's metrics into the run's registry (the watchdog's and
    # the planner's oom_events / escalations are then one counter)
    @property
    def watchdog(self):
        return self._watchdog

    @watchdog.setter
    def watchdog(self, wd) -> None:
        if wd is not None:
            wd.bind_telemetry(self.telemetry)
        self._watchdog = wd

    @property
    def snapshots(self):
        return self._snapshots

    @snapshots.setter
    def snapshots(self, sm) -> None:
        if sm is not None:
            sm.bind_telemetry(self.telemetry)
        self._snapshots = sm

    def _bucket_tokens_view(self) -> dict:
        """``{bucket: [padded_tokens, effective_tokens]}``."""
        padded = LabelView(self._m_padded_tokens, "bucket")
        eff = LabelView(self._m_eff_tokens, "bucket")
        return {b: [padded.get(b, 0), eff.get(b, 0)]
                for b in set(padded) | set(eff)}

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
        lm, params = self.lm, self.params
        opt_units = tuple(u for u, a in enumerate(actions)
                          if int(a) == int(Action.OFFLOAD_OPT))

        if microbatch > 1:
            def grad_fn(batch):
                return accumulated_grads(lm, batch, microbatch, actions)
        else:
            def grad_fn(batch):
                loss, metrics = lm.loss(batch, actions)
                loss.backward()
                grads = {n: p.grad for n, p in params.items()}
                for p in params.values():
                    p.grad = None
                return loss, metrics, grads

        if lm.cfg.remat_mode == "scan":
            # the planner offers no OFFLOAD_OPT in scan mode
            opt_units = ()
        # OFFLOAD_OPT: the parked moments must be off the device while
        # activations peak and on it only for the update (_update)
        return StepFn(grad_fn, opt_units)

    def _step_key(self, actions, batch, microbatch: int = 1) -> tuple:
        # the typed actions: two plans that remat the same units but
        # offload or split differently get different step functions; the
        # mesh signature aligns the key with the planner's plan key
        return (self._batch_key(batch), tuple(int(a) for a in actions),
                int(microbatch), self.planner.mesh_sig())

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

    # -- the transfer lane and optimizer-moment parking -----------------
    def _lane(self) -> TransferLane:
        """The run's lane (made on first use), shared with the model's
        OFFLOAD units so both land in the trainer's telemetry."""
        if self.transfer_lane is None:
            self.transfer_lane = TransferLane(self.lm.device,
                                              telemetry=self.telemetry)
            configure_offload(self.lm, self.transfer_lane)
        return self.transfer_lane

    def _moment_get(self, tree: dict, u: int) -> dict:
        """The moments of plan unit ``u``: ``{param name: tensor}``."""
        return {n: tree[n] for n in self._unit_names[u]}

    @staticmethod
    def _moment_set(tree: dict, val: dict) -> dict:
        out = dict(tree)
        out.update(val)
        return out

    def _park_moments(self, opt_state: AdamWState,
                      opt_units) -> AdamWState:
        """Stream the fp32 AdamW m and v of every OFFLOAD_OPT unit to
        pinned host memory and put the host buffers into the state, so
        those bytes are off the device until the next update.  Every
        copy starts before any is waited on."""
        if not opt_units:
            self._parked = set()
            return opt_state
        lane = self._lane()
        m, v = opt_state.m, opt_state.v
        pending = [(which, n, lane.offload(x))
                   for u in opt_units
                   for which, tree in (("m", m), ("v", v))
                   for n, x in self._moment_get(tree, u).items()]
        host = {"m": {}, "v": {}}
        for which, n, h in pending:
            host[which][n] = lane.host_value(h)
        self._parked = set(opt_units)
        return AdamWState(opt_state.step, self._moment_set(m, host["m"]),
                          self._moment_set(v, host["v"]))

    def _update(self, fn: StepFn, grads, opt_state: AdamWState, batch,
                bucket: int, step_key, attempt: int):
        """The update after the gradients: AdamW one parameter at a
        time, each all or nothing (``AdamW.apply``), a parked moment
        brought home just before its parameter's update; then the
        moments of the plan's OFFLOAD_OPT units back out.  An OOM in it
        is booked and escalated as one in the step (``_book_oom``), the
        cache freed, and the update resumed at the first parameter not
        written, with the same gradients, clip scale, step and learning
        rate: bit for bit the update that did not fail.  Returns
        ``(opt_state, attempt)``."""
        wd = self.watchdog
        parked = {n for u in self._parked for n in self._unit_names[u]}
        away = {"m": set(parked), "v": set(parked)}     # still on the host
        state = AdamWState(opt_state.step, dict(opt_state.m),
                           dict(opt_state.v))

        def moments(name):
            # a parked moment comes home into the state once its upload
            # landed; until then the state keeps the host buffer
            for which, tree in (("m", state.m), ("v", state.v)):
                if name in away[which]:
                    lane = self._lane()
                    tree[name] = lane.fetch(lane.upload(tree[name]))
                    away[which].discard(name)
            return state.m[name], state.v[name]

        cursor = None
        while True:
            try:
                if cursor is None:
                    cursor = self.optimizer.begin(grads, state)
                opt_state = self.optimizer.apply(cursor, grads, state,
                                                 self.params, moments)
                break
            except RuntimeError as e:
                if wd is None or not wd.is_oom(e):
                    raise
                attempt += 1
                if not self._book_oom(e, batch, bucket, step_key, attempt):
                    raise
            # out of the except block, as in ``step``
            self._recover_from_oom()
        self._parked = set()
        if fn.opt_units:
            opt_state = self._park_moments(opt_state, fn.opt_units)
        return opt_state, attempt

    def _book_oom(self, e: BaseException, batch, bucket: int, step_key,
                  attempt: int) -> bool:
        """The plan said the bucket fits and the device disagreed: book
        the OOM (the planner's stats read the same counter), drop the
        failed step function, and ask the planner for a more aggressive
        plan.  Returns whether to retry; False (retries spent or the
        ladder exhausted) books the failure."""
        wd, tel = self.watchdog, self.telemetry
        wd.on_oom(bucket)
        self._step_cache.pop(step_key, None)
        if tel.events_on:
            tel.events.emit("oom", step=self.global_step, bucket=bucket,
                            attempt=attempt, error=type(e).__name__)
        tel.tracer.instant("oom", TRACK_STEP, args={"bucket": bucket})
        if attempt > wd.max_retries or not self.planner.escalate(batch):
            wd.on_retry_failure()
            return False
        return True

    def _recover_from_oom(self) -> None:
        """Free what a failed attempt left: its gradients, the lane's
        in-flight copies and pooled pinned buffers, reference cycles
        that hold its graph, and the allocator's cached blocks (so a
        fragmented cache is not a second, false OOM).  Called after the
        ``except`` block, so the attempt's frames are already gone."""
        for p in self.params.values():
            p.grad = None
        for lane in {self.transfer_lane,
                     getattr(self.lm, "transfer_lane", None)} - {None}:
            lane.close()
        gc.collect()
        if self.lm.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- snapshots ------------------------------------------------------
    def save_snapshot(self, opt_state: AdamWState, snapshots=None) -> str:
        """Write the live state through ``snapshots`` (default: the
        trainer's manager): parameters, optimizer state (parked moments
        from their host buffers), planner state, and which units'
        moments are parked."""
        sm = snapshots if snapshots is not None else self.snapshots
        return sm.save(step=self.global_step, params=self.params,
                       opt_state=opt_state, planner=self.planner,
                       data_cursor=self.data_cursor,
                       extra={"parked": sorted(self._parked)})

    def restore(self, opt_state: AdamWState, snapshots=None):
        """Restore the newest valid snapshot into this run: parameters
        copied into the live tensors in place (the step cache and the
        lane keep pointing at them), the moments onto the parameters'
        device and the snapshot's parked units back on the host, the
        planner's state, ``global_step`` and ``data_cursor``.  Returns
        ``(opt_state, Restored)``."""
        sm = snapshots if snapshots is not None else self.snapshots
        r = sm.restore_latest(params_like=self.params, opt_like=opt_state,
                              planner=self.planner)
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(r.params[n])
        dev = {n: p.device for n, p in self.params.items()}
        opt_state = AdamWState(
            r.opt_state.step,
            {n: t.to(dev[n]) for n, t in r.opt_state.m.items()},
            {n: t.to(dev[n]) for n, t in r.opt_state.v.items()})
        self._parked = set()
        opt_state = self._park_moments(
            opt_state, tuple(r.meta.get("extra", {}).get("parked", ())))
        r.params, r.opt_state = self.params, opt_state
        self.global_step, self.data_cursor = r.step, r.data_cursor
        self.restores += 1
        return opt_state, r

    # ------------------------------------------------------------------
    def prewarm(self, seq_lens: Iterable[int], batch_size: int,
                extra=None) -> int:
        """Plan the given bucket seq-lens before step 0 and build their
        step functions.  Eager PyTorch has nothing to compile, so the
        gain is the plan: the first real batch of a prewarmed bucket is
        a plan-cache hit (sheltered collections happen here, off the
        step).  ``extra`` maps more batch keys to ``fn(batch_size, S)``
        functions (the ``make_batches`` convention): the encoder's
        ``frames``, the vision ``vision_embeds``.  Each step function
        built bumps ``prewarm_compiles`` (the registry's
        ``train_jit_prewarm_compiles``); returns their number."""
        n = 0
        for S in seq_lens:
            raw = {"tokens": np.zeros((batch_size, int(S)), np.int32),
                   "labels": np.zeros((batch_size, int(S)), np.int32),
                   "weights": np.ones((batch_size, int(S)), np.float32)}
            if extra:
                raw.update({k: fn(batch_size, int(S))
                            for k, fn in extra.items()})
            batch = self._prepare(raw)
            actions, info = self.planner.plan(batch)
            k = max(int(info.plan.microbatch), 1)
            key = self._step_key(actions, batch, k)
            if key in self._step_cache:
                continue
            self._step_cache[key] = self._build_step(actions, k)
            self.cache_stats["prewarm_compiles"] += 1
            self.cache_stats["evictions"] = self._step_cache.evictions
            n += 1
        return n

    def step(self, opt_state: AdamWState, batch):
        """One training step; returns ``(opt_state, loss)``."""
        tel = self.telemetry
        tracer = tel.tracer
        batch = self._prepare(batch)
        t0 = time.perf_counter()
        with tracer.span("plan", TRACK_STEP):
            actions, info = self.planner.plan(batch)
        t_plan = time.perf_counter() - t0
        bucket = self.planner.bucket_key(batch)
        cuda = self.lm.device.type == "cuda"
        wd = self.watchdog
        attempt = 0
        while True:
            plan = info.plan
            k = max(int(plan.microbatch), 1)
            t_c0 = time.perf_counter()
            fn, is_new = self._get_step_fn(actions, batch, k)
            if is_new:
                tracer.complete("build_step", t_c0,
                                time.perf_counter() - t_c0, TRACK_STEP,
                                args={"bucket": bucket}
                                if tel.trace_on else None)
            if plan.n_offload or plan.n_opt or self._parked:
                self._lane()
            if self.transfer_lane is not None:
                self.transfer_lane.reset_stats()
            if cuda:
                torch.cuda.synchronize(self.lm.device)
                torch.cuda.reset_peak_memory_stats(self.lm.device)
            t1 = time.perf_counter()
            step_key = self._step_key(actions, batch, k)
            in_update = False
            try:
                with tracer.span("execute", TRACK_STEP):
                    if wd is not None:
                        # an injected fault fires before any work
                        wd.maybe_inject(step=self.global_step,
                                        bucket=bucket)
                    # the allocator raises an OOM on the host when the
                    # allocation is made, so it surfaces in this call
                    loss, metrics, grads = fn.grads(batch)
                    # the update writes in place: it retries itself,
                    # resuming where it stopped
                    in_update = True
                    opt_state, attempt = self._update(
                        fn, grads, opt_state, batch, bucket, step_key,
                        attempt)
                    del grads
                    loss = float(loss.detach())    # waits for the device
                    if cuda:
                        torch.cuda.synchronize(self.lm.device)
            except RuntimeError as e:      # every OOM is one
                if in_update or wd is None or not wd.is_oom(e):
                    raise
                attempt += 1
                if not self._book_oom(e, batch, bucket, step_key, attempt):
                    raise
            else:
                break
            # out of the except block: the failed attempt's frames (and
            # the activations they hold) are released
            self._recover_from_oom()
            t0 = time.perf_counter()
            with tracer.span("plan", TRACK_STEP):
                actions, info = self.planner.plan(batch)
            t_plan += time.perf_counter() - t0
        if wd is not None and attempt:
            wd.on_retry_success()
        t_step = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(self.lm.device) if cuda else 0
        predicted = (float(self.planner.fixed_bytes or 0.0)
                     + plan.est_activation_bytes - plan.covered_bytes)
        B, S = batch["tokens"].shape
        # a non-divisor split computes over ceil(B/k)*k rows
        padded_tokens = int(-(-B // k) * k * S)
        eff_tokens = int(metrics["tokens"])
        self.cache_stats.inc("bucket_steps", bucket=bucket)
        self._m_padded_tokens.inc(padded_tokens, bucket=bucket)
        self._m_eff_tokens.inc(eff_tokens, bucket=bucket)
        self._g_bucket_k.set_max(k, bucket=bucket)
        self._h_step_s.observe(t_step)
        # what the lane measured against the simulator's price of the
        # same bytes
        exposed_s = sim_s = 0.0
        if self.transfer_lane is not None:
            xfer = self.transfer_lane.reset_stats()
            exposed_s = float(xfer["exposed_s"])
            moved = float(xfer["bytes_out"] + xfer["bytes_in"])
            if moved:
                rate = getattr(self.planner, "link_bytes_per_s", None)
                pcie = rate() if rate is not None else PCIE_BW
                ov = float(getattr(self.planner, "offload_overlap", 0.5))
                sim_s = (1.0 - ov) * moved / pcie
        if exposed_s or sim_s:
            tel.metrics.counter("train_exposed_transfer_s").inc(exposed_s)
            tel.metrics.counter("train_sim_transfer_s").inc(sim_s)
        degraded = bool(plan.n_offload and not self.lm.offload_exec)
        recomputed = [(e - s, stack == "blocks") for a, (stack, s, e)
                      in zip(actions, self.lm.plan_unit_layers())
                      if int(a) in (int(Action.REMAT), int(Action.OFFLOAD))]
        if degraded:
            tel.metrics.counter("train_offload_degraded_steps").inc()
        self.history.append(StepStats(
            loss, t_step, t_plan, is_new, plan.n_remat, eff_tokens, bucket,
            padded_tokens, cache_hit=info.cache_hit,
            collected=info.collected, predicted_peak_bytes=predicted,
            max_memory_bytes=int(peak), microbatches=k,
            offload_units=plan.n_offload, opt_offload_units=plan.n_opt,
            offload_degraded=degraded, exposed_transfer_s=exposed_s,
            sim_transfer_s=sim_s, ce=float(metrics["ce"].detach()),
            aux=float(metrics["aux"].detach()),
            recompute_layers=sum(n for n, _ in recomputed),
            recompute_dec_layers=sum(n for n, dec in recomputed if dec)))
        if tel.events_on:
            tel.events.emit("train_step", step=self.global_step,
                            bucket=bucket, loss=loss, k=k,
                            compile=bool(is_new),
                            plan_source=plan.source,
                            cache_hit=bool(info.cache_hit),
                            n_remat=int(plan.n_remat),
                            n_offload=int(plan.n_offload),
                            n_opt=int(plan.n_opt),
                            offload_bytes=float(plan.offload_bytes),
                            step_time_s=t_step, plan_time_s=t_plan,
                            exposed_transfer_s=exposed_s,
                            max_memory_bytes=int(peak),
                            predicted_peak_bytes=predicted)
        self.global_step += 1
        self.data_cursor += 1
        if self.snapshots is not None and self.snapshots.due(
                self.global_step):
            self.save_snapshot(opt_state)
        return opt_state, loss

    def run(self, batches, opt_state: Optional[AdamWState] = None):
        if opt_state is None:
            opt_state = self.optimizer.init(self.params)
        for batch in batches:
            opt_state, _ = self.step(opt_state, batch)
        return opt_state

    def summary(self) -> dict:
        """Throughput over warm steps (not the first of a (bucket, plan)
        key), plan time, remat, offload and padding counts."""
        h = self.history
        if not h:
            return {}
        warm = [s for s in h if not s.compile]
        warm_s = max(float(np.sum([s.step_time_s for s in warm])), 1e-9)
        eff = float(np.sum([s.tokens for s in warm]))
        padded = float(np.sum([s.padded_tokens for s in warm]))
        stats = getattr(self.planner, "stats", {})
        return {
            "steps": len(h),
            "mean_step_s": (float(np.mean([s.step_time_s for s in warm]))
                            if warm else 0.0),
            "total_plan_s": float(np.sum([s.plan_time_s for s in h])),
            "compiles": int(sum(s.compile for s in h)),
            "prewarm_compiles": int(self.cache_stats["prewarm_compiles"]),
            "jit_hits": int(self.cache_stats["jit_hits"]),
            "buckets": len(self.cache_stats["bucket_steps"]),
            "mean_remat_units": float(np.mean([s.remat_units for s in h])),
            "mean_offload_units": float(np.mean([s.offload_units
                                                 for s in h])),
            "mean_opt_offload_units": float(np.mean([s.opt_offload_units
                                                     for s in h])),
            "mean_microbatches": float(np.mean([s.microbatches
                                                for s in h])),
            # measured lane blocking against the simulator's price of
            # the same traffic, and OFFLOAD steps that ran as REMAT
            "exposed_transfer_s": float(np.sum([s.exposed_transfer_s
                                                for s in h])),
            "sim_transfer_s": float(np.sum([s.sim_transfer_s for s in h])),
            "offload_degraded_steps": int(sum(s.offload_degraded
                                              for s in h)),
            "offload_fallbacks": int(stats.get("offload_fallbacks", 0)),
            "tokens_per_s": eff / warm_s if warm else 0.0,
            "padded_tokens_per_s": padded / warm_s if warm else 0.0,
            "pad_fraction": (1.0 - eff / max(padded, 1.0)) if warm else 0.0,
            "final_loss": h[-1].loss,
            "final_ce": h[-1].ce,
            "final_aux": h[-1].aux,
            # resilience counters (0 without a watchdog / snapshots)
            "snapshots_written": (int(self.snapshots.written)
                                  if self.snapshots is not None else 0),
            "restores": int(self.restores),
            **{key: (int(self.watchdog.stats[key])
                     if self.watchdog is not None else 0)
               for key in ("oom_events", "escalations", "retry_successes",
                           "retry_failures")},
            "escalations_by_bucket": dict(stats.get("escalations_by_bucket",
                                                    {})),
            # background-solver counters (0 without the solver tier)
            **{key: int(stats.get(key, 0))
               for key in ("solves", "solver_swaps", "solver_wins",
                           "solver_timeouts")},
        }
