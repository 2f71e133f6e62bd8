"""Resilience: full-state snapshots with kill-and-resume, and an OOM
watchdog with the planner's escalation ladder.  The counterpart of the
reference's ``train/resilience.py`` on one CUDA device.

**Snapshots** (``SnapshotManager``).  A snapshot is a directory holding
the parameters and optimizer state (``train/checkpoint.py`` files), the
planner's learned state (``planner.json``: estimator samples, the
sample log, the plan cache with escalation levels) and a meta record
(step, data cursor, and the trainer's ``extra``: which units' moments
were parked on the host).  Writes are crash-consistent: everything
lands in a tmp directory, ``manifest.json`` with per-file sha256 hashes
is written last, and one ``os.replace`` makes the snapshot visible.
Retention keeps the last *k*; restore walks newest-to-oldest past any
corrupt or partial snapshot.

**Planner state** (``planner_state`` / ``restore_planner_state``).  The
mesh signature is ``()`` without a mesh budget and the budget's
``sig()`` with one.  A stored signature that differs from the live one
(a resume under another ``--mesh-shape``, ``--zero1`` or none) replays
the sample log through the live collector on ``meta`` tensors (zero
FLOPs, as the reference's abstract replay), so the estimators fit the
new mesh's per-device bytes, and drops the stored plans.  The replay
needs no parameters, where the reference's needs them.  The port's plan key has a sixth element, the
accumulation overhead; it is stored, and a plan whose link rate,
overlap or accumulation overhead differs from the live planner's is
dropped.

**OOM watchdog** (``OOMWatchdog`` + ``FaultInjector``).  The trainer
runs each step's forward and backward under the watchdog; on a device
OOM (``torch.OutOfMemoryError``, a ``RuntimeError`` carrying an OOM
marker, or an injected ``SimulatedOOM``) it books the failure against
the bucket, poisons the cached plan and step function, asks the planner
to ``escalate`` (more remat, then offload, then a doubled microbatch
split) and retries, up to a bounded number of attempts.
``MIMOSE_INJECT_OOM`` drives deterministic fault injection.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from collections.abc import MutableMapping
from typing import Any, Optional

import torch

from repro_torch.actions import Action
from repro_torch.core.scheduler import Plan
from repro_torch.obs import StatsView, Telemetry
from repro_torch.train import checkpoint
from repro_torch.train.checkpoint import CheckpointError

STATE_VERSION = 1


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
class SimulatedOOM(RuntimeError):
    """Injected device OOM; the message carries the reference's marker."""

    def __init__(self, step: int, bucket: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected OOM (step={step}, "
            f"bucket={bucket}) [simulated by repro_torch.train.resilience]")
        self.step = step
        self.bucket = bucket


class FaultInjector:
    """Deterministic OOM injection, driven by env or constructor.

    Spec formats (``MIMOSE_INJECT_OOM`` or the ``spec`` argument):

    * ``"3"`` (int string) — fail the first 3 step executions;
    * ``'{"bucket": {"1024": 2}, "step": {"5": 1}}'`` — fail the next 2
      executions of bucket 1024 and 1 execution of global step 5.

    Counters decrement on each injected failure, so a retried step that
    escalated past its quota succeeds.
    """

    ENV = "MIMOSE_INJECT_OOM"

    def __init__(self, spec: Any = None):
        self._first_n = 0
        self._by_bucket: dict = {}
        self._by_step: dict = {}
        self.injected = 0
        if spec is None:
            return
        if isinstance(spec, str):
            spec = spec.strip()
            if not spec:
                return
            try:
                spec = int(spec)
            except ValueError:
                try:
                    spec = json.loads(spec)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{self.ENV}: expected an int or a JSON object, "
                        f"got {spec!r}") from e
        if isinstance(spec, int):
            self._first_n = max(int(spec), 0)
        elif isinstance(spec, dict):
            self._by_bucket = {int(k): int(v)
                               for k, v in (spec.get("bucket") or {}).items()}
            self._by_step = {int(k): int(v)
                             for k, v in (spec.get("step") or {}).items()}
        else:
            raise ValueError(f"{self.ENV}: unsupported spec {spec!r}")

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        raw = os.environ.get(cls.ENV)
        return cls(raw) if raw else None

    @property
    def armed(self) -> bool:
        return (self._first_n > 0
                or any(v > 0 for v in self._by_bucket.values())
                or any(v > 0 for v in self._by_step.values()))

    def should_fail(self, *, step: int, bucket: int) -> bool:
        if self._first_n > 0:
            self._first_n -= 1
            self.injected += 1
            return True
        if self._by_step.get(int(step), 0) > 0:
            self._by_step[int(step)] -= 1
            self.injected += 1
            return True
        if self._by_bucket.get(int(bucket), 0) > 0:
            self._by_bucket[int(bucket)] -= 1
            self.injected += 1
            return True
        return False


# the reference's markers (an XLA RESOURCE_EXHAUSTED, the allocator's
# "out of memory"); a RuntimeError carrying one is an OOM
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM when allocating")


class OOMWatchdog:
    """Classifies device OOMs and books them; the retry/escalate loop
    itself lives in ``Trainer.step`` (it owns the caches it poisons)."""

    def __init__(self, *, max_retries: int = 3,
                 injector: Optional[FaultInjector] = None,
                 telemetry: Optional[Telemetry] = None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = int(max_retries)
        self.injector = (injector if injector is not None
                         else FaultInjector.from_env())
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.disabled())
        # the same metrics the planner's stats read once the trainer
        # binds both to one registry: one counter, two views
        self.stats = StatsView(
            self.telemetry.metrics,
            scalars={"oom_events": "train_oom_events",
                     "escalations": "train_escalations",
                     "retry_successes": "train_retry_successes",
                     "retry_failures": "train_retry_failures"},
            labeled={"oom_by_bucket": ("train_oom_events", "bucket")})

    def bind_telemetry(self, telemetry: Telemetry) -> None:
        self.telemetry = telemetry
        self.stats.attach(telemetry.metrics)

    @staticmethod
    def is_oom(e: BaseException) -> bool:
        """True for an injected OOM, a ``torch.OutOfMemoryError``, and a
        ``RuntimeError`` whose message carries an OOM marker; nothing
        else."""
        if isinstance(e, (SimulatedOOM, torch.OutOfMemoryError)):
            return True
        return (isinstance(e, RuntimeError)
                and any(m in str(e) for m in _OOM_MARKERS))

    def maybe_inject(self, *, step: int, bucket: int) -> None:
        """Raise a ``SimulatedOOM`` when the injector says this execution
        fails; the trainer calls it before the step's forward."""
        if self.injector is not None and self.injector.should_fail(
                step=step, bucket=bucket):
            raise SimulatedOOM(step, bucket)

    def on_oom(self, bucket: int) -> None:
        self.stats.inc("oom_events", bucket=int(bucket))

    def on_escalation(self) -> None:
        """For standalone use; the trainer does not call it: the
        planner's ``escalate`` bumps the shared ``train_escalations``
        counter already, and this view reads the same metric."""
        self.stats.inc("escalations")

    def on_retry_success(self) -> None:
        self.stats["retry_successes"] += 1

    def on_retry_failure(self) -> None:
        self.stats["retry_failures"] += 1


# ---------------------------------------------------------------------------
# planner state (de)serialization
# ---------------------------------------------------------------------------
def _plan_to_dict(plan: Plan) -> dict:
    return {"actions": [int(a) for a in plan.as_actions()],
            "excess_bytes": float(plan.excess_bytes),
            "covered_bytes": float(plan.covered_bytes),
            "est_activation_bytes": float(plan.est_activation_bytes),
            "recompute_flops": float(plan.recompute_flops),
            "offload_bytes": float(plan.offload_bytes),
            "microbatch": int(plan.microbatch),
            "source": str(getattr(plan, "source", "greedy"))}


def _plan_from_dict(d: dict) -> Plan:
    return Plan([], float(d["excess_bytes"]), float(d["covered_bytes"]),
                float(d["est_activation_bytes"]),
                recompute_flops=float(d.get("recompute_flops", 0.0)),
                actions=tuple(Action(int(a)) for a in d["actions"]),
                offload_bytes=float(d.get("offload_bytes", 0.0)),
                microbatch=int(d.get("microbatch", 1)),
                source=str(d.get("source", "greedy")))


def _learns(planner) -> bool:
    """A planner with online state: an estimator and a plan cache."""
    return hasattr(planner, "estimator") and hasattr(planner, "cache")


def planner_state(planner) -> dict:
    """JSON-able snapshot of what the planner learned online: the
    estimators' samples, the sample log that makes them replayable, the
    plan cache (every key element stored) and escalation levels.  A
    planner without an estimator and cache serializes to a name-only
    stub."""
    state = {"version": STATE_VERSION, "name": getattr(planner, "name", "?")}
    if not _learns(planner):
        return state
    state["mesh_sig"] = repr(planner.mesh_sig())
    state["estimators"] = {
        "activation": planner.estimator.state_dict(),
        "output": planner.est_output.state_dict(),
        "offload": planner.est_offload.state_dict(),
    }
    state["sample_log"] = list(getattr(planner, "_sample_log", []))
    esc = getattr(planner, "_escalation", {})
    plans = []
    for key in list(planner.cache.keys()):
        bucket, sig, max_mb, pcie, overlap, accum = key
        plans.append({"bucket": int(bucket), "mesh_sig": repr(sig),
                      "max_microbatches": int(max_mb),
                      "pcie_gbps": float(pcie),
                      "offload_overlap": float(overlap),
                      "accum_overhead_s": float(accum),
                      "escalation": int(esc.get(key, 0)),
                      "plan": _plan_to_dict(planner.cache[key])})
    state["plans"] = plans
    return state


def _probe_batch(probe: dict) -> dict:
    """A ``meta`` batch of a logged probe geometry (the collector and
    the cost model read shapes only)."""
    return {k: torch.empty(tuple(int(d) for d in shape),
                           dtype=getattr(torch, str(dtype)), device="meta")
            for k, (shape, dtype) in probe.items()}


def restore_planner_state(planner, state: dict) -> dict:
    """Load a ``planner_state`` into a live planner.

    Same signature: the estimators' samples load verbatim (and refit,
    ~1 ms).  Another signature: the sample log is replayed through the
    live collector on ``meta`` tensors and no stored plan survives.
    Plans whose roofline elements (link GB/s, overlap, accumulation
    overhead) differ from the live planner's are dropped.  Returns a
    summary for reporting."""
    summary = {"mesh_changed": False, "restored_samples": 0,
               "restored_plans": 0, "dropped_plans": 0}
    if not _learns(planner) or "estimators" not in state:
        return summary
    live_sig = repr(planner.mesh_sig())
    stored_sig = state.get("mesh_sig", live_sig)
    sample_log = list(state.get("sample_log", []))
    if stored_sig == live_sig:
        ests = state["estimators"]
        planner.estimator.load_state(ests["activation"])
        planner.est_output.load_state(ests["output"])
        planner.est_offload.load_state(ests["offload"])
        planner._sample_log = sample_log
        summary["restored_samples"] = planner.estimator.num_samples
    else:
        summary["mesh_changed"] = True
        planner._sample_log = []
        for rec in sample_log:
            probe = _probe_batch(rec["probe"])
            res = planner.collector.collect(probe)
            planner._feed_estimators(int(rec["size"]), res, probe)
            summary["restored_samples"] += 1
        if planner.estimator.ready:
            planner.estimator.fit()
            planner.est_output.fit()
            planner.est_offload.fit()
    for rec in state.get("plans", []):
        # the live roofline elements of the key; older snapshots lack
        # the fields and default to them
        live = planner.plan_key_of(int(rec["bucket"]))[3:]
        stored = (round(float(rec.get("pcie_gbps", live[0])), 6),
                  round(float(rec.get("offload_overlap", live[1])), 6),
                  float(rec.get("accum_overhead_s", live[2])))
        if rec.get("mesh_sig") != live_sig or stored != live:
            summary["dropped_plans"] += 1
            continue
        key = (int(rec["bucket"]), planner.mesh_sig(),
               int(rec["max_microbatches"])) + live
        planner.cache[key] = _plan_from_dict(rec["plan"])
        if rec.get("escalation"):
            planner._escalation[key] = int(rec["escalation"])
        summary["restored_plans"] += 1
    st = getattr(planner, "stats", None)
    if isinstance(st, MutableMapping):
        for k in ("restored_samples", "restored_plans", "dropped_plans"):
            st[k] = st.get(k, 0) + summary[k]
    return summary


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------
class SnapshotError(RuntimeError):
    """A snapshot directory failed validation (missing/corrupt files)."""


@dataclasses.dataclass
class Restored:
    """Everything ``SnapshotManager.restore_latest`` hands back."""
    params: Any
    opt_state: Any
    step: int
    data_cursor: int
    planner_summary: dict
    path: str
    meta: dict


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class SnapshotManager:
    """Periodic, atomic, self-validating training snapshots.

    ``due(step)`` fires on a step cadence (``every_steps``) and/or a
    wall-clock cadence (``every_secs``).  Each ``save`` writes params,
    optimizer state, planner state and meta into ``<dir>/.tmp-*``, then
    ``manifest.json`` with the sha256 and byte count of every file
    (written last: a manifest certifies a complete write), then renames
    the directory to ``snap-<step>``.  ``keep`` bounds disk: snapshots
    older than the last *k* are deleted after each save.
    """

    MANIFEST = "manifest.json"
    PLANNER = "planner.json"

    def __init__(self, directory: str, *, every_steps: int = 0,
                 every_secs: float = 0.0, keep: int = 3,
                 telemetry: Optional[Telemetry] = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = directory
        self.every_steps = int(every_steps)
        self.every_secs = float(every_secs)
        self.keep = int(keep)
        self.written = 0
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.disabled())
        self._last_save = time.monotonic()
        os.makedirs(self.dir, exist_ok=True)

    def bind_telemetry(self, telemetry: Telemetry) -> None:
        self.telemetry = telemetry

    def due(self, step: int) -> bool:
        if self.every_steps > 0 and step > 0 \
                and step % self.every_steps == 0:
            return True
        return (self.every_secs > 0
                and time.monotonic() - self._last_save >= self.every_secs)

    def save(self, *, step: int, params, opt_state, planner=None,
             data_cursor: int = 0, extra: Optional[dict] = None) -> str:
        final = os.path.join(self.dir, f"snap-{step:08d}")
        tmp = os.path.join(self.dir, f".tmp-snap-{step:08d}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        checkpoint.save(os.path.join(tmp, "params.ckpt"), params)
        checkpoint.save(os.path.join(tmp, "opt.ckpt"), opt_state)
        if planner is not None:
            with open(os.path.join(tmp, self.PLANNER), "w") as f:
                json.dump(planner_state(planner), f)
        meta = {"step": int(step), "data_cursor": int(data_cursor),
                "wall_time": time.time(), "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        files = {name: {"sha256": _sha256(os.path.join(tmp, name)),
                        "bytes": os.path.getsize(os.path.join(tmp, name))}
                 for name in sorted(os.listdir(tmp))}
        # manifest last: its presence certifies every file above landed
        with open(os.path.join(tmp, self.MANIFEST), "w") as f:
            json.dump({"step": int(step), "files": files}, f, indent=1)
        if os.path.isdir(final):          # re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)
        self.written += 1
        self._last_save = time.monotonic()
        self.telemetry.metrics.counter(
            "snapshots_written", "atomic snapshot saves").inc()
        if self.telemetry.events_on:
            self.telemetry.events.emit(
                "snapshot_save", step=int(step), path=final,
                bytes=int(sum(rec["bytes"] for rec in files.values())))
        for old in self.snapshots()[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)
        return final

    def snapshots(self) -> list:
        """All snapshot dirs, oldest first (tmp dirs excluded)."""
        if not os.path.isdir(self.dir):
            return []
        return sorted(os.path.join(self.dir, d)
                      for d in os.listdir(self.dir) if d.startswith("snap-"))

    def latest(self) -> Optional[str]:
        """The newest snapshot dir, or None."""
        snaps = self.snapshots()
        return snaps[-1] if snaps else None

    def verify(self, path: str) -> dict:
        """Validate one snapshot dir against its manifest; returns the
        manifest, raises ``SnapshotError`` on a missing or corrupt
        file."""
        man_path = os.path.join(path, self.MANIFEST)
        if not os.path.isfile(man_path):
            raise SnapshotError(f"{path}: no manifest (partial write?)")
        try:
            with open(man_path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise SnapshotError(f"{path}: unreadable manifest: {e}") from e
        for name, rec in manifest.get("files", {}).items():
            fp = os.path.join(path, name)
            if not os.path.isfile(fp):
                raise SnapshotError(f"{path}: missing file {name}")
            if os.path.getsize(fp) != rec["bytes"]:
                raise SnapshotError(
                    f"{path}: {name} is {os.path.getsize(fp)} bytes, "
                    f"manifest says {rec['bytes']}")
            if _sha256(fp) != rec["sha256"]:
                raise SnapshotError(f"{path}: {name} content hash mismatch")
        return manifest

    def restore_latest(self, *, params_like, opt_like,
                       planner=None) -> Restored:
        """Restore the newest snapshot that validates, walking past any
        corrupt or partial one."""
        errors = []
        for path in reversed(self.snapshots()):
            try:
                self.verify(path)
                with open(os.path.join(path, "meta.json")) as f:
                    meta = json.load(f)
                params = checkpoint.load(os.path.join(path, "params.ckpt"),
                                         params_like)
                opt_state = checkpoint.load(os.path.join(path, "opt.ckpt"),
                                            opt_like)
                psummary = {}
                ppath = os.path.join(path, self.PLANNER)
                if planner is not None and os.path.isfile(ppath):
                    with open(ppath) as f:
                        psummary = restore_planner_state(planner,
                                                         json.load(f))
            except (SnapshotError, CheckpointError, OSError,
                    KeyError, ValueError) as e:
                errors.append(f"{path}: {e}")
                continue
            self.telemetry.metrics.counter(
                "snapshots_restored", "snapshot restores").inc()
            if self.telemetry.events_on:
                self.telemetry.events.emit(
                    "snapshot_restore", step=int(meta["step"]), path=path,
                    restored_plans=psummary.get("restored_plans", 0),
                    dropped_plans=psummary.get("dropped_plans", 0),
                    mesh_changed=psummary.get("mesh_changed", False))
            return Restored(params=params, opt_state=opt_state,
                            step=int(meta["step"]),
                            data_cursor=int(meta.get("data_cursor", 0)),
                            planner_summary=psummary, path=path, meta=meta)
        raise SnapshotError(
            "no restorable snapshot under " + self.dir
            + ("; tried:\n  " + "\n  ".join(errors) if errors else ""))
