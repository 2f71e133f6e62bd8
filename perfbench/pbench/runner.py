"""One run of one cell: set-up, the measured window, the traced stretch,
the reference check, the metrics and the result line.

The system under test is the port's training path as
``repro_torch/launch/train.py::_train`` builds it: ``Trainer`` under
``MimosePlanner`` (cost-aware, the mix's quantum, no offload, no
solver), an ``OOMWatchdog`` with the cell's retry limit, AdamW on the
launcher's cosine schedule, and ``--attn-impl flash``.  The allocator is
capped at the cell's ``budget_mib`` and the planner is given the same
budget.
The loop is closed: the next batch starts when the step returns.  A
step whose OOM ladder is exhausted counts as failed and the run goes on
with the next batch (nothing of the parameters changed).

Set-up: process start, the model with seeded weights drawn on the
device, and a warm-up stream (one step at every bucket the window uses,
then one cycle of its sizes; the first such steps build the kernels,
collect and plan).
Its first ``CHECKED_STEPS`` steps are the ones the reference follows.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from pbench import check, model_init, refcore
from pbench import trace as tr
from pbench.traffic import Mix

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
CHECKED_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# what every cell runs, as ``launch/train.py`` would with these flags;
# a cell that needs another value makes it a field of its file
ATTN_IMPL = "flash"
PLANNER = {"warmup_samples": 3, "cost_aware": True, "max_microbatches": 1}
OPTIMIZER = {"lr": 3e-4, "warmup_steps": 10, "total_steps": 100000}


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: Mix
    metrics: List[dict]           # BENCHMARK.json entries this cell reports

    @property
    def model(self) -> dict:
        return self.config["model"]


def _entries_for(name: str, bench: dict, kind: str) -> List[dict]:
    return [m for m in bench.get(kind, [])
            if name in m.get("workloads", [name])]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              directory: Path = PERFBENCH) -> Cell:
    """The cell's files, found by name."""
    wl = json.loads((directory / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((directory / "configs" / f"{wl['config']}.json")
                     .read_text())
    mix = Mix.load(wl["traffic"], directory / "traffic")
    bench = json.loads(bench_path.read_text()) if bench_path.exists() else {}
    metrics = ([dict(m, kind="end_to_end")
                for m in _entries_for(name, bench, "end_to_end")]
               + [dict(m, kind="per_layer")
                  for m in _entries_for(name, bench, "per_layer")])
    return Cell(name, wl, cfg, mix, metrics)


def budget_bytes(cell: Cell) -> float:
    return float(cell.workload["budget_mib"]) * 2**20


def cap_allocator(cell: Cell, dev, log) -> None:
    """The caching allocator capped at the cell's budget, as on a card
    of that size."""
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = budget_bytes(cell)
    torch.cuda.set_per_process_memory_fraction(min(cap / total, 1.0), dev)
    log(f"device {torch.cuda.get_device_name(dev)}: allocator capped at "
        f"{cap / 2**20:.0f} of {total / 2**20:.0f} MiB")


def reference_module(cell: Cell):
    return importlib.import_module(f"references.{cell.config['reference']}")


def load_reader(name: str, directory: Path = PERFBENCH / "metrics"):
    """``metrics/<name>.py`` as a module (its ``read(run)``, maybe
    ``SPANS``)."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepRecord:
    ok: bool
    host_s: float
    lengths: List[int]
    loss: Optional[float] = None
    stats: object = None          # the trainer's StepStats when ok
    error: str = ""               # why a failed step failed


class Program:
    """The port's trainer for one cell, with the cell's weights."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.config import ModelConfig
        from repro_torch.core.planner import MimosePlanner
        from repro_torch.launch.roofline import PCIE_BW
        from repro_torch.models.lm import LM
        from repro_torch.optim.adamw import AdamW, cosine_schedule
        from repro_torch.train.resilience import OOMWatchdog
        from repro_torch.train.trainer import Trainer

        wl = cell.workload
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.spec = reference_module(cell).param_spec(cell.model)
        lm = LM(ModelConfig(**cell.model), attn_impl=ATTN_IMPL,
                device="meta")
        lm.to_empty(device=self.device)
        model_init.load_into(self.spec, dict(lm.named_parameters()), seed)
        planner = MimosePlanner(
            lm, budget_bytes(cell), quantum=cell.mix.quantum,
            mesh_budget=None, offload=False, opt_offload=False,
            pcie_gbps=PCIE_BW / 1e9, solver="off", **PLANNER)
        opt = AdamW(lr=cosine_schedule(OPTIMIZER["lr"],
                                       OPTIMIZER["warmup_steps"],
                                       OPTIMIZER["total_steps"]))
        self.watchdog = OOMWatchdog(max_retries=int(wl["max_oom_retries"]))
        self.trainer = Trainer(lm, planner, opt, watchdog=self.watchdog)
        self.opt_state = opt.init(self.trainer.params)
        self.is_oom = OOMWatchdog.is_oom

    def step(self, batch) -> StepRecord:
        lengths = [int(n) for n in batch["lengths"]]
        error = ""
        t0 = time.perf_counter()
        try:
            self.opt_state, loss = self.trainer.step(self.opt_state, batch)
        except RuntimeError as e:
            if not self.is_oom(e):
                raise
            error = f"{type(e).__name__}: {e}"[:400]
        host_s = time.perf_counter() - t0
        if error:
            # out of the except block, so the failed attempt's frames
            # are gone; then what it left on the device
            for p in self.trainer.params.values():
                p.grad = None
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            return StepRecord(False, host_s, lengths, error=error)
        return StepRecord(True, host_s, lengths, loss,
                          self.trainer.history[-1])

    def oom_events(self) -> int:
        return int(self.watchdog.stats["oom_events"])

    @torch.no_grad()
    def first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's gradient as the optimizer took it at step 1: its
        first moment over (1 - beta1)."""
        b1 = self.trainer.optimizer.b1
        m = self.opt_state.m
        norms = torch.stack([m[n].float().norm() for n in m])
        return {n: v / (1 - b1)
                for n, v in zip(m, norms.double().cpu().tolist())}

    @torch.no_grad()
    def update_norms(self) -> Dict[str, float]:
        """Each leaf's change since the seeded start, the start drawn
        again group by group."""
        params = self.trainer.params
        out = {}
        for part in model_init.stream(self.spec, self.seed, self.device):
            for n, t in part.items():
                out[n] = float((params[n].float() - t.float()).norm())
        return out

    def close(self) -> None:
        self.trainer = self.opt_state = self.watchdog = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def warmup(prog: Program, batches: List[dict], log,
           stop_after: Optional[int] = None) -> dict:
    """Run the warm-up stream (up to ``stop_after`` steps that ran);
    read the program's side of the check over its first
    ``CHECKED_STEPS`` steps that ran.  Returns
    ``{"steps": [StepRecord], "checked": [index], "program": {...}}``."""
    records, checked, losses = [], [], []
    grad_norms = update_norms = None
    for i, batch in enumerate(batches):
        rec = prog.step(batch)
        records.append(rec)
        log(f"warm-up {i}: bucket {batch['tokens'].shape[1]} "
            f"{'ok' if rec.ok else 'FAILED'} {rec.host_s:.3f} s"
            + (f" loss {rec.loss:.6f} remat {rec.stats.remat_units} "
               f"k {rec.stats.microbatches} peak "
               f"{rec.stats.max_memory_bytes / 2**20:.1f} MiB predicted "
               f"{rec.stats.predicted_peak_bytes / 2**20:.1f} MiB"
               if rec.ok else f" ({rec.error})"))
        if rec.ok and len(checked) < CHECKED_STEPS:
            checked.append(i)
            losses.append(rec.loss)
            if len(checked) == 1:
                grad_norms = prog.first_grad_norms()
            if len(checked) == CHECKED_STEPS:
                update_norms = prog.update_norms()
        if stop_after is not None and len(checked) >= stop_after:
            break
    return {"steps": records, "checked": checked,
            "program": {"losses": losses, "grad_norms": grad_norms,
                        "update_norms": update_norms}}


def reference_readings(cell: Cell, seed: int, batches: List[dict], device,
                       precision: str = "fp32", half_batch: bool = False
                       ) -> dict:
    ref = reference_module(cell)
    spec = ref.param_spec(cell.model)
    refcore.fp32_matmuls()
    return refcore.follow_steps(
        ref, cell.model, lambda: model_init.weights(spec, seed, device),
        batches, OPTIMIZER, precision, device,
        half_batch=half_batch)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    cell: Cell
    seconds: int
    setup_s: float
    window_s: float
    window: List[StepRecord]
    oom_events: int               # the watchdog's, during the window
    peak_bytes: int               # the allocator's peak over the window
    trace: Optional[tr.TraceData] = None
    stretch: List[StepRecord] = dataclasses.field(default_factory=list)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell: Cell, *, seed: int, seconds: int, trace: bool, t0: float,
        device="cuda", log=None, faults=None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, maybe ``breakdown``, and
    ``checks``).  ``faults`` (tests only) patches the program before
    set-up: a callable run with the ``Program``."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    wl, model = cell.workload, cell.model
    if cuda:
        cap_allocator(cell, dev, log)

    tb = time.perf_counter()
    prog = Program(cell, seed, dev)
    log(f"process start to the program's build {tb - t0:.3f} s; the "
        f"model with its weights {time.perf_counter() - tb:.3f} s")
    if faults is not None:
        faults(prog)
    warm_batches = cell.mix.warmup_batches(seed, model["vocab_size"])
    warm = warmup(prog, warm_batches, log)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_peak = max([r.stats.max_memory_bytes for r in warm["steps"]
                      if r.ok] + [0])

    # -- the window ------------------------------------------------------
    cycles = cell.mix.window_batches(seed, model["vocab_size"])
    oom0 = prog.oom_events()
    window: List[StepRecord] = []
    tw = time.perf_counter()
    setup_s = tw - t0
    while True:
        for batch in next(cycles):
            window.append(prog.step(batch))
        if time.perf_counter() - tw >= seconds:
            break
    window_s = time.perf_counter() - tw
    oom_window = prog.oom_events() - oom0
    peak = max([r.stats.max_memory_bytes for r in window if r.ok] + [0])
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    rec = RunRecord(cell, seconds, setup_s, window_s, window, oom_window,
                    int(peak))
    log(f"set-up {setup_s:.3f} s; window {window_s:.3f} s, "
        f"{len(window)} steps, {sum(not r.ok for r in window)} failed")
    log("window steps (longest row:ms): " + " ".join(
        f"{max(r.lengths)}:{r.host_s * 1e3:.0f}" for r in window))
    for i, r in enumerate(window):
        if not r.ok:
            log(f"window step {i} (bucket {max(r.lengths)}) failed: "
                f"{r.error}")

    # -- the traced stretch ------------------------------------------------
    readers = {m["name"]: load_reader(m["name"]) for m in cell.metrics
               if m["kind"] == ("per_layer" if trace else "end_to_end")}
    if trace:
        spans = {}
        for r in readers.values():
            spans.update(getattr(r, "SPANS", {}))
        tt = time.perf_counter()
        rec.stretch, rec.trace = _traced_stretch(prog, next(cycles), spans,
                                                 int(wl["trace_steps"]), dev)
        log(f"traced stretches ({time.perf_counter() - tt:.1f} s with the "
            f"reading): {len(rec.stretch)} steps, window "
            f"{rec.trace.window_s:.3f} s, busy {rec.trace.busy_s:.3f} s, "
            f"{rec.trace.n_device_events} device events, by span "
            f"{rec.trace.tagged_s}, {len(rec.trace.calls)} calls")

    # -- the program's state freed; the reference ----------------------------
    memory_peak = max(setup_peak, int(peak))
    checked = [warm_batches[i] for i in warm["checked"]]
    prog.close()
    del prog
    if cuda:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    if len(checked) < CHECKED_STEPS:
        numbers = {k: {"value": float("inf")}
                   for k in ("loss_gap", "grad_gap", "update_gap")}
    else:
        tref = time.perf_counter()
        ref = reference_readings(cell, seed, checked, dev)
        numbers = check.compare(warm["program"], ref)
        log(f"reference: {time.perf_counter() - tref:.3f} s; losses "
            f"program {warm['program']['losses']} reference {ref['losses']}")
    correct, checks = check.judge(numbers, wl.get("checks", {}))
    for name, d in numbers.items():
        if "leaf" in d:
            checks[name]["leaf"] = d["leaf"]

    metrics = {}
    for m in cell.metrics:
        if m["name"] not in readers:
            continue
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct),
           "attempted": len(window),
           "failed": sum(not r.ok for r in window),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if cuda
                               else dev.type),
                      "count": 1,
                      "memory_peak_bytes": int(memory_peak)}}
    if trace:
        out["device"]["busy_s"] = rec.trace.busy_s
        out["device"]["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.device_ops,
                            "idle_gaps": rec.trace.idle_gaps}
    out["checks"] = checks
    return out


def _traced_stretch(prog: Program, cycle, spans, n_steps: int, dev):
    """Two stretches of ``n_steps`` of the next cycle's batches: the
    first traced on the device only, the second with the host's events
    and the spans' patches on.  Returns (the first's steps, TraceData)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = dev.type == "cuda"
    device_only = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    if 2 * n_steps > len(cycle):
        raise ValueError(f"trace_steps {n_steps}: the two stretches need "
                         f"{2 * n_steps} of the cycle's {len(cycle)} batches")
    steps = []
    with profile(activities=device_only) as prof:
        t = time.perf_counter()
        tr.mark_edge(dev)
        for batch in cycle[:n_steps]:
            steps.append(prog.step(batch))
        tr.mark_edge(dev)
        host_s = time.perf_counter() - t
    window_s, clock, busy_s, device_ops, n_events = tr.busy(prof, host_s)
    with tr.SpanPatch(spans) as patch:
        with profile(activities=[ProfilerActivity.CPU] + device_only[
                :int(cuda)]) as prof:
            with record_function(tr.STRETCH):
                for batch in cycle[n_steps:2 * n_steps]:
                    with record_function(tr.STEP):
                        prog.step(batch)
    tagged, tag_ops, idle = tr.spans(prof)
    print(f"device time by span: {tag_ops}; device-only stretch "
          f"{window_s:.4f} s on the {clock} clock, {host_s:.4f} s on the "
          f"host's", file=sys.stderr, flush=True)
    return steps, tr.TraceData(window_s=window_s, busy_s=busy_s,
                               tagged_s=tagged, calls=patch.calls,
                               device_ops=device_ops, idle_gaps=idle,
                               n_device_events=n_events)
