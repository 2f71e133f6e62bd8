"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs``, and its wiring into the port's planner, solver, trainer,
transfer lane and launcher.

The same calls through both packages give the same metrics snapshot,
the same Prometheus text, the same event records (timestamps aside)
and the same trace structure (names, phases, tracks, args; times
aside) — counterparts of ``tests/test_obs.py``.  The wiring tests run
the port's trainer on the CPU at reduced size: the planner's ``stats``
is a ``StatsView`` with the keys the earlier tests read, the drift
series agrees with the refit trigger, every sink is written, and the
losses are bitwise equal with every sink on and off (the reference's
promise, ``launch/train.py:131-132``).
"""
import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro.obs as ref_obs
import repro_torch.obs as port_obs
import repro_torch.obs.tracing as port_tracing
from repro_torch.actions import Action
from repro_torch.core.planner import MimosePlanner, PlanInfo, PlannerBase
from repro_torch.core.scheduler import Plan
from repro_torch.data.pipeline import make_batches, top_buckets
from repro_torch.launch import train as launch_train
from repro_torch.launch.report import drift_table, engine_report
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.obs import (NULL_SPAN, PROFILER_PREFIX, SCHEMA_VERSION,
                             EventLog, MetricsRegistry, NullEventLog,
                             NullTracer, SpanTracer, StatsView, Telemetry,
                             TRACK_PLANNER, TRACK_SOLVER, TRACK_STEP,
                             TRACK_TRANSFER, build_telemetry,
                             flush_telemetry, read_events)
from repro_torch.optim.adamw import AdamW
from repro_torch.train.resilience import FaultInjector, OOMWatchdog
from repro_torch.train.trainer import Trainer

SMALL = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=256,
             dtype="float32")


# ---------------------------------------------------------------------------
# the same calls through both packages
# ---------------------------------------------------------------------------

def _drive_metrics(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("c", "help c")
    c.inc(2, bucket=64)
    c.inc(1.5)
    g = reg.gauge("g", "a gauge")
    g.set(3.0, bucket=128)
    g.set_max(2.0, bucket=128)
    g.set_max(7.0, bucket=256)
    h = reg.histogram("h")
    for v in (0.5, 2e-5, 30.0, 0.003):
        h.observe(v)
    h.observe(0.05, bucket=64)
    sv = obs.StatsView(reg, scalars={"hits": "plan_cache_hits",
                                     "t_s": "collect_time_s"},
                       labeled={"by": ("train_oom_events", "bucket")})
    sv["hits"] += 3
    sv["t_s"] += 0.25
    sv.inc("by", bucket=480)
    sv["free"] = {"a": 1}
    return reg, sv


def test_metrics_snapshot_and_prometheus_match_reference():
    ref, ref_sv = _drive_metrics(ref_obs)
    port, sv = _drive_metrics(port_obs)
    assert port.snapshot() == ref.snapshot()
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.to_json(indent=2) == ref.to_json(indent=2)
    assert dict(sv) == dict(ref_sv)
    assert sv["hits"] == 3 and isinstance(sv["hits"], int)
    assert sv["t_s"] == 0.25 and dict(sv["by"]) == {480: 1}


def _drive_events(obs, path):
    with obs.EventLog(capacity=4, path=path) as log:
        log.emit("plan", bucket=np.int64(128), source="greedy",
                 est=np.array([1.0, 2.0]))
        log.emit("drift", bucket=128, rel_err=0.25, refit=True)
        for i in range(6):
            log.emit("tick", i=i)
        ring = log.tail()
    return ring, list(obs.read_events(path))


def test_event_records_match_reference(tmp_path):
    ref_ring, ref_recs = _drive_events(ref_obs, str(tmp_path / "r.jsonl"))
    ring, recs = _drive_events(port_obs, str(tmp_path / "p.jsonl"))

    def strip(rs):
        return [{k: v for k, v in r.items() if k != "ts"} for r in rs]
    assert strip(recs) == strip(ref_recs) and len(recs) == 8
    assert strip(ring) == strip(ref_ring) and len(ring) == 4
    assert recs[0]["bucket"] == 128 and recs[0]["est"] == [1.0, 2.0]
    assert all(r["v"] == SCHEMA_VERSION == ref_obs.SCHEMA_VERSION
               for r in recs)
    assert [r["i"] for r in port_obs.read_events(
        str(tmp_path / "p.jsonl"), kind="tick")] == list(range(6))


def _drive_trace(obs):
    tr = obs.SpanTracer()
    with tr.span("plan", obs.TRACK_STEP, args={"bucket": 128}):
        pass
    tr.complete("execute", 1.0, 0.5, obs.TRACK_STEP)
    tr.complete("copy_d2h", 1.1, 0.01, obs.TRACK_TRANSFER,
                args={"bytes": 4})
    tr.instant("refit", obs.TRACK_PLANNER, args={"bucket": 128})
    with tr.span("solve", obs.TRACK_SOLVER):
        pass
    return json.loads(tr.to_json())


def test_trace_structure_matches_reference():
    ref, port = _drive_trace(ref_obs), _drive_trace(port_obs)

    def shape(doc):
        return [{k: v for k, v in e.items()
                 if k not in ("ts", "dur", "pid")}
                for e in doc["traceEvents"]]
    assert shape(port) == shape(ref)
    assert port["displayTimeUnit"] == "ms"
    ex = next(e for e in port["traceEvents"] if e["name"] == "execute")
    assert ex["ts"] == pytest.approx(1.0e6) and ex["dur"] == pytest.approx(
        0.5e6)
    assert [(k, getattr(port_obs, k)) for k in dir(port_obs)
            if k.startswith("TRACK_")] == [
        (k, getattr(ref_obs, k)) for k in dir(ref_obs)
        if k.startswith("TRACK_")]


# ---------------------------------------------------------------------------
# counterparts of tests/test_obs.py on the port
# ---------------------------------------------------------------------------

def test_registry_snapshot_under_concurrent_writers():
    reg = MetricsRegistry()
    c = reg.counter("hits", "test counter")
    h = reg.histogram("lat", "test histogram")
    N, K = 8, 2000

    def worker(i):
        for _ in range(K):
            c.inc()
            c.inc(1.0, bucket=i % 2)
            h.observe(0.001 * (i + 1))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value() == N * K
    assert c.value(bucket=0) == c.value(bucket=1) == (N // 2) * K
    assert c.total() == 2 * N * K and h.total() == N * K
    assert reg.snapshot()["hits"]["total"] == 2 * N * K


def test_statsview_mapping_and_adopt_merge():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    a = StatsView(r1, scalars={"oom_events": "oom_total"},
                  labeled={"by_bucket": ("oom_total", "bucket")})
    b = StatsView(r2, scalars={"oom_events": "oom_total"})
    a.inc("oom_events", bucket=128)
    b.inc("oom_events")
    b.attach(r1)
    assert a["oom_events"] == b["oom_events"] == 2
    assert a.metric("oom_events") is b.metric("oom_events")
    assert dict(a["by_bucket"]) == {128: 1}
    c = StatsView(r1, scalars={"retries": "retry_total"})
    c["retries"] = 7
    c["retries"] += 1
    assert c["retries"] == 8
    a["free_form"] = [1, 2]
    assert dict(a)["free_form"] == [1, 2]
    with pytest.raises(TypeError):
        a["by_bucket"] = {}


def test_event_log_skips_malformed_lines(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with EventLog(path=path) as log:
        log.emit("a")
    with open(path, "a") as f:
        f.write("not json\n")
        f.write(json.dumps({"v": 1, "ts": 0, "kind": "b"}) + "\n")
    assert [r["kind"] for r in read_events(path)] == ["a", "b"]


def test_tracer_capacity_bounded():
    tr = SpanTracer(capacity=5)
    for i in range(50):
        tr.complete(f"s{i}", 0.0, 0.001, TRACK_STEP)
    assert len([e for e in tr.events() if e["ph"] == "X"]) <= 5


def test_disabled_telemetry_is_noop():
    tel = Telemetry.disabled()
    assert not tel.events_on and not tel.trace_on
    assert isinstance(tel.events, NullEventLog)
    assert isinstance(tel.tracer, NullTracer)
    assert tel.tracer.span("plan") is NULL_SPAN
    assert tel.tracer.span("execute", TRACK_STEP, args={"k": 1}) is NULL_SPAN
    tel.events.emit("anything", x=1)
    assert len(tel.events) == 0
    tel.close()


def test_build_and_flush_telemetry(tmp_path):
    mp, ep, tp = (str(tmp_path / n) for n in ("m.json", "e.jsonl",
                                              "t.json"))
    tel = build_telemetry(metrics_path=mp, events_path=ep, trace_path=tp)
    assert tel.events_on and tel.trace_on
    tel.metrics.counter("n").inc(3)
    tel.events.emit("x")
    with tel.tracer.span("s", TRACK_STEP):
        pass
    assert flush_telemetry(tel) == {"metrics": mp, "events": ep,
                                    "trace": tp}
    assert json.load(open(mp))["n"]["total"] == 3
    assert [r["kind"] for r in read_events(ep)] == ["x"]
    assert json.load(open(tp))["traceEvents"]
    prom = str(tmp_path / "m.prom")
    tel2 = build_telemetry(metrics_path=prom)
    tel2.metrics.counter("n").inc(2)
    flush_telemetry(tel2)
    assert "# TYPE n counter" in open(prom).read()
    off = build_telemetry()
    assert not off.events_on and not off.trace_on
    assert flush_telemetry(off) == {}


# ---------------------------------------------------------------------------
# wiring: planner, solver, trainer, launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    return LM(get_config("bert_base_paper").reduced(**SMALL), device="cpu")


def _batch(S, B=2):
    t = torch.ones((B, S), dtype=torch.long)
    return {"tokens": t, "labels": t}


def test_planner_stats_is_a_statsview_with_the_reference_keys(lm):
    pl = MimosePlanner(lm, 1e12, quantum=8, warmup_samples=1)
    assert isinstance(pl.stats, StatsView)
    pl.plan(_batch(32))
    pl.plan(_batch(32))
    st = pl.stats
    assert (st["cache_hits"], st["cache_misses"], st["collections"]) == \
        (1, 1, 1)
    for key in ("collect_time_s", "estimate_time_s", "schedule_time_s",
                "audits", "refits", "evictions", "solves", "solver_swaps",
                "solver_wins", "solver_timeouts", "offload_fallbacks"):
        assert key in st
    assert isinstance(st["cache_hits"], int)
    assert isinstance(st["collect_time_s"], float)
    tel = Telemetry()
    pl.bind_telemetry(tel)
    assert tel.metrics.get("plan_cache_hits").total() == 1
    pl.plan(_batch(32))
    assert tel.metrics.get("plan_cache_hits").total() == 2


def test_drift_series_matches_refit_trigger(lm):
    """Every ``drift`` event satisfies refit == (rel_err > AUDIT_TOL),
    and the gauges carry the latest point per bucket."""
    from repro_torch.core.planner import AUDIT_TOL
    tel = Telemetry.enabled()
    pl = MimosePlanner(lm, 1e12, warmup_samples=2, quantum=8,
                       audit_every=1, telemetry=tel)
    for S in (32, 48):
        pl.plan(_batch(S))
    pl.estimator.fit()
    pl.estimator._coeffs = pl.estimator._coeffs * 3.0
    pl.plan(_batch(96))
    drifts = tel.events.tail(100, kind="drift")
    assert drifts and any(d["refit"] for d in drifts)
    for d in drifts:
        assert d["refit"] == (d["rel_err"] > AUDIT_TOL)
    assert pl.stats["refits"] == sum(d["refit"] for d in drifts)
    last = drifts[-1]
    assert tel.metrics.get("plan_predicted_peak_bytes").value(
        bucket=last["bucket"]) == last["predicted_bytes"]
    assert tel.metrics.get("plan_actual_peak_bytes").value(
        bucket=last["bucket"]) == last["actual_bytes"]
    assert tel.events.tail(kind="refit")
    rows = drift_table(tel.metrics.snapshot())
    assert rows and rows[1].startswith("| bucket S")


def test_solver_traces_solve_spans_and_swap_instants(lm):
    tel = Telemetry(tracer=SpanTracer(), events=EventLog())
    pl = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1,
                       max_microbatches=2, solver="dp", telemetry=tel)
    for S in (64, 64, 96, 96):
        pl.plan(_batch(S, B=4))
    assert pl.background_solver.drain(timeout=60.0)
    pl.background_solver.close()
    evs = tel.tracer.events()
    assert [e for e in evs if e["name"] == "solve" and e["ph"] == "X"
            and e["tid"] == TRACK_SOLVER]
    assert pl.stats["solves"] >= 1
    swaps = pl.stats["solver_swaps"]
    assert len([e for e in evs if e["name"] == "solver_swap"]) == swaps
    assert len(tel.events.tail(kind="solver_swap")) == swaps


def _train(telemetry, steps=4):
    """Four swag steps of the reduced bert under Mimose with offload, at
    a budget that makes the plans offload."""
    lm = LM(get_config("bert_base_paper").reduced(**SMALL), device="cpu")
    planner = MimosePlanner(lm, 3e6,
                            quantum=32, warmup_samples=2, offload=True)
    tr = Trainer(lm, planner, AdamW(lr=1e-3), telemetry=telemetry)
    tr.run(make_batches("swag", batch_size=2, vocab_size=256,
                        num_batches=steps, quantum=32, seed=0))
    return tr


def test_trainer_telemetry_end_to_end(tmp_path):
    ep, tp, mp = (str(tmp_path / n) for n in ("e.jsonl", "t.json",
                                              "m.json"))
    tel = build_telemetry(metrics_path=mp, events_path=ep, trace_path=tp)
    tr = _train(tel)
    flush_telemetry(tel)
    steps = [r for r in read_events(ep) if r["kind"] == "train_step"]
    assert len(steps) == 4
    for r in steps:
        assert {"step", "bucket", "loss", "plan_source", "n_offload",
                "exposed_transfer_s", "predicted_peak_bytes"} <= set(r)
    assert [r for r in read_events(ep) if r["kind"] == "plan"]
    assert [r for r in read_events(ep) if r["kind"] == "drift"]
    doc = json.load(open(tp))
    tracks = {(e["name"], e["tid"]) for e in doc["traceEvents"]
              if e["ph"] == "X"}
    assert {("plan", TRACK_STEP), ("execute", TRACK_STEP),
            ("collect", TRACK_PLANNER), ("schedule", TRACK_PLANNER)} \
        <= tracks
    assert any(t == TRACK_TRANSFER for _, t in tracks)
    assert tr.history[0].offload_units > 0
    m = json.load(open(mp))
    assert m["train_bucket_steps"]["total"] == 4
    assert m["transfer_bytes_out"]["total"] == m["transfer_bytes_in"][
        "total"] > 0
    assert tr.cache_stats["compiles"] >= 1
    assert sum(dict(tr.cache_stats["bucket_steps"]).values()) == 4
    assert tr.cache_stats["bucket_tokens"]
    rep = engine_report(tr, tr.planner)
    assert "| **total** | 4 |" in rep and "offload: exposed transfer" in rep
    assert "plan cache:" in rep and "predicted peak MB" in rep


def test_losses_bitwise_equal_with_sinks_on_and_off(tmp_path):
    on = build_telemetry(metrics_path=str(tmp_path / "m.json"),
                         events_path=str(tmp_path / "e.jsonl"),
                         trace_path=str(tmp_path / "t.json"))
    a = [s.loss for s in _train(on).history]
    flush_telemetry(on)
    b = [s.loss for s in _train(Telemetry.disabled()).history]
    assert a == b


def test_launcher_writes_every_sink_and_the_report(tmp_path, capsys):
    mp, ep, tp = (str(tmp_path / n) for n in ("m.prom", "e.jsonl",
                                              "t.json"))
    tr = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                            "--batch-size", "2", "--offload",
                            "--budget-mb", "26", "--prewarm", "2",
                            "--metrics", mp, "--events-out", ep,
                            "--trace-out", tp])
    out = capsys.readouterr().out
    assert "engine report" in out and "prewarmed 2 bucket(s)" in out
    for kind, path in (("metrics", mp), ("events", ep), ("trace", tp)):
        assert f"{kind} written to {path}" in out
    assert "# TYPE train_bucket_steps counter" in open(mp).read()
    assert {r["kind"] for r in read_events(ep)} >= {"plan", "train_step"}
    assert json.load(open(tp))["traceEvents"]
    assert tr.summary()["prewarm_compiles"] == 2


def test_top_buckets_is_the_references():
    from repro.data.pipeline import top_buckets as ref_top
    for ds in ("swag", "squad", "qqp"):
        assert top_buckets(ds, batch_size=8, quantum=32, k=4) == ref_top(
            ds, batch_size=8, quantum=32, k=4)


# ---------------------------------------------------------------------------
# spans on the profiler's clock
# ---------------------------------------------------------------------------

class _FixedPlanner(PlannerBase):
    """Serves one action plan (and split ``k``) for every batch."""

    def __init__(self, lm, actions, k=1):
        self.lm, self.actions, self.k, self.quantum = lm, actions, k, 32

    def plan(self, batch):
        p = Plan([], 0.0, 0.0, 0.0, actions=self.actions, microbatch=self.k)
        return p.as_actions(), PlanInfo(0, self.bucket_key(batch), True,
                                        False, p)


# a layer kept, two checkpointed and one sent to the host: three re-run
# in the backward (SMALL's four layers are four units, unrolled)
REMAT_PLAN = (Action.KEEP, Action.REMAT, Action.OFFLOAD, Action.REMAT)
SWAG = list(make_batches("swag", batch_size=2, vocab_size=256,
                         num_batches=3, quantum=32, seed=0))


def _fixed_trainer(telemetry=None, k=1):
    lm = LM(get_config("bert_base_paper").reduced(**SMALL), device="cpu")
    tr = Trainer(lm, _FixedPlanner(lm, REMAT_PLAN, k), AdamW(lr=1e-3),
                 telemetry=telemetry)
    return tr, tr.optimizer.init(tr.params)


def _profiled(fn):
    """``fn()`` under a CPU profile; returns the program's ranges as
    ``(span name, start ns, end ns)`` sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.name()[len(PROFILER_PREFIX):], e.start_ns(),
                   e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(PROFILER_PREFIX))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("k", [1, 2])
def test_step_spans_reach_the_profiler_where_the_work_happens(k):
    tr, st = _fixed_trainer(k=k)
    st, _ = tr.step(st, SWAG[0])            # the step function built
    ranges = _profiled(lambda: tr.step(st, SWAG[1]))
    by = {}
    for r in ranges:
        by.setdefault(r[0], []).append(r)
    assert set(by) == {"prepare", "plan", "execute", "forward", "backward",
                       "recompute", "update", "sync"}
    (prep,), (plan,), (ex,), (upd,), (sync,) = (
        by[n] for n in ("prepare", "plan", "execute", "update", "sync"))
    assert prep[2] <= plan[1] and plan[2] <= ex[1]
    fwd, bwd = by["forward"], by["backward"]
    assert len(fwd) == len(bwd) == k
    # forward, backward (microbatch by microbatch), update, sync: in
    # order, each inside execute
    order = [r for pair in zip(fwd, bwd) for r in pair] + [upd, sync]
    assert all(_inside(r, ex) for r in order)
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    # one range per re-run layer, each inside a backward, none in a
    # forward
    rec = by["recompute"]
    assert len(rec) == k * tr.history[-1].recompute_layers == k * 3
    assert all(any(_inside(r, b) for b in bwd) for r in rec)
    assert not any(f[1] <= r[1] <= f[2] for r in rec for f in fwd)


def test_a_retried_step_traces_its_oom_recovery():
    lm = LM(get_config("bert_base_paper").reduced(**SMALL), device="cpu")
    planner = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1)
    tr = Trainer(lm, planner, AdamW(lr=1e-3), watchdog=OOMWatchdog(
        max_retries=2, injector=FaultInjector("1")))
    st = tr.optimizer.init(tr.params)
    ranges = _profiled(lambda: tr.step(st, SWAG[0]))
    names = [r[0] for r in ranges]
    assert names.count("execute") == 2 and names.count("plan") == 2
    # booked inside the except block, then freed and re-planned out of
    # it, both between the failed execution and the retry
    book, recover = [r for r in ranges if r[0] == "oom_recover"]
    first, second = [r for r in ranges if r[0] == "execute"]
    replan = [r for r in ranges if r[0] == "plan"][1]
    assert first[2] <= book[1] and book[2] <= recover[1]
    assert recover[2] <= second[1] and _inside(replan, recover)
    assert tr.watchdog.stats["retry_successes"] == 1


def test_no_range_opens_without_a_profiler(monkeypatch):
    """Off, ``span()`` is the shared ``NULL_SPAN`` and nothing reaches
    the profiler's entry point, for a whole step with either tracer."""
    off = NullTracer()
    assert off.span("plan") is NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert off.span("plan") is not NULL_SPAN
    assert off.span("plan") is NULL_SPAN

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} opened")
    monkeypatch.setattr(port_tracing, "_RecordFunctionFast", refuse)
    for tel in (Telemetry.disabled(), Telemetry(tracer=SpanTracer())):
        tr, st = _fixed_trainer(tel)
        tr.step(st, SWAG[0])


def test_losses_bitwise_equal_with_the_profiler_on_and_off():
    def losses(profiled):
        tr, st = _fixed_trainer()
        run = lambda: tr.run(SWAG, st)
        _profiled(run) if profiled else run()
        return [s.loss for s in tr.history], tr.params["embed"].detach()
    (a, pa), (b, pb) = losses(True), losses(False)
    assert a == b and torch.equal(pa, pb)


def test_span_tracer_writes_the_profilers_span_names_on_the_step_track():
    """Also when the tracer is switched on after the step was built."""
    tel = Telemetry.disabled()
    tr, st = _fixed_trainer(tel)
    st, _ = tr.step(st, SWAG[0])
    tel.tracer, tel.trace_on = SpanTracer(), True

    def run():
        s = st
        for b in SWAG[1:]:
            s, _ = tr.step(s, b)
    ranges = Counter(r[0] for r in _profiled(run))
    chrome = Counter(e["name"] for e in tel.tracer.events()
                     if e["ph"] == "X" and e["tid"] == TRACK_STEP
                     and e["name"] != "build_step")     # a complete()
    assert chrome == ranges and ranges["recompute"] == 6
