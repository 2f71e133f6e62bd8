"""The port's resilience path against the reference's: checkpoint files,
fault injection, OOM classification, snapshots, the planner state, the
escalation ladder, and the trainer's retry loop and kill-and-resume.

CPU, reduced ``bert_base_paper`` (2 layers, d 64).  Where the reference
has a counterpart the port is held against it: the fault injector's
fail sequences exactly, the planner state and the escalation ladder on
the same stub-collected vectors (``StubCollector`` of
``tests/test_torch_baselines.py``, constants pinned by
``tests/torch_pins.py``) exactly, and the resumed run's losses within
``test_torch_train``'s tolerance (rtol 2e-5) of the reference's own
kill-and-resume.  The port's own runs are held bitwise: a resumed run
against an uninterrupted one, and a step that recovered from an OOM
against a run of the escalated plan.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.planner import MimosePlanner as RefMimose
from repro.data.pipeline import make_batches as jax_make_batches
from repro.launch.roofline import plan_unit_flops as ref_flops
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train.resilience import FaultInjector as RefInjector
from repro.train.resilience import OOMWatchdog as RefWatchdog
from repro.train.resilience import SnapshotManager as RefSnapshots
from repro.train.resilience import planner_state as ref_planner_state
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch import bridge
from repro_torch.actions import Action
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.core.planner import (MimosePlanner, NonePlanner, PlanInfo,
                                      PlannerBase, fixed_train_bytes)
from repro_torch.core.scheduler import Plan
from repro_torch.data.pipeline import make_batches
from repro_torch.launch import train as launch_train
from repro_torch.launch.report import engine_report
from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train import checkpoint
from repro_torch.train.checkpoint import CheckpointError
from repro_torch.train.resilience import (FaultInjector, OOMWatchdog,
                                          Restored, SimulatedOOM,
                                          SnapshotError, SnapshotManager,
                                          planner_state,
                                          restore_planner_state)
from repro_torch.train.trainer import Trainer
from test_torch_baselines import FIXED, N_UNITS, SIZES, StubCollector
from test_torch_baselines import REDUCED as STUB_REDUCED
from torch_pins import pin_reference_constants

pytestmark = pytest.mark.resilience

REDUCED = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
               dtype="float32")
HBM = float(1 << 30)          # roomy budget: plans stay all-KEEP
RTOL = 2e-5                   # tests/test_torch_train.py's


def _lm(seed=0):
    return LM(get_config("bert_base_paper").reduced(**REDUCED),
              device="cpu", seed=seed)


def _batch(S, B=2):
    return {"tokens": np.ones((B, S), np.int32),
            "labels": np.ones((B, S), np.int32)}


def _batches(n, B=2, seed=0):
    return list(make_batches("swag", batch_size=B, vocab_size=256,
                             num_batches=n, quantum=64, seed=seed))


def _params(tr):
    return {n: p.detach().clone() for n, p in tr.params.items()}


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's bitwise comparisons need a fixed
    summation order (as tests/test_torch_offload.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FixedPlanner(PlannerBase):
    """Serves one action plan (and split ``k``) for every batch."""

    def __init__(self, lm, actions, k=1, quantum=64):
        self.lm, self.actions, self.k, self.quantum = lm, actions, k, quantum

    def plan(self, batch):
        p = Plan([], 0.0, 0.0, 0.0, actions=self.actions, microbatch=self.k)
        return p.as_actions(), PlanInfo(0, self.bucket_key(batch), True,
                                        False, p)


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_params_and_adamw_state(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    p = str(tmp_path / "p.ckpt")
    checkpoint.save(p, tree)
    back = checkpoint.load(p, {k: torch.zeros_like(v)
                               for k, v in tree.items()})
    _assert_same(back, tree)
    st = AdamWState(7, {"w": torch.full((2, 3), 0.5)},
                    {"w": torch.full((2, 3), 0.25)})
    o = str(tmp_path / "o.ckpt")
    checkpoint.save(o, st)
    got = checkpoint.load(o, AdamW().init({"w": tree["w"]}))
    assert isinstance(got, AdamWState) and got.step == 7
    _assert_same(got.m, st.m)
    _assert_same(got.v, st.v)
    assert not os.path.exists(o + ".tmp")         # the tmp file was renamed


def test_checkpoint_loaded_leaves_are_writable_copies(tmp_path):
    p = str(tmp_path / "t.ckpt")
    like = {"w": torch.zeros(4)}
    checkpoint.save(p, {"w": torch.ones(4)})
    back = checkpoint.load(p, like)
    back["w"].add_(1.0)                           # writable, no alias
    assert torch.equal(back["w"], torch.full((4,), 2.0))
    assert torch.equal(like["w"], torch.zeros(4))
    assert torch.equal(checkpoint.load(p, like)["w"], torch.ones(4))


@pytest.mark.parametrize("like,match", [
    ({"emb": torch.ones((2, 2), dtype=torch.int32)}, "dtype mismatch.*emb"),
    ({"emb": torch.ones((3, 2))}, "shape mismatch.*emb"),
    ({"other": torch.ones((2, 2))}, "key mismatch.*other"),
])
def test_checkpoint_mismatch_names_the_leaf(tmp_path, like, match):
    p = str(tmp_path / "t.ckpt")
    checkpoint.save(p, {"emb": torch.ones((2, 2))})
    with pytest.raises(CheckpointError, match=match):
        checkpoint.load(p, like)


def test_checkpoint_truncated_file(tmp_path):
    p = str(tmp_path / "t.ckpt")
    checkpoint.save(p, {"w": torch.ones(64)})
    raw = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointError, match="not a readable"):
        checkpoint.load(p, {"w": torch.ones(64)})


# ---------------------------------------------------------------------------
# fault injection and OOM classification
# ---------------------------------------------------------------------------

CALLS = [(s, b) for s in range(8) for b in (64, 128)]


@pytest.mark.parametrize("spec", [
    "2", "0", '{"bucket": {"128": 1}, "step": {"5": 1}}',
    '{"step": {"0": 1, "3": 2}}', '{"bucket": {"64": 3}}',
    {"bucket": {128: 2}}, ("env", '{"step": {"2": 1}}'), ("env", ""),
    "not json {", "[1, 2]"])
def test_fault_injector_matches_reference(spec, monkeypatch):
    """The same fail sequence over the same (step, bucket) calls for
    every spec form (int, bucket / step JSON, a dict, the environment),
    and ValueError on garbage, in both packages."""
    def build(cls):
        if isinstance(spec, tuple):
            monkeypatch.setenv(cls.ENV, spec[1])
            return cls.from_env()
        return cls(spec)

    outs = []
    for cls in (RefInjector, FaultInjector):
        try:
            inj = build(cls)
        except ValueError:
            outs.append("ValueError")
            continue
        if inj is None:
            outs.append(None)
            continue
        seq = [inj.should_fail(step=s, bucket=b) for s, b in CALLS]
        outs.append((seq, inj.injected, inj.armed))
    assert outs[0] == outs[1]
    if spec in ("not json {", "[1, 2]"):
        assert outs[1] == "ValueError"
    assert FaultInjector.ENV == RefInjector.ENV == "MIMOSE_INJECT_OOM"


@pytest.mark.parametrize("err,oom", [
    (SimulatedOOM(0, 128), True),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 MiB"),
     True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: while allocating"), True),
    (ValueError("shape mismatch"), False),
    (RuntimeError("expected scalar type Float but found Half"), False),
    (KeyError("labels"), False),
    (MemoryError("out of memory"), False),
])
def test_watchdog_classifies_oom(err, oom):
    assert OOMWatchdog.is_oom(err) is oom
    if isinstance(err, SimulatedOOM):
        assert "RESOURCE_EXHAUSTED" in str(err)


# ---------------------------------------------------------------------------
# snapshots (the reference's assertions, tests/test_resilience.py)
# ---------------------------------------------------------------------------

def _tiny_state():
    return ({"w": torch.arange(4, dtype=torch.float32)},
            {"m": torch.zeros(4)})


def test_snapshot_roundtrip_and_manifest(tmp_path):
    params, opt = _tiny_state()
    sm = SnapshotManager(str(tmp_path), every_steps=5, keep=3)
    path = sm.save(step=5, params=params, opt_state=opt, data_cursor=5)
    man = json.load(open(os.path.join(path, sm.MANIFEST)))
    assert set(man["files"]) >= {"params.ckpt", "opt.ckpt", "meta.json"}
    r = sm.restore_latest(params_like={"w": torch.zeros(4)}, opt_like=opt)
    assert isinstance(r, Restored)
    assert r.step == 5 and r.data_cursor == 5
    _assert_same(r.params, params)


def test_snapshot_due_cadence(tmp_path):
    sm = SnapshotManager(str(tmp_path), every_steps=4)
    assert [s for s in range(1, 9) if sm.due(s)] == [4, 8]
    sm2 = SnapshotManager(str(tmp_path), every_steps=0, every_secs=0.0)
    assert not any(sm2.due(s) for s in range(1, 9))
    sm3 = SnapshotManager(str(tmp_path), every_secs=1e-9)
    assert sm3.due(1)        # the wall-clock trigger fires at once


def test_snapshot_retention(tmp_path):
    params, opt = _tiny_state()
    sm = SnapshotManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        sm.save(step=step, params=params, opt_state=opt)
    snaps = sm.snapshots()
    assert len(snaps) == 2
    assert snaps[-1].endswith("snap-00000004")
    assert sm.written == 4


def test_restore_skips_corrupt_snapshot(tmp_path):
    params, opt = _tiny_state()
    sm = SnapshotManager(str(tmp_path), keep=3)
    sm.save(step=1, params=params, opt_state=opt, data_cursor=1)
    good = params["w"].clone()
    newest = sm.save(step=2, params={"w": params["w"] * 7.0},
                     opt_state=opt, data_cursor=2)
    target = os.path.join(newest, "params.ckpt")
    raw = bytearray(open(target, "rb").read())
    raw[-1] ^= 0xFF
    with open(target, "wb") as f:
        f.write(bytes(raw))
    r = sm.restore_latest(params_like=params, opt_like=opt)
    assert r.step == 1        # fell back past the corrupt snap-2
    assert torch.equal(r.params["w"], good)


def test_restore_ignores_partial_tmp_dir(tmp_path):
    params, opt = _tiny_state()
    sm = SnapshotManager(str(tmp_path))
    sm.save(step=1, params=params, opt_state=opt)
    os.makedirs(str(tmp_path / ".tmp-snap-00000009"))  # a crash mid-save
    assert len(sm.snapshots()) == 1
    assert sm.restore_latest(params_like=params, opt_like=opt).step == 1


def test_restore_empty_dir_raises(tmp_path):
    sm = SnapshotManager(str(tmp_path))
    with pytest.raises(SnapshotError, match="no restorable snapshot"):
        sm.restore_latest(params_like={}, opt_like={})


# ---------------------------------------------------------------------------
# planner state and the escalation ladder against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stub_lms():
    jlm = build_model(jax_get_config("bert_base_paper").reduced(
        **STUB_REDUCED))
    lm = LM(get_config("bert_base_paper").reduced(**STUB_REDUCED),
            device="cpu")
    assert lm.num_plan_units() == jlm.num_plan_units() == N_UNITS
    return jlm, lm


def _stub_batches(S, B=8):
    # int32 tokens on both sides, so the sample logs' dtypes agree
    tokens = np.ones((B, S), np.int32)
    return ({"tokens": tokens, "labels": tokens},
            {"tokens": torch.ones((B, S), dtype=torch.int32),
             "labels": torch.ones((B, S), dtype=torch.int32)})


def _stub_pair(stub_lms, budget, max_mb=1):
    jlm, lm = stub_lms
    ref = RefMimose(jlm, budget, fixed_bytes=FIXED, quantum=32,
                    warmup_samples=3, max_microbatches=max_mb)
    ours = MimosePlanner(lm, budget, quantum=32, warmup_samples=3,
                         max_microbatches=max_mb)
    ours.fixed_bytes = FIXED
    ref.collector = StubCollector(jlm, ref_flops)
    ours.collector = StubCollector(lm, plan_unit_flops)
    for S in SIZES:
        jb, tb = _stub_batches(S)
        ref.plan(None, jb)
        ours.plan(tb)
    return ref, ours


def _stub_budget(stub_lms, frac):
    col = StubCollector(stub_lms[1], plan_unit_flops)
    act = col.collect(_stub_batches(max(SIZES))[1]).activation_vector()
    return FIXED + frac * float(act.sum())


@pytest.mark.parametrize("max_mb", [1, 4])
def test_planner_state_matches_reference(stub_lms, monkeypatch, max_mb):
    """On the same vectors the port's state is the reference's, the
    plan records apart from the port's sixth key element."""
    pin_reference_constants(monkeypatch)
    ref, ours = _stub_pair(stub_lms, _stub_budget(stub_lms, 0.2), max_mb)
    want, got = ref_planner_state(ref), planner_state(ours)
    assert json.loads(json.dumps(got)) == got        # JSON-able as is
    for key in ("version", "name", "mesh_sig", "estimators", "sample_log"):
        assert got[key] == want[key], key
    assert got["sample_log"] and len(got["plans"]) == len(want["plans"])
    for g, w in zip(sorted(got["plans"], key=lambda r: r["bucket"]),
                    sorted(want["plans"], key=lambda r: r["bucket"])):
        assert g.pop("accum_overhead_s") == ours.accum_overhead_s()
        assert g == w


@pytest.mark.parametrize("frac", [0.05, 0.5])
def test_escalation_ladder_matches_reference(stub_lms, monkeypatch, frac):
    """Every rung of one bucket's ladder gives the same actions and k
    in both packages, and the exhausted ladder returns False in both."""
    pin_reference_constants(monkeypatch)
    ref, ours = _stub_pair(stub_lms, _stub_budget(stub_lms, frac))
    jb, tb = _stub_batches(SIZES[2])
    rkey, key = ref.plan_key(jb), ours.plan_key(tb)
    rungs = 0
    while True:
        r_ok, ok = ref.escalate(None, jb), ours.escalate(tb)
        assert r_ok == ok
        if not ok:
            break
        rungs += 1
        rp, p = ref.cache[rkey], ours.cache[key]
        assert tuple(int(a) for a in rp.actions) == tuple(
            int(a) for a in p.actions), rungs
        assert rp.microbatch == p.microbatch and p.source == "escalated"
        assert ref._escalation[rkey] == ours._escalation[key] == rungs
    # rung 1, rung 2, then k = 2, 4, 8 (the batch size)
    assert rungs == 5 and ours.cache[key].microbatch == 8
    for k in ("escalations", "poisoned_plans"):
        assert ours.stats[k] == ref.stats[k] == 5, k
    assert ours.stats["escalations_by_bucket"] == {
        ours.bucket_key(tb): 5}
    assert PlannerBase.escalate(ours, tb) is False     # the baselines'


def test_planner_state_same_signature_roundtrip(stub_lms, monkeypatch):
    pin_reference_constants(monkeypatch)
    budget = _stub_budget(stub_lms, 0.2)
    _, src = _stub_pair(stub_lms, budget)
    jb, tb = _stub_batches(SIZES[2])
    src.escalate(tb)
    state = json.loads(json.dumps(planner_state(src)))
    dst = MimosePlanner(stub_lms[1], budget, quantum=32, warmup_samples=3)
    dst.fixed_bytes = FIXED
    dst.collector = StubCollector(stub_lms[1], plan_unit_flops)
    summary = restore_planner_state(dst, state)
    assert not summary["mesh_changed"]
    assert summary["restored_plans"] == len(state["plans"]) == len(src.cache)
    assert dst.estimator.num_samples == src.estimator.num_samples
    np.testing.assert_array_equal(dst.estimator.predict(8 * 100),
                                  src.estimator.predict(8 * 100))
    key = dst.plan_key(tb)
    assert dst._escalation[key] == 1
    assert dst.cache[key].source == "escalated"
    for S in SIZES:                   # every seen bucket is a cache hit
        dst.plan(_stub_batches(S)[1])
    assert dst.stats["cache_hits"] == len(SIZES)
    assert dst.stats["collections"] == dst.collector.calls == 0
    assert dst.stats["restored_plans"] == summary["restored_plans"]


def test_planner_state_drops_roofline_mismatched_plans(stub_lms, monkeypatch):
    """A plan priced at another link rate, overlap or accumulation
    overhead is dropped; matching knobs restore it; a record without
    the fields takes the live values."""
    pin_reference_constants(monkeypatch)
    budget = _stub_budget(stub_lms, 0.2)
    _, src = _stub_pair(stub_lms, budget)
    state = planner_state(src)
    n = len(state["plans"])
    assert n and state["plans"][0]["plan"]["source"] == "greedy"

    def dst(**kw):
        return MimosePlanner(stub_lms[1], budget, quantum=32,
                             warmup_samples=3, **kw)
    for kw in ({"pcie_gbps": 4.0}, {"offload_overlap": 0.25},
               {"microbatch_overhead_s": 1e-3}):
        summary = restore_planner_state(dst(**kw), state)
        assert summary["restored_plans"] == 0, kw
        assert summary["dropped_plans"] == n, kw
    assert restore_planner_state(dst(), state)["restored_plans"] == n
    for rec in state["plans"]:
        for k in ("pcie_gbps", "offload_overlap", "accum_overhead_s"):
            del rec[k]
    summary = restore_planner_state(dst(pcie_gbps=4.0), state)
    assert summary["restored_plans"] == n


def test_planner_state_signature_change_replays_the_log():
    """A stored signature other than the live ``()`` replays the sample
    log through the live meta collector and drops every plan."""
    lm = _lm()
    src = MimosePlanner(lm, HBM, quantum=64, warmup_samples=2)
    for S in (64, 128, 192):
        src.plan({"tokens": torch.ones((2, S), dtype=torch.long),
                  "labels": torch.ones((2, S), dtype=torch.long)})
    state = planner_state(src)
    assert state["mesh_sig"] == "()" and len(state["sample_log"]) == 2
    state["mesh_sig"] = "(('data', 2),)"
    for rec in state["plans"]:
        rec["mesh_sig"] = state["mesh_sig"]
    dst = MimosePlanner(lm, HBM, quantum=64, warmup_samples=2)
    summary = restore_planner_state(dst, state)
    assert summary["mesh_changed"]
    assert summary["restored_samples"] == 2
    assert summary["restored_plans"] == 0
    assert summary["dropped_plans"] == len(state["plans"]) == 3
    assert dst.estimator.ready and len(dst.cache) == 0
    np.testing.assert_allclose(dst.estimator.predict(2 * 320),
                               src.estimator.predict(2 * 320), rtol=1e-9)
    assert dst._sample_log == src._sample_log


def test_baseline_planner_state_is_a_stub(stub_lms):
    """A Sublinear run snapshots: its state is the name-only stub (it
    has an estimator but no plan cache to restore).  The reference's
    ``planner_state`` raises on the same planner (ROADMAP, faults in the
    reference)."""
    from repro.core.baselines import SublinearPlanner as RefSublinear
    from repro_torch.core.baselines import SublinearPlanner
    jlm, lm = stub_lms
    with pytest.raises(AttributeError, match="cache"):
        ref_planner_state(RefSublinear(jlm, HBM, max_input_size=1024))
    planner = SublinearPlanner(lm, HBM, max_input_size=1024)
    state = planner_state(planner)
    assert state == {"version": 1, "name": "sublinear"}
    assert restore_planner_state(planner, state)["restored_plans"] == 0


@pytest.mark.parametrize("planner", ["mimose", "dtr"])
def test_record_oom_books_the_bucket(planner):
    """``record_oom`` books into a ``StatsView`` (Mimose: the registry's
    ``train_oom_events``) or a plain dict (DTR), per bucket."""
    from repro_torch.core.baselines import DTRSimPlanner
    lm = _lm()
    p = (MimosePlanner(lm, HBM) if planner == "mimose"
         else DTRSimPlanner(lm, HBM))
    for b in (128, 128, 256):
        p.record_oom(b)
    assert p.stats["oom_events"] == 3
    assert dict(p.stats["oom_by_bucket"]) == {128: 2, 256: 1}
    tb = {k: torch.as_tensor(v, dtype=torch.long)
          for k, v in _batch(64).items()}
    assert p.escalate(tb) is (planner == "mimose")


def test_solver_skips_escalated_buckets(stub_lms, monkeypatch):
    """``--solver dp`` never queues a solve for an escalated key: the
    plan that survived an OOM stays."""
    pin_reference_constants(monkeypatch)
    lm = stub_lms[1]
    planner = MimosePlanner(lm, _stub_budget(stub_lms, 0.2), quantum=32,
                            warmup_samples=3, solver="dp")
    planner.fixed_bytes = FIXED
    planner.collector = StubCollector(lm, plan_unit_flops)
    try:
        for S in SIZES:
            planner.plan(_stub_batches(S)[1])
        planner.background_solver.drain(timeout=30.0)
        tb = _stub_batches(SIZES[2])[1]
        assert planner.escalate(tb)
        key = planner.plan_key(tb)
        esc = planner.cache[key]
        solves = planner.stats["solves"]
        planner.plan(tb)
        planner.background_solver.drain(timeout=30.0)
        assert not getattr(esc, "solver_checked", False)
        assert planner.cache[key] is esc
        assert planner.stats["solves"] == solves
    finally:
        planner.background_solver.close()


# ---------------------------------------------------------------------------
# the trainer's watchdog loop (tests/test_resilience.py's, and three the
# in-place eager step needs)
# ---------------------------------------------------------------------------

def test_watchdog_escalation_ladder_and_recovery():
    lm = _lm()
    planner = MimosePlanner(lm, HBM, quantum=64, warmup_samples=1)
    tr = Trainer(lm, planner, AdamW())
    opt_state = tr.optimizer.init(tr.params)
    batch = _batch(128, B=4)
    bucket = planner.bucket_key(tr._prepare(batch))
    key0 = planner.plan_key(tr._prepare(batch))
    wd = OOMWatchdog(max_retries=3,
                     injector=FaultInjector({"bucket": {bucket: 3}}))
    tr.watchdog = wd
    opt_state, loss = tr.step(opt_state, batch)
    assert np.isfinite(loss)
    assert wd.stats["oom_events"] == 3
    assert wd.stats["escalations"] == 3
    assert wd.stats["retry_successes"] == 1
    assert wd.stats["retry_failures"] == 0
    assert wd.stats["oom_by_bucket"] == {bucket: 3}
    assert planner.stats["oom_events"] == 3
    assert planner.stats["escalations"] == 3
    assert planner._escalation[key0] == 3
    assert planner.cache.get(key0).microbatch == 2     # rung 3 doubled k
    assert tr.history[-1].microbatches == 2
    opt_state, _ = tr.step(opt_state, batch)            # quota spent
    assert wd.stats["oom_events"] == 3
    s = tr.summary()
    assert s["oom_events"] == 3 and s["escalations"] == 3
    assert s["escalations_by_bucket"] == {bucket: 3}
    assert tr.global_step == tr.data_cursor == 2


def test_watchdog_on_escalation_matches_reference():
    """``on_escalation`` books one escalation on the watchdog's view, as
    the reference's does."""
    wd, ref = OOMWatchdog(injector=FaultInjector(None)), RefWatchdog(
        injector=RefInjector(None))
    for w in (wd, ref):
        w.on_escalation()
        w.on_escalation()
    assert wd.stats["escalations"] == ref.stats["escalations"] == 2


def test_watchdog_poisons_plan_and_step_cache():
    lm = _lm()
    planner = MimosePlanner(lm, HBM, quantum=64, warmup_samples=1)
    tr = Trainer(lm, planner, AdamW())
    batch = _batch(64, B=4)
    bucket = planner.bucket_key(tr._prepare(batch))
    tr.watchdog = OOMWatchdog(max_retries=2, injector=FaultInjector(
        {"bucket": {bucket: 1}}))
    tr.step(tr.optimizer.init(tr.params), batch)
    assert planner.stats["poisoned_plans"] == 1
    assert tr.cache_stats["compiles"] == 2   # failed plan + escalated plan
    assert len(tr._step_cache) == 1


def test_watchdog_bounded_retries_reraises():
    lm = _lm()
    planner = MimosePlanner(lm, HBM, quantum=64, warmup_samples=1)
    wd = OOMWatchdog(max_retries=1, injector=FaultInjector("10"))
    tr = Trainer(lm, planner, AdamW(), watchdog=wd)
    with pytest.raises(SimulatedOOM):
        tr.step(tr.optimizer.init(tr.params), _batch(64, B=4))
    assert wd.stats["retry_failures"] == 1
    assert wd.stats["retry_successes"] == 0
    assert wd.stats["oom_events"] == 2       # the first try + 1 retry
    assert tr.global_step == 0 and not tr.history


def test_watchdog_ignores_non_oom_errors():
    lm = _lm()
    planner = MimosePlanner(lm, HBM, quantum=64, warmup_samples=1)
    wd = OOMWatchdog(max_retries=3)
    tr = Trainer(lm, planner, AdamW(), watchdog=wd)
    bad = {"tokens": np.ones((2, 64), np.int32)}       # no labels: a bug
    with pytest.raises(Exception):
        tr.step(tr.optimizer.init(tr.params), bad)
    assert wd.stats["oom_events"] == 0


def test_oom_mid_backward_recovers_like_the_escalated_plan(one_thread):
    """A ``torch.OutOfMemoryError`` raised in the backward (after other
    parameters' ``.grad`` were written) is booked, the ladder's plan
    runs, and the step equals, bitwise, a fresh trainer running that
    plan directly."""
    batch = _batches(1, B=4)[0]
    lm = _lm()
    # all KEEP fits; the first rung's shrunken budget does not
    planner = MimosePlanner(lm, _tight_budget(lm, batch, 1.02), quantum=64,
                            warmup_samples=1)
    wd = OOMWatchdog(max_retries=3, injector=FaultInjector(None))
    tr = Trainer(lm, planner, AdamW(lr=1e-3), watchdog=wd)
    fired = []

    def boom(g):
        if not fired:
            fired.append(1)
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 MiB")
        return g
    # the embedding's gradient is the backward's last: every other
    # parameter's .grad is written when it fires
    lm.embed.register_hook(boom)
    opt_state, loss = tr.step(tr.optimizer.init(tr.params), batch)
    assert fired and wd.stats["oom_events"] == 1
    assert wd.stats["escalations"] == wd.stats["retry_successes"] == 1
    assert all(p.grad is None for p in tr.params.values())
    plan = planner.cache[planner.plan_key(tr._prepare(batch))]
    assert plan.source == "escalated" and plan.n_remat > 0
    assert tr.history[-1].remat_units == plan.n_remat

    lm2 = _lm()
    tr2 = Trainer(lm2, FixedPlanner(lm2, plan.actions, plan.microbatch),
                  AdamW(lr=1e-3))
    # a hook on the tied embedding changes the order its two gradient
    # terms are summed in: the direct run carries an identity one too
    lm2.embed.register_hook(lambda g: g)
    st2, loss2 = tr2.step(tr2.optimizer.init(tr2.params), batch)
    assert loss == loss2
    _assert_same(_params(tr), _params(tr2))
    _assert_same(opt_state.m, st2.m)


class _UpdateFault:
    """Raises a ``torch.OutOfMemoryError`` inside AdamW's update at the
    ``nth`` parameter (in the params dict's order), after its new m and
    v were allocated (at its ``torch.sqrt``), ``fires`` times."""

    def __init__(self, monkeypatch, nth, fires=1):
        self.nth, self.fires, self.fired, self.passes = nth, fires, 0, 0
        self._base, self._n, self._in = 0, 0, False
        real_sqrt, real_apply = torch.sqrt, AdamW.apply

        def sqrt(x, *a, **kw):
            if self._in:
                self._n += 1
                if (self._base + self._n - 1 == self.nth
                        and self.fired < self.fires):
                    self.fired += 1
                    raise torch.OutOfMemoryError(
                        "CUDA out of memory. Tried to allocate 2.00 MiB")
            return real_sqrt(x, *a, **kw)

        def apply(opt, cur, *a, **kw):
            self._in, self._base, self._n = True, cur.done, 0
            self.passes += 1
            try:
                return real_apply(opt, cur, *a, **kw)
            finally:
                self._in = False
        monkeypatch.setattr(torch, "sqrt", sqrt)
        monkeypatch.setattr(AdamW, "apply", apply)


def _mimose_trainer(max_retries=3):
    lm = _lm()
    planner = MimosePlanner(lm, HBM, quantum=64, warmup_samples=1)
    wd = OOMWatchdog(max_retries=max_retries, injector=FaultInjector(None))
    return Trainer(lm, planner, AdamW(lr=1e-3), watchdog=wd)


@pytest.mark.parametrize("nth", [0, 5, -1])
def test_oom_in_the_optimizer_update_resumes_bitwise(monkeypatch, one_thread,
                                                     nth):
    """An OOM at the nth parameter of the second step's update (after
    the first nth were written) is booked and escalated as one in the
    step, and the update resumes at that parameter: parameters and
    moments bitwise those of the same two steps with no fault, one OOM,
    one escalation, one retry success, the bucket's ladder at rung 1."""
    batch = _batch(64, B=4)
    clean = _mimose_trainer()
    st = clean.optimizer.init(clean.params)
    for _ in range(2):
        st, _ = clean.step(st, batch)

    tr = _mimose_trainer()
    n_params = len(tr.params)
    st_f = tr.optimizer.init(tr.params)
    st_f, _ = tr.step(st_f, batch)
    fault = _UpdateFault(monkeypatch, nth % n_params)
    st_f, _ = tr.step(st_f, batch)
    assert fault.fired == 1 and fault.passes == 2
    _assert_same(_params(tr), _params(clean))
    _assert_same(st_f.m, st.m)
    _assert_same(st_f.v, st.v)
    assert st_f.step == st.step == 2
    wd, planner = tr.watchdog, tr.planner
    assert wd.stats["oom_events"] == wd.stats["escalations"] == 1
    assert wd.stats["retry_successes"] == 1
    assert wd.stats["retry_failures"] == 0
    key = planner.plan_key(tr._prepare(batch))
    assert planner._escalation == {key: 1}
    assert planner.cache[key].source == "escalated"
    assert all(p.grad is None for p in tr.params.values())
    assert tr.global_step == 2 and len(tr.history) == 2


def test_oom_in_the_update_escalates_as_the_reference_step(monkeypatch):
    """One OOM in a bucket leaves the port's ladder (an OOM in its
    update) on the rung the reference's (an OOM in its jitted step,
    whose update is inside) stands on, with the same counters."""
    batch = _batch(64, B=4)
    tr = _mimose_trainer()
    _UpdateFault(monkeypatch, 2)
    tr.step(tr.optimizer.init(tr.params), batch)

    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    ref_planner = RefMimose(jlm, HBM, quantum=64, warmup_samples=1)
    bucket = ref_planner.bucket_key(batch)
    ref_wd = RefWatchdog(max_retries=3,
                         injector=RefInjector({"bucket": {bucket: 1}}))
    jtr = JaxTrainer(jlm, ref_planner, JaxAdamW(lr=1e-3), watchdog=ref_wd)
    params = jlm.init(jax.random.PRNGKey(0))
    jtr.step(params, jtr.optimizer.init(params), batch)
    assert list(ref_planner._escalation.values()) == list(
        tr.planner._escalation.values()) == [1]
    for k in ("oom_events", "escalations", "retry_successes",
              "retry_failures"):
        assert tr.watchdog.stats[k] == ref_wd.stats[k], k


def test_persistent_oom_in_the_update_reraises(monkeypatch):
    """An OOM at the same parameter on every pass counts against
    ``max_retries`` and ends in one retry failure and the re-raise."""
    tr = _mimose_trainer(max_retries=2)
    fault = _UpdateFault(monkeypatch, 3, fires=100)
    with pytest.raises(torch.OutOfMemoryError):
        tr.step(tr.optimizer.init(tr.params), _batch(64, B=4))
    wd = tr.watchdog
    assert fault.passes == 3 == wd.stats["oom_events"]  # 1 + 2 retries
    assert wd.stats["retry_failures"] == 1
    assert wd.stats["retry_successes"] == 0
    assert wd.stats["escalations"] == 2
    assert tr.global_step == 0 and not tr.history


class _RetryingFixedPlanner(FixedPlanner):
    """A fixed plan whose ladder keeps the plan (for the parked
    moments' resume)."""

    def escalate(self, batch):
        return True


def test_oom_in_the_update_brings_parked_moments_home(monkeypatch,
                                                      one_thread):
    """With the last unit's moments parked (OFFLOAD_OPT), an OOM at its
    first parameter's update leaves them parked; the resumed pass brings
    them home parameter by parameter and parks them again: parameters
    and moments bitwise the fault-free run's."""
    acts = (Action.OFFLOAD, Action.OFFLOAD_OPT)
    batches = _batches(3)

    def fresh():
        lm = _lm()
        return Trainer(lm, _RetryingFixedPlanner(lm, acts), AdamW(lr=1e-3),
                       watchdog=OOMWatchdog(max_retries=3,
                                            injector=FaultInjector(None)))
    clean = fresh()
    st = clean.run(batches)
    tr = fresh()
    st_f = tr.run(batches[:2])
    assert tr._parked == {1}
    first_parked = next(i for i, n in enumerate(tr.params)
                        if n in tr._unit_names[1])
    fault = _UpdateFault(monkeypatch, first_parked)
    st_f = tr.run(batches[2:], st_f)
    assert fault.fired == 1 and tr._parked == {1}
    assert tr.watchdog.stats["retry_successes"] == 1
    _assert_same(_params(tr), _params(clean))
    host = [n for n in tr._unit_names[1]]
    assert all(not st_f.m[n].is_cuda for n in host)
    _assert_same(st_f.m, st.m)
    _assert_same(st_f.v, st.v)


def test_engine_report_shows_resilience_counters():
    lm = _lm()
    planner = MimosePlanner(lm, HBM, quantum=64, warmup_samples=1)
    tr = Trainer(lm, planner, AdamW())
    batch = _batch(64, B=4)
    bucket = planner.bucket_key(tr._prepare(batch))
    tr.watchdog = OOMWatchdog(max_retries=3, injector=FaultInjector(
        {"bucket": {bucket: 1}}))
    tr.step(tr.optimizer.init(tr.params), batch)
    rep = engine_report(tr, planner)
    assert "resilience:" in rep and "1 OOM event(s)" in rep
    assert f"escalations by bucket: {bucket}: 1" in rep
    quiet = Trainer(_lm(), MimosePlanner(_lm(), HBM, quantum=64), AdamW())
    quiet.step(quiet.optimizer.init(quiet.params), batch)
    assert "resilience:" not in engine_report(quiet)


# ---------------------------------------------------------------------------
# kill-and-resume
# ---------------------------------------------------------------------------

def _tight_budget(lm, batch, share):
    """fixed bytes + ``share`` x the batch's collected activations."""
    tb = Trainer(lm, NonePlanner(lm))._prepare(batch)
    act = ShuttlingCollector(lm).collect(tb).total_activation_bytes()
    return fixed_train_bytes(lm.parameters()) + share * act


def test_kill_and_resume_matches_uninterrupted_and_reference(tmp_path, one_thread):
    """4 + 4 steps with a snapshot between, into a fresh model (another
    seed), planner and trainer: losses, parameters and moments bitwise
    those of 8 uninterrupted steps, with no collection or refit after
    the restore; and within rtol 2e-5 of the reference's own
    kill-and-resume from the same converted parameters."""
    batches = _batches(8)
    jcfg = jax_get_config("bert_base_paper").reduced(**REDUCED)
    jlm = build_model(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    budget = _tight_budget(_lm(), batches[0], 0.5)

    def fresh(load=True):
        lm = _lm(seed=1)
        if load:
            bridge.load_tree(lm, params)
        return Trainer(lm, MimosePlanner(lm, budget, quantum=64,
                                         warmup_samples=2),
                       AdamW(lr=1e-3))
    tr_a = fresh()
    st_a = tr_a.run(batches)
    want = [s.loss for s in tr_a.history]
    assert any(s.remat_units for s in tr_a.history)

    tr_b = fresh()
    st = tr_b.run(batches[:4])
    tr_b.save_snapshot(st, SnapshotManager(str(tmp_path / "port")))
    n_plans = len(tr_b.planner.cache)
    tr_c = fresh(load=False)
    tr_c.snapshots = SnapshotManager(str(tmp_path / "port"))
    st_c, r = tr_c.restore(tr_c.optimizer.init(tr_c.params))
    assert r.step == r.data_cursor == 4 == tr_c.global_step
    assert r.planner_summary["restored_plans"] == n_plans
    st_c = tr_c.run(batches[r.data_cursor:], st_c)
    got = [s.loss for s in tr_c.history]
    assert got == want[4:]
    _assert_same(_params(tr_c), _params(tr_a))
    _assert_same(st_c.m, st_a.m)
    _assert_same(st_c.v, st_a.v)
    assert st_c.step == st_a.step == 8
    assert tr_c.planner.stats["collections"] == 0
    assert tr_c.planner.stats["refits"] == 0
    assert tr_c.summary()["restores"] == 1

    # the reference's kill-and-resume from the same parameters
    def jfresh():
        return JaxTrainer(jlm, RefMimose(jlm, budget, quantum=64,
                                         warmup_samples=2),
                          JaxAdamW(lr=1e-3))
    jbatches = list(jax_make_batches("swag", batch_size=2, vocab_size=256,
                                     num_batches=8, quantum=64, seed=0))
    jtr = jfresh()
    jp = jax.tree_util.tree_map(lambda a: a.copy(), params)
    js = jtr.optimizer.init(jp)
    for b in jbatches[:4]:
        jp, js, _ = jtr.step(jp, js, b)
    sm = RefSnapshots(str(tmp_path / "ref"))
    sm.save(step=4, params=jp, opt_state=js, planner=jtr.planner,
            data_cursor=4)
    jtr2 = jfresh()
    jr = sm.restore_latest(params_like=params,
                           opt_like=jtr2.optimizer.init(params),
                           planner=jtr2.planner)
    jp, js = jr.params, jr.opt_state
    ref = []
    for b in jbatches[jr.data_cursor:]:
        jp, js, loss = jtr2.step(jp, js, b)
        ref.append(loss)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert jtr2.planner.stats["collections"] == 0


def test_snapshot_with_parked_moments_resumes_bitwise(tmp_path, one_thread):
    """A snapshot taken while OFFLOAD_OPT moments sit in host memory
    saves them, and the resumed trainer parks them again: loss,
    parameters and moments equal the uninterrupted run's."""
    acts = (Action.OFFLOAD, Action.OFFLOAD_OPT)

    def fresh(seed=0):
        lm = _lm(seed)
        return Trainer(lm, FixedPlanner(lm, acts), AdamW(lr=1e-3))
    batches = _batches(4)
    tr_a = fresh()
    st_a = tr_a.run(batches)
    tr_b = fresh()
    st_b = tr_b.run(batches[:2])
    assert tr_b._parked == {1}
    path = tr_b.save_snapshot(st_b, SnapshotManager(str(tmp_path)))
    assert json.load(open(os.path.join(path, "meta.json")))[
        "extra"]["parked"] == [1]
    tr_c = fresh(seed=1)
    st_c, _ = tr_c.restore(tr_c.optimizer.init(tr_c.params),
                           SnapshotManager(str(tmp_path)))
    assert tr_c._parked == {1} and tr_c.transfer_lane is not None
    st_c = tr_c.run(batches[2:], st_c)
    assert [s.loss for s in tr_c.history] == [s.loss
                                             for s in tr_a.history[2:]]
    _assert_same(_params(tr_c), _params(tr_a))
    _assert_same(st_c.m, st_a.m)
    _assert_same(st_c.v, st_a.v)
    assert all(h.opt_offload_units == 1 for h in tr_c.history)


def test_launcher_checkpoint_inject_and_resume(tmp_path, capsys):
    d = str(tmp_path / "ck")
    common = ["--device", "cpu", "--reduced", "--steps", "6",
              "--batch-size", "2", "--budget-mb", "45",
              "--checkpoint-dir", d, "--checkpoint-every-steps", "2",
              "--checkpoint-keep", "2"]
    tr = launch_train.main(common + ["--inject-oom", "2"])
    s = tr.summary()
    assert s["oom_events"] == s["escalations"] == 2
    assert s["retry_successes"] == 1 and s["snapshots_written"] == 4
    assert len(SnapshotManager(d).snapshots()) == 2
    out = capsys.readouterr().out
    assert "resilience: 4 snapshot(s) written" in out
    tr2 = launch_train.main(common + ["--resume"])
    out = capsys.readouterr().out
    assert "at step 6 (cursor=6" in out
    assert tr2.restores == 1 and tr2.global_step == 6 and not tr2.history
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--reduced", "--resume"])


def test_launcher_save_roundtrips_bitwise(tmp_path, capsys):
    """``--save`` writes the final parameters; ``checkpoint.load`` reads
    them back into a fresh model of the same configuration, bit for
    bit."""
    path = str(tmp_path / "final.pt")
    tr = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                            "--batch-size", "2", "--save", path])
    assert f"saved {path}" in capsys.readouterr().out
    fresh = LM(tr.lm.cfg, device="cpu", seed=7)
    like = dict(fresh.named_parameters())
    assert not all(torch.equal(like[n], p) for n, p in tr.params.items())
    got = checkpoint.load(path, like)
    assert set(got) == set(tr.params)
    for n, p in tr.params.items():
        assert torch.equal(got[n], p.detach()), n
    with torch.no_grad():
        for n, t in got.items():
            like[n].copy_(t)
    _assert_same({n: p.detach() for n, p in fresh.named_parameters()},
                 _params(tr))


# ---------------------------------------------------------------------------
# a resume onto another mesh shape
# ---------------------------------------------------------------------------

def _reshape_pair(lm, jlm, params, shape_a, shape_b):
    """The port's and the reference's planner under ``shape_a`` after one
    plan, and fresh ones under ``shape_b`` restored from their states."""
    from repro.sharding.budget import MeshBudget as RefMeshBudget
    from repro.train.resilience import \
        restore_planner_state as ref_restore_planner_state
    from repro_torch.sharding.budget import MeshBudget
    out = []
    for pkg, budget_cls, mk, batch, restore in (
            ("port", MeshBudget,
             lambda mb: MimosePlanner(lm, None, quantum=64,
                                      warmup_samples=1, mesh_budget=mb),
             {k: torch.as_tensor(v) for k, v in _batch(64).items()},
             lambda p, s: restore_planner_state(p, s)),
            ("ref", RefMeshBudget,
             lambda mb: RefMimose(jlm, None, quantum=64, warmup_samples=1,
                                  mesh_budget=mb),
             _batch(64),
             lambda p, s: ref_restore_planner_state(p, s, params=params))):
        src = mk(budget_cls.from_shape(shape_a, HBM))
        if pkg == "port":
            src.plan(batch)
        else:
            src.plan(params, batch)
        state = (planner_state(src) if pkg == "port"
                 else ref_planner_state(src))
        dst = mk(budget_cls.from_shape(shape_b, HBM))
        out.append((src, dst, state, restore(dst, state), mk, batch))
    return out


def test_planner_state_mesh_reshape_replays_samples():
    """(1, 2) -> (2, 1): the sample log replays through the live meta
    collector under the new mesh, no stored plan survives, and the
    replayed fit equals a fresh planner's under the new mesh (rel 1e-6);
    the restore summary equals the reference's."""
    from repro_torch.sharding.budget import MeshBudget
    lm = _lm()
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    params = jlm.init(jax.random.PRNGKey(0))
    (src, dst, state, summary, mk, batch), ref = _reshape_pair(
        lm, jlm, params, [1, 2], [2, 1])
    assert summary == ref[3]
    assert summary["mesh_changed"]
    assert summary["restored_samples"] == len(state["sample_log"])
    assert summary["restored_plans"] == 0
    assert summary["dropped_plans"] == len(state["plans"]) > 0
    assert dst.estimator.ready and len(dst.cache) == 0
    assert dst.stats["dropped_plans"] == len(state["plans"])
    assert dst.stats["collections"] == 0
    fresh = mk(MeshBudget.from_shape([2, 1], HBM))
    fresh.plan(batch)
    np.testing.assert_allclose(dst.estimator.predict(2 * 128),
                               fresh.estimator.predict(2 * 128), rtol=1e-6)
    # the signature is the new mesh's, and a replan serves from the fit
    assert dst.mesh_sig() == fresh.mesh_sig() != src.mesh_sig()
    dst.plan(batch)
    assert dst.stats["collections"] == 0


def test_kill_and_resume_across_mesh_reshape(tmp_path, one_thread):
    """8 steps under a (1, 2) mesh budget against 4, a snapshot, and 4
    more resumed onto (2, 1) with fresh objects: the planner replays its
    samples (no collection, no refit), the losses are those of the
    uninterrupted run bitwise (the roomy budget keeps every plan KEEP),
    and the restore summary equals the reference's on the same
    schedule."""
    from repro.sharding.budget import MeshBudget as RefMeshBudget
    from repro_torch.sharding.budget import MeshBudget
    batches = _batches(8)

    def fresh(shape):
        lm = _lm()
        return Trainer(lm, MimosePlanner(
            lm, None, quantum=64, warmup_samples=1,
            mesh_budget=MeshBudget.from_shape(shape, HBM)), AdamW(lr=1e-3))
    tr_a = fresh([1, 2])
    tr_a.run(batches)
    want = [s.loss for s in tr_a.history]
    tr_b = fresh([1, 2])
    st = tr_b.run(batches[:4])
    tr_b.save_snapshot(st, SnapshotManager(str(tmp_path / "port")))
    tr_c = fresh([2, 1])
    tr_c.snapshots = SnapshotManager(str(tmp_path / "port"))
    st_c, r = tr_c.restore(tr_c.optimizer.init(tr_c.params))
    assert r.step == r.data_cursor == 4
    assert r.planner_summary["mesh_changed"]
    assert r.planner_summary["restored_samples"] >= 1
    tr_c.run(batches[r.data_cursor:], st_c)
    assert [s.loss for s in tr_c.history] == want[4:]
    assert tr_c.planner.stats["collections"] == 0
    assert tr_c.planner.stats["refits"] == 0
    n_buckets = len({s.bucket for s in tr_c.history})
    assert tr_c.cache_stats["compiles"] <= n_buckets
    assert tr_c.summary()["restores"] == 1

    # the reference's schedule: 4 steps under (1, 2), snapshot, (2, 1)
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    params = jlm.init(jax.random.PRNGKey(0))

    def jfresh(shape):
        return JaxTrainer(jlm, RefMimose(
            jlm, None, quantum=64, warmup_samples=1,
            mesh_budget=RefMeshBudget.from_shape(shape, HBM)),
            JaxAdamW(lr=1e-3))
    jbatches = list(jax_make_batches("swag", batch_size=2, vocab_size=256,
                                     num_batches=8, quantum=64, seed=0))
    jtr = jfresh([1, 2])
    jp = jax.tree_util.tree_map(lambda a: a.copy(), params)
    js = jtr.optimizer.init(jp)
    for b in jbatches[:4]:
        jp, js, _ = jtr.step(jp, js, b)
    sm = RefSnapshots(str(tmp_path / "ref"))
    sm.save(step=4, params=jp, opt_state=js, planner=jtr.planner,
            data_cursor=4)
    jtr2 = jfresh([2, 1])
    jr = sm.restore_latest(params_like=params,
                           opt_like=jtr2.optimizer.init(params),
                           planner=jtr2.planner)
    assert r.planner_summary == jr.planner_summary


def test_launcher_resume_across_mesh_reshape(tmp_path, capsys, one_thread):
    """The launcher's drill: 8 steps under ``--mesh-shape 1x1`` with a
    snapshot at step 4, then ``--resume`` from it under ``4x2 --zero1``
    (planned per device, executed on one device): the planner replays
    its samples under the new mesh, drops every stored plan, collects
    nothing, remats no more units per bucket, and the losses are the
    uninterrupted run's."""
    import shutil
    d, d2 = str(tmp_path / "ck"), str(tmp_path / "ck4")
    common = ["--device", "cpu", "--reduced", "--steps", "8",
              "--batch-size", "4", "--dataset", "squad", "--quantum", "64"]
    tr = launch_train.main(common + [
        "--mesh-shape", "1x1", "--budget-mb", "65", "--checkpoint-dir", d,
        "--checkpoint-every-steps", "4"])
    capsys.readouterr()
    assert any(s.remat_units for s in tr.history)
    snap = SnapshotManager(d).snapshots()[0]
    assert snap.endswith("snap-00000004")
    shutil.copytree(snap, os.path.join(d2, os.path.basename(snap)))
    with open(os.path.join(snap, "planner.json")) as f:
        stored = json.load(f)
    tr2 = launch_train.main(common + [
        "--mesh-shape", "4x2", "--zero1", "--hbm-gb", str(65 / 1024),
        "--checkpoint-dir", d2, "--resume"])
    out = capsys.readouterr().out
    assert "planning per device, executing on one device" in out
    st = tr2.planner.stats
    assert st["restored_samples"] == len(stored["sample_log"])
    assert st["restored_plans"] == 0
    assert st["dropped_plans"] == len(stored["plans"]) > 0
    assert st["collections"] == 0
    assert [s.loss for s in tr2.history] == \
        [s.loss for s in tr.history[4:]]
    first = {}
    for s in tr.history:
        first.setdefault(s.bucket, s.remat_units)
    for s in tr2.history:
        if s.bucket in first:
            assert s.remat_units <= first[s.bucket]
