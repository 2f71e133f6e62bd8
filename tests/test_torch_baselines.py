"""The port's planners — Mimose with adaptive microbatching, the
Sublinear and DTR baselines — against the reference's, and the port's
launcher under every planner.

The port's meta collector counts 0.43-0.54x the reference's bytes for
the same block (``tests/test_torch_planner.py``), so the packages'
planners would plan different inputs.  Here each package's planner gets
a stub collector that returns the same seeded byte vectors for a batch
geometry, and each package prices recompute with its own
``plan_unit_flops`` (equal: ``test_collector_bytes_within_tolerance_of_reference``
holds the FLOPs vectors equal).  With the roofline constants pinned to
the reference's (``torch_pins``) every plan must then agree exactly:
the same actions, k, cache hits and collections, step by step.
"""
import numpy as np
import pytest
import torch

from repro.core.baselines import DTRSimPlanner as RefDTR
from repro.core.baselines import SublinearPlanner as RefSublinear
from repro.core.planner import MimosePlanner as RefMimose
from repro.launch.roofline import plan_unit_flops as ref_flops
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch.core.baselines import DTRSimPlanner, SublinearPlanner
from repro_torch.core.planner import MimosePlanner
from repro_torch.launch import train as launch_train
from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from torch_pins import pin_reference_constants

REDUCED = dict(num_layers=6, d_model=64, d_ff=128, vocab_size=256,
               dtype="float32")
N_UNITS = 6
FIXED = 4e6
SIZES = [64, 96, 128, 64, 160, 96, 192, 128, 224, 160]
B = 8


class StubResult:
    """What a collection returns, from seeded per-unit coefficients:
    bytes linear and quadratic in S and linear in B, the same in both
    packages."""

    def __init__(self, coef, batch, flops_fn, lm):
        b, s = (int(x) for x in batch["tokens"].shape)
        self.input_size = b * s
        self.collect_time_s = 0.0
        lin, quad, out = coef
        self._act = b * s * lin + b * s * s * quad
        self._out = np.full(N_UNITS, b * s * out)
        self._flops = flops_fn(lm, batch)

    def activation_vector(self):
        return self._act.copy()

    def flops_vector(self):
        return self._flops.copy()

    def output_vector(self):
        return self._out.copy()

    def offloadable_vector(self):
        return 0.8 * self._act

    def opt_vector(self):
        return np.zeros(N_UNITS)


class StubCollector:
    def __init__(self, lm, flops_fn, seed=0):
        rng = np.random.default_rng(seed)
        self.coef = (rng.uniform(2e3, 4e3, N_UNITS),
                     rng.uniform(2.0, 12.0, N_UNITS), 256.0)
        self.lm, self.flops_fn = lm, flops_fn
        self.calls = 0

    def collect(self, *args):
        self.calls += 1
        return StubResult(self.coef, args[-1], self.flops_fn, self.lm)


@pytest.fixture(scope="module")
def lms():
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    lm = LM(get_config("bert_base_paper").reduced(**REDUCED), device="cpu")
    assert lm.num_plan_units() == jlm.num_plan_units() == N_UNITS
    return jlm, lm


def _batches(S):
    tokens = np.ones((B, S), np.int32)
    return ({"tokens": tokens, "labels": tokens},
            {"tokens": torch.ones((B, S), dtype=torch.long),
             "labels": torch.ones((B, S), dtype=torch.long)})


def _budget(lms, frac):
    """fixed + frac x the largest size's stub activation bytes."""
    col = StubCollector(lms[1], plan_unit_flops)
    act = col.collect(_batches(max(SIZES))[1]).activation_vector()
    return FIXED + frac * float(act.sum())


def _same(ref_out, out):
    (ra, ri), (a, i) = ref_out, out
    assert tuple(int(x) for x in ra) == tuple(int(x) for x in a)
    assert ri.plan.microbatch == i.plan.microbatch
    assert ri.plan.n_remat == i.plan.n_remat
    assert (ri.cache_hit, ri.collected) == (i.cache_hit, i.collected)
    assert ri.quantized_size == i.quantized_size


def _run(ref_planner, planner, params=None):
    ks = []
    for S in SIZES:
        jb, tb = _batches(S)
        ref_out = ref_planner.plan(params, jb)
        out = planner.plan(tb)
        _same(ref_out, out)
        ks.append(out[1].plan.microbatch)
    return ks


@pytest.mark.parametrize("max_mb", [1, 4])
@pytest.mark.parametrize("frac", [0.05, 0.2, 0.5, 2.0])
def test_mimose_plans_match_reference_on_the_same_vectors(lms, monkeypatch,
                                                          frac, max_mb):
    pin_reference_constants(monkeypatch)
    jlm, lm = lms
    budget = _budget(lms, frac)
    ref = RefMimose(jlm, budget, fixed_bytes=FIXED, quantum=32,
                    warmup_samples=3, max_microbatches=max_mb)
    ours = MimosePlanner(lm, budget, quantum=32, warmup_samples=3,
                         max_microbatches=max_mb)
    ours.fixed_bytes = FIXED
    ref.collector = StubCollector(jlm, ref_flops)
    ours.collector = StubCollector(lm, plan_unit_flops)
    ks = _run(ref, ours)
    assert ref.collector.calls == ours.collector.calls
    for key in ("cache_hits", "cache_misses", "collections"):
        assert ref.stats[key] == ours.stats[key], key
    if max_mb == 1:
        assert set(ks) == {1}


def test_mimose_split_reaches_below_the_k1_floor(lms, monkeypatch):
    """At a budget under every k = 1 footprint the plans split, in both
    packages alike."""
    pin_reference_constants(monkeypatch)
    jlm, lm = lms
    ref = RefMimose(jlm, FIXED * 1.02, fixed_bytes=FIXED, quantum=32,
                    warmup_samples=3, max_microbatches=4)
    ours = MimosePlanner(lm, FIXED * 1.02, quantum=32, warmup_samples=3,
                         max_microbatches=4)
    ours.fixed_bytes = FIXED
    ref.collector = StubCollector(jlm, ref_flops)
    ours.collector = StubCollector(lm, plan_unit_flops)
    assert max(_run(ref, ours)) > 1


@pytest.mark.parametrize("max_mb", [1, 4])
@pytest.mark.parametrize("frac", [0.05, 0.3, 2.0])
def test_sublinear_plan_matches_reference_on_the_same_vectors(lms,
                                                              monkeypatch,
                                                              frac, max_mb):
    pin_reference_constants(monkeypatch)
    jlm, lm = lms
    budget = _budget(lms, frac)
    kw = dict(max_input_size=B * max(SIZES), fixed_bytes=FIXED,
              warmup_samples=3, max_microbatches=max_mb)
    ref = RefSublinear(jlm, budget, **kw)
    ours = SublinearPlanner(lm, budget, **kw)
    ref.collector = StubCollector(jlm, ref_flops)
    ours.collector = StubCollector(lm, plan_unit_flops)
    ks = _run(ref, ours)
    assert len(set(ks)) == 1                  # one static plan
    assert ref.collector.calls == ours.collector.calls == 3


@pytest.mark.parametrize("max_mb", [1, 4])
@pytest.mark.parametrize("frac", [0.05, 0.3, 2.0])
def test_dtr_plans_match_reference_on_the_same_vectors(lms, monkeypatch,
                                                       frac, max_mb):
    pin_reference_constants(monkeypatch)
    jlm, lm = lms
    budget = _budget(lms, frac)
    ref = RefDTR(jlm, budget, fixed_bytes=FIXED, max_microbatches=max_mb)
    ours = DTRSimPlanner(lm, budget, fixed_bytes=FIXED,
                         max_microbatches=max_mb)
    ref.collector = StubCollector(jlm, ref_flops)
    ours.collector = StubCollector(lm, plan_unit_flops)
    _run(ref, ours)
    assert ref.stats["plan_ops"] == ours.stats["plan_ops"]
    assert ref.stats["replans"] == ours.stats["replans"] == len(SIZES)


def test_baselines_require_their_arguments(lms):
    with pytest.raises(ValueError):
        SublinearPlanner(lms[1], 1e9)


def test_baselines_on_the_real_collector(lms):
    """Unstubbed: Sublinear collects once and keeps one plan for every
    size; DTR collects each (size, split) once and replans every step;
    a tight DTR budget raises the split."""
    lm = lms[1]
    sub = SublinearPlanner(lm, 1e12, max_input_size=B * 256,
                           warmup_samples=2, max_microbatches=2)
    plans = [sub.plan(_batches(S)[1])[1].plan for S in (64, 128)]
    assert plans[0] is plans[1] and plans[0].microbatch == 1
    from repro_torch.core.collector import ShuttlingCollector
    from repro_torch.core.planner import fixed_train_bytes
    act = ShuttlingCollector(lm).collect(_batches(64)[1]).activation_vector()
    fixed = fixed_train_bytes(lm.parameters())
    dtr = DTRSimPlanner(lm, fixed + 1.5 * float(act.max()),
                        max_microbatches=4)
    _, info = dtr.plan(_batches(64)[1])
    assert info.plan.microbatch > 1
    dtr.plan(_batches(64)[1])
    assert dtr.stats["replans"] == 2 and dtr.stats["plan_ops"] > 0
    assert DTRSimPlanner(lm, 1e15, max_microbatches=4).plan(
        _batches(64)[1])[1].plan.microbatch == 1


# ---------------------------------------------------------------------------
# the launcher under each planner (CPU, reduced)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--planner", "none"], ["--planner", "sublinear"], ["--planner", "dtr"],
    ["--planner", "mimose"],
    ["--planner", "mimose", "--max-microbatches", "4", "--solver", "dp"],
    ["--planner", "mimose", "--byte-only-remat"],
])
def test_launcher_runs_each_planner_on_cpu(extra, capsys):
    tr = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                            "--budget-mb", "45", "--batch-size", "4"]
                           + extra)
    assert len(tr.history) == 3
    assert all(np.isfinite(s.loss) for s in tr.history)
    out = capsys.readouterr().out
    assert "summary:" in out and " k=" in out
    if "--solver" in extra:
        assert tr.planner.background_solver is not None


def test_launcher_tight_budget_splits_on_cpu():
    tr = launch_train.main(["--device", "cpu", "--reduced", "--steps", "2",
                            "--budget-mb", "28", "--batch-size", "4",
                            "--max-microbatches", "4"])
    assert max(s.microbatches for s in tr.history) > 1
    assert tr.summary()["mean_microbatches"] > 1.0


@pytest.mark.parametrize("bad", [
    ["--planner", "dtr", "--solver", "dp"],
    ["--planner", "sublinear", "--solver", "dp"],
    ["--max-microbatches", "0"],
])
def test_launcher_rejects_inconsistent_arguments(bad):
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--reduced", "--steps", "1"]
                          + bad)


# ---------------------------------------------------------------------------
# MimosePlanner's keywords (the reference's, with its defaults) against
# the reference's planner built with the same values, on the stub vectors
# ---------------------------------------------------------------------------

def _keyword_pair(lms, budget, **kw):
    """The two packages' Mimose planners built with the same keywords,
    ``fixed_bytes`` among them, on the stub collectors."""
    jlm, lm = lms
    common = dict(fixed_bytes=FIXED, quantum=32, warmup_samples=3, **kw)
    ref, ours = RefMimose(jlm, budget, **common), MimosePlanner(lm, budget,
                                                                **common)
    ref.collector = StubCollector(jlm, ref_flops)
    ours.collector = StubCollector(lm, plan_unit_flops)
    return ref, ours


def test_mimose_keywords_default_to_the_reference_values(lms):
    ours = MimosePlanner(lms[1], 1e9)
    ref = RefMimose(lms[0], 1e9)
    assert ours.fixed_bytes is None                  # resolved lazily
    for key in ("bucket_tol", "audit_tol", "escalate_shrink"):
        assert getattr(ours, key) == getattr(ref, key), key
    assert ours.estimator.degree == ref.estimator.degree == 2
    assert ours.est_output.degree == ours.est_offload.degree == 2
    assert ours.cache.maxsize == ref.cache.maxsize == 256


@pytest.mark.parametrize("bucket_tol", [0.0, 0.3])
def test_mimose_bucket_tol_and_escalate_shrink_match_reference(
        lms, monkeypatch, bucket_tol):
    """Plans at a non-default scheduler tolerance, then three rungs of
    one bucket's ladder at a non-default shrink, as the reference's."""
    pin_reference_constants(monkeypatch)
    ref, ours = _keyword_pair(lms, _budget(lms, 0.2), bucket_tol=bucket_tol,
                              escalate_shrink=0.6)
    assert ours.fixed_bytes == FIXED
    _run(ref, ours)
    jb, tb = _batches(SIZES[2])
    for rung in range(1, 4):
        assert ref.escalate(None, jb) is ours.escalate(tb) is True
        rp, p = ref.cache[ref.plan_key(jb)], ours.cache[ours.plan_key(tb)]
        assert tuple(int(a) for a in rp.actions) == tuple(
            int(a) for a in p.actions), rung
        assert rp.microbatch == p.microbatch


@pytest.mark.parametrize("audit_tol", [1e-4, 0.05, 1e9])
def test_mimose_audit_tol_refits_match_reference(lms, monkeypatch,
                                                 audit_tol):
    """A drift audit on every unseen size, a linear fit of quadratic
    vectors: the same audits, refits and plans as the reference at each
    tolerance, and none past a tolerance nothing reaches."""
    pin_reference_constants(monkeypatch)
    ref, ours = _keyword_pair(lms, _budget(lms, 0.2), degree=1,
                              audit_every=1, audit_tol=audit_tol)
    _run(ref, ours)
    for key in ("audits", "refits", "collections", "cache_hits"):
        assert ref.stats[key] == ours.stats[key], key
    assert ours.stats["audits"] > 0
    assert (ours.stats["refits"] > 0) == (audit_tol < 1.0)


def test_mimose_max_plans_evicts_like_reference(lms, monkeypatch):
    pin_reference_constants(monkeypatch)
    ref, ours = _keyword_pair(lms, _budget(lms, 0.2), max_plans=2)
    _run(ref, ours)
    assert ours.stats["evictions"] == ref.stats["evictions"] > 0
    assert len(ours.cache) == len(ref.cache) == 2
    for key in ("cache_hits", "cache_misses", "collections"):
        assert ref.stats[key] == ours.stats[key], key


def test_mimose_degree_fits_like_reference(lms, monkeypatch):
    """A cubic fit: the same predictions from the same samples, and the
    same plans."""
    pin_reference_constants(monkeypatch)
    ref, ours = _keyword_pair(lms, _budget(lms, 0.2), degree=3)
    _run(ref, ours)
    assert ours.estimator.degree == ours.est_output.degree == 3
    for S in (80, 250, 400):
        np.testing.assert_allclose(ours.estimator.predict(B * S),
                                   ref.estimator.predict(B * S), rtol=1e-9)
        np.testing.assert_allclose(ours.est_offload.predict(B * S),
                                   ref.est_offload.predict(B * S),
                                   rtol=1e-9)
