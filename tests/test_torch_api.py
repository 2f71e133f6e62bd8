"""The port's public surface against the reference's.

The Tables 3-4 estimators (``ESTIMATORS``, ``DecisionTreeEstimator``,
``mape``) bitwise against the reference's on the same samples (both are
the same numpy code); ``bucket_edges``, ``epoch_sizes`` and
``all_configs`` equal to the reference's; ``offload_transfer_s``,
``make_serve_step``, ``SnapshotManager.latest`` and ``get_model``; the
package exports of ``repro_torch.core`` and ``repro_torch.models``; the
three examples and ``tools/torch_gen_trace.py``; ``tools/trace_view.py``
on the port launcher's sinks.  CPU only.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.models as ref_models
from repro.core import ShuttlingCollector as RefCollector
from repro.core import estimator as RE
from repro.data import pipeline as RP
from repro.launch import roofline as ref_roofline
from repro.models.lm import build_model as ref_build_model
from repro.models.registry import all_configs as ref_all_configs
from repro.models.registry import get_config as jax_get_config
from repro.train.resilience import SnapshotManager as RefSnapshots
from repro_torch import core as port_core
from repro_torch import models as port_models
from repro_torch.core import estimator as PE
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.data import pipeline as PP
from repro_torch.launch import roofline
from repro_torch.launch import train as launch_train
from repro_torch.models import LM, build_model
from repro_torch.models.registry import all_configs, get_config, get_model
from repro_torch.train import checkpoint
from repro_torch.train.resilience import SnapshotManager
from repro_torch.train.serve import make_serve_step
from torch_pins import pin_reference_constants

REPO = Path(__file__).resolve().parents[1]
REDUCED = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512,
               dtype="float32")
# sizes of benchmarks/table34_estimator.py: 14 sequence lengths, the
# first 10 to fit, the last 4 held out
TABLE_S = np.linspace(32, 352, 14).astype(int)
N_TRAIN = 10


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    # a few threads: the default of one per core oversubscribes a
    # shared host
    env["OMP_NUM_THREADS"] = "2"
    return env


# ---------------------------------------------------------------------------
# the estimators (paper Tables 3-4)
# ---------------------------------------------------------------------------

def _samples(seed: int, repeated: bool, n: int = 12, units: int = 6):
    """(sizes, per-unit byte vectors): quadratic bytes in the size plus
    noise; ``repeated`` draws sizes with repeats."""
    rng = np.random.default_rng(seed)
    if repeated:
        sizes = rng.choice(np.arange(4, 40) * 32, n // 2, replace=False)
        sizes = rng.permutation(np.repeat(sizes, 2))
    else:
        sizes = rng.choice(np.arange(4, 40) * 32, n, replace=False)
    coef = rng.uniform(0.5, 2.0, (units, 3)) * [1.0, 1e3, 1e5]
    acts = [coef[:, 0] * s * s + coef[:, 1] * s + coef[:, 2]
            + rng.normal(0, 1e4, units) for s in sizes]
    return [int(s) for s in sizes], acts


def _fit(make, sizes, acts):
    est = make()
    for s, a in zip(sizes, acts):
        est.add_sample(s, a)
    return est.fit()


def _assert_same(port, ref, sizes, truth):
    probes = sorted(set(sizes)) + [1, 100, 333.5, 4096, 1e6]
    for s in probes:
        np.testing.assert_array_equal(port.predict(s), ref.predict(s))
        assert port.predict_total(s) == ref.predict_total(s)
    assert port.mape(sizes, truth) == ref.mape(sizes, truth)


@pytest.mark.parametrize("repeated", [False, True],
                         ids=["distinct", "repeated"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(RE.ESTIMATORS))
def test_estimators_are_the_references_bitwise(name, seed, repeated):
    assert list(PE.ESTIMATORS) == list(RE.ESTIMATORS)
    sizes, acts = _samples(seed, repeated)
    fit_s, fit_a = sizes[:8], acts[:8]
    port = _fit(PE.ESTIMATORS[name], fit_s, fit_a)
    ref = _fit(RE.ESTIMATORS[name], fit_s, fit_a)
    assert type(port).__name__ == type(ref).__name__
    assert port.ready == ref.ready
    _assert_same(port, ref, sizes[8:], np.stack(acts[8:]))


@pytest.mark.parametrize("min_leaf", [1, 2])
@pytest.mark.parametrize("max_depth", [1, 2, 3, 4])
def test_tree_depths_and_leaves_are_the_references(max_depth, min_leaf):
    sizes, acts = _samples(max_depth + 10 * min_leaf, repeated=False)

    def make(mod):
        return lambda: mod.DecisionTreeEstimator(max_depth=max_depth,
                                                 min_leaf=min_leaf)
    port = _fit(make(PE), sizes[:10], acts[:10])
    ref = _fit(make(RE), sizes[:10], acts[:10])
    _assert_same(port, ref, sizes[10:], np.stack(acts[10:]))
    # constant past the last leaf; each split at a midpoint between
    # distinct sorted sizes
    top = max(sizes[:10])
    np.testing.assert_array_equal(port.predict(top), port.predict(10 * top))
    mids, todo = [], [port._tree]
    while todo:
        node = todo.pop()
        if node[0] == "node":
            mids.append(node[1])
            todo += [node[2], node[3]]
    srt = sorted(set(sizes[:10]))
    halves = {(a + b) / 2 for a, b in zip(srt, srt[1:])}
    assert mids and set(mids) <= halves
    assert len(mids) <= 2 ** max_depth - 1


def test_tree_readiness_and_empty_fit():
    for mod in (PE, RE):
        tree = mod.DecisionTreeEstimator()
        with pytest.raises(RuntimeError, match="no samples"):
            tree.fit()
        tree.add_sample(64, [1.0, 2.0])
        assert not tree.ready
        tree.add_sample(64, [3.0, 4.0])       # two samples, one size
        assert tree.ready
        np.testing.assert_array_equal(tree.predict(1e9), [2.0, 3.0])
    with pytest.raises(RuntimeError, match="no samples"):
        PE.PolyEstimator(2).fit()


@pytest.fixture(scope="module")
def jax_table_vectors():
    """{input size: per-unit bytes} of the reference's collector on
    reduced bert at B 2, the 14 sizes of Table 3."""
    lm = ref_build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    params = lm.init(jax.random.PRNGKey(0))
    col = RefCollector(lm)
    out = {}
    for S in TABLE_S:
        res = col.collect(params, {"tokens": jnp.ones((2, int(S)),
                                                       jnp.int32)})
        out[res.input_size] = res.activation_vector()
    return out


def _table(estimators, data):
    """{name: MAPE on the held-out sizes} of Table 3."""
    sizes = list(data)
    train, test = sizes[:N_TRAIN], sizes[N_TRAIN:]
    truth = np.stack([data[s] for s in test])
    return {name: _fit(make, train, [data[s] for s in train]).mape(
        test, truth) for name, make in estimators.items()}


def test_table3_on_the_reference_vectors_is_the_references(
        jax_table_vectors):
    port, ref = (_table(PE.ESTIMATORS, jax_table_vectors),
                 _table(RE.ESTIMATORS, jax_table_vectors))
    assert port == ref
    assert list(port) == ["poly1", "poly2", "poly3", "tree"]


def test_table3_on_the_ports_collector():
    """The port's collector (meta) on the same sizes: its bytes are
    quadratic in S at a fixed B (the (S, S) scores), so poly2 and poly3
    fit them to rounding, where poly1 and the tree, flat past its last
    leaf, miss the held-out sizes.  This CPU run: poly2 and poly3
    5.7e-16, poly1 0.187, tree 0.303."""
    lm = LM(get_config("bert_base_paper").reduced(**REDUCED), device="meta")
    col = ShuttlingCollector(lm)
    data = {}
    for S in TABLE_S:
        res = col.collect({"tokens": torch.ones((2, int(S)),
                                                 dtype=torch.long)})
        data[res.input_size] = res.activation_vector()
    assert list(data) == [2 * int(S) for S in TABLE_S]
    table = _table(PE.ESTIMATORS, data)
    assert table == _table(RE.ESTIMATORS, data)
    assert table["poly2"] < 1e-12 and table["poly3"] < 1e-12
    assert table["tree"] > 0.25 and table["poly1"] > 0.1
    assert table["poly2"] < table["poly1"] < table["tree"]


# ---------------------------------------------------------------------------
# pipeline, registry, roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantum", [32, 64])
@pytest.mark.parametrize("dataset", list(RP.DISTRIBUTIONS))
def test_bucket_edges_are_the_references(dataset, quantum):
    assert list(PP.DISTRIBUTIONS) == list(RP.DISTRIBUTIONS)
    got = PP.bucket_edges(PP.DISTRIBUTIONS[dataset], quantum)
    assert got == RP.bucket_edges(RP.DISTRIBUTIONS[dataset], quantum)
    assert got[0] >= PP.DISTRIBUTIONS[dataset].lo
    assert all(s % quantum == 0 for s in got)


@pytest.mark.parametrize("dataset", list(RP.DISTRIBUTIONS))
def test_epoch_sizes_are_the_references(dataset):
    for kw in ({}, {"quantum": 64, "seed": 3}):
        got = PP.epoch_sizes(dataset, 4, 12, **kw)
        np.testing.assert_array_equal(got,
                                      RP.epoch_sizes(dataset, 4, 12, **kw))
        assert got.shape == (12,)


def test_all_configs_are_the_references():
    port, ref = all_configs(), ref_all_configs()
    assert list(port) == list(ref)
    for arch in ref:
        for f in dataclasses.fields(ref[arch]):
            assert getattr(port[arch], f.name) == getattr(ref[arch], f.name), \
                (arch, f.name)


def test_get_model_builds_and_refuses_kimi():
    lm = get_model("bert-base-paper", device="cpu")
    ref = ref_build_model(jax_get_config("bert_base_paper"))
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    assert isinstance(lm, LM) and lm.attn_impl == "xla"
    assert sum(p.numel() for p in lm.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(shapes))
    assert lm.device.type == "cpu"
    del lm
    meta = get_model("qwen3-1.7b", "flash", device="meta")
    assert meta.attn_impl == "flash" and meta.embed.is_meta
    with pytest.raises(ValueError, match="reduced"):
        get_model("kimi_k2_1t_a32b", device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model("bert_base_paper")


def test_build_model_is_the_constructor():
    cfg = get_config("bert_base_paper").reduced(**REDUCED)
    a, b = build_model(cfg, device="cpu", seed=3), LM(cfg, device="cpu",
                                                       seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_offload_transfer_s_matches_reference_and_reads_pcie_at_call(
        monkeypatch):
    for b in (0, 1, 12345.0, 2**30):
        assert roofline.offload_transfer_s(b, 1e10) \
            == ref_roofline.offload_transfer_s(b, 1e10)
        assert roofline.offload_transfer_s(b) == 2.0 * b / roofline.PCIE_BW
    pins = pin_reference_constants(monkeypatch)
    assert port_core.offload_transfer_s(3e9) \
        == ref_roofline.offload_transfer_s(3e9) == 6e9 / pins["PCIE_BW"]
    monkeypatch.setattr(roofline, "PCIE_BW", 1e9)
    assert port_core.offload_transfer_s(5e8) == 1.0


# ---------------------------------------------------------------------------
# serving and resilience helpers
# ---------------------------------------------------------------------------

def test_make_serve_step_is_decode_step_on_the_given_params():
    cfg = get_config("qwen3_1p7b").reduced(**REDUCED)
    lm = LM(cfg, device="cpu")
    step = make_serve_step(lm)
    params = dict(lm.named_parameters())
    toks = torch.randint(1, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(0))
    want, c1 = lm.decode_step(toks, lm.init_cache(2, 16), 0)
    got, c2 = step(params, toks, lm.init_cache(2, 16), 0)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for la, lb in zip(c1, c2)
               for a, b in zip(la.values(), lb.values()))
    # the step reads the parameters it is given, not the model's
    other = {n: (t * 0.5 if n == "embed" else t) for n, t in params.items()}
    moved, _ = step(other, toks, lm.init_cache(2, 16), 0)
    assert not torch.equal(moved, want)
    again, _ = lm.decode_step(toks, lm.init_cache(2, 16), 0)
    assert torch.equal(again, want)


def test_snapshot_manager_latest(tmp_path):
    port, ref = SnapshotManager(str(tmp_path)), RefSnapshots(str(tmp_path))
    assert port.latest() is None and ref.latest() is None
    params = {"w": torch.arange(4.0)}
    opt = {"m": torch.zeros(4)}
    for step in (3, 12):
        port.save(step=step, params=params, opt_state=opt)
    os.makedirs(tmp_path / ".tmp-snap-00000020")     # a partial write
    assert port.latest() == str(tmp_path / "snap-00000012")
    assert port.latest() == ref.latest() == port.snapshots()[-1]


# ---------------------------------------------------------------------------
# the package exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_pkg,port_pkg", [(ref_core, port_core),
                                              (ref_models, port_models)],
                         ids=["core", "models"])
def test_public_names_of_the_reference_are_exported(ref_pkg, port_pkg):
    names = [n for n, v in vars(ref_pkg).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    assert len(names) >= (40 if ref_pkg is ref_core else 5)
    missing = [n for n in names if not hasattr(port_pkg, n)]
    assert not missing, missing
    for n in names:
        obj = getattr(port_pkg, n)
        assert obj is not getattr(ref_pkg, n)
        mod = getattr(obj, "__module__", None)
        assert mod is None or mod.startswith("repro_torch."), (n, mod)


def test_a_core_submodule_imports_first_in_a_fresh_interpreter():
    """Importing any ``repro_torch.core`` submodule first runs the
    package's exports, which reach ``launch/roofline.py`` and
    ``sharding/budget.py``; none of them may need a name of the partly
    initialised package.  One interpreter: before each first module,
    every ``repro_torch`` module is dropped from ``sys.modules``, so the
    package imports afresh in that order."""
    code = ("import sys\n"
            "for first in sys.argv[1:]:\n"
            "    for n in [n for n in sys.modules\n"
            "              if n.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[n]\n"
            "    __import__(first)\n"
            "    import repro_torch.core as c\n"
            "    assert c.MeshBudget and c.ESTIMATORS and "
            "c.offload_transfer_s, first\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    firsts = ("repro_torch.core.cache", "repro_torch.launch.roofline",
              "repro_torch.sharding.budget")
    res = subprocess.run([sys.executable, "-c", code, *firsts], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------------------
# the examples and tools
# ---------------------------------------------------------------------------

def test_examples_run_on_cpu_without_jax():
    """The quickstart and both serve modes at their shortest, in one
    fresh interpreter: exit 0, and neither ``jax`` nor ``repro`` loaded."""
    code = (
        "import runpy, sys\n"
        "for argv in (['examples/torch_quickstart.py', '--device', 'cpu',"
        " '--num-batches', '3'],\n"
        "             ['examples/torch_serve_decode.py', '--device', 'cpu',"
        " '--num-requests', '2', '--new-tokens', '3', '--rate-rps', '0'],\n"
        "             ['examples/torch_serve_decode.py', '--device', 'cpu',"
        " '--sequential', '--batch', '2', '--new-tokens', '3']):\n"
        "    sys.argv = argv\n"
        "    runpy.run_path(argv[0], run_name='__main__')\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert out.count("remat=") == 3 and "plans generated: " in out
    assert "| completed / rejected | 2 / 0 |" in out
    assert "generated (2, 3)" in out and "steady-state decode" in out


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_e2e_example_trains_and_saves(monkeypatch, tmp_path, capsys):
    """The end-to-end example with its configuration cut to the reduced
    bert (the full 110M model runs on the card): a step line every 10
    steps, the summary, and a checkpoint that loads back equal."""
    e2e = _example("torch_dynamic_training_e2e")
    full = e2e.get_config("bert_base_paper")
    monkeypatch.setattr(e2e, "get_config",
                        lambda arch: full.reduced(**REDUCED))
    path = str(tmp_path / "final.pt")
    trainer = e2e.main(["--device", "cpu", "--steps", "11",
                        "--budget-gb", "0.01", "--save", path])
    out = capsys.readouterr().out
    assert out.count("  loss ") == 2 and "checkpoint written to" in out
    losses = [s.loss for s in trainer.history]
    assert len(losses) == 11 and np.isfinite(losses).all()
    assert trainer.lm.attn_impl == "flash"
    assert sum(s.remat_units for s in trainer.history) > 0
    back = checkpoint.load(path, trainer.params)
    assert all(torch.equal(back[n], t) for n, t in trainer.params.items())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            e2e.main(["--steps", "1"])


@pytest.mark.parametrize("argv,to_file", [
    ([], False),
    (["--num-requests", "7", "--vocab-size", "100", "--dataset", "squad",
      "--rate-rps", "0", "--min-new-tokens", "4", "--prompt-scale", "0.5",
      "--seed", "3"], True),
], ids=["defaults", "options"])
def test_torch_gen_trace_writes_the_references_bytes(argv, to_file,
                                                     tmp_path):
    """One run of each tool: the defaults to stdout, the options to a
    file given with ``-o``."""
    outs = {}
    for tool in ("torch_gen_trace", "gen_trace"):
        path = tmp_path / f"{tool}.json"
        res = subprocess.run(
            [sys.executable, f"tools/{tool}.py", *argv,
             *(["-o", str(path)] if to_file else [])],
            cwd=REPO, env=_env(), capture_output=True, timeout=120)
        assert res.returncode == 0, res.stderr
        outs[tool] = path.read_bytes() if to_file else res.stdout
    assert outs["torch_gen_trace"] == outs["gen_trace"]
    recs = json.loads(outs["torch_gen_trace"])
    assert recs and {"rid", "arrival_s", "prompt", "max_new_tokens"} \
        == set(recs[0])


def test_trace_view_reads_the_port_launchers_sinks(tmp_path):
    trace, events = tmp_path / "t.json", tmp_path / "ev.jsonl"
    launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                       "--trace-out", str(trace),
                       "--events-out", str(events)])
    spans = subprocess.run([sys.executable, "tools/trace_view.py",
                            str(trace)], cwd=REPO, capture_output=True,
                           text=True, timeout=60)
    assert spans.returncode == 0, spans.stderr
    rows = spans.stdout.splitlines()
    assert rows[0].split()[:3] == ["track", "span", "count"]
    names = {r.split()[1] for r in rows[1:]}
    assert {"plan", "execute"} <= names
    plans = subprocess.run([sys.executable, "tools/trace_view.py",
                            str(events), "--mode", "plans"], cwd=REPO,
                           capture_output=True, text=True, timeout=60)
    assert plans.returncode == 0, plans.stderr
    assert plans.stdout.startswith("plan timeline")
    assert plans.stdout.count(" plan ") >= 1 and "bucket=" in plans.stdout
