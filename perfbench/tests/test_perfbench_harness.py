"""The harness on the CPU: discovery by name, the contract's characters,
no JAX, the work counters, the readers' arithmetic, the traffic and the
trace reduction."""
import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from pbench import flops, runner, stats, trace
from pbench.traffic import Mix, bucket_length

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_are_found_by_name(cell):
    c = runner.load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["config"] == w["config"]
    assert c.workload["traffic"] == w["traffic"]
    assert c.workload["why"] == w["why"]
    assert c.config["name"] == w["config"]
    assert c.mix.name == w["traffic"]
    runner.reference_module(c).param_spec(c.model)
    kinds = {m["kind"] for m in c.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    assert "setup_s" in {m["name"] for m in c.metrics}


@pytest.mark.parametrize("metric", [m["name"] for m in ALL_METRICS])
def test_every_metric_has_a_reader(metric):
    mod = runner.load_reader(metric)
    assert callable(mod.read)


def test_configuration_files_are_the_named_ones():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert Path(c["file"]).parts[0] in BENCH["paths"]


def test_names_units_and_lines_use_the_allowed_characters():
    names = ([m["name"] for m in ALL_METRICS]
             + [w["name"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in ALL_METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    lines = ([w["why"] for w in BENCH["workloads"]]
             + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    for s in lines:
        assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    for f in PERFBENCH.rglob("*"):
        if "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f.name), f


def test_benchmark_keys_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in ALL_METRICS]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for f in PERFBENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f
    # the references import nothing of the program either
    for f in (PERFBENCH / "references").glob("*.py"):
        assert not {m.split(".")[0] for m in _imports(f)} & {"repro_torch"}


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run on the CPU (tiny cell) in a fresh process, then the
    top-level names of every loaded module, compared whole."""
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(PERFBENCH)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from pbench import runner\n"
        f"cell = runner.load_cell('tiny-dense', bench_path=Path('none'), "
        f"directory=Path({str(PERFBENCH / 'tests' / 'tiny')!r}))\n"
        "out = runner.run(cell, seed=3, seconds=0, trace=False, "
        "t0=time.perf_counter(), device='cpu', log=lambda s: None)\n"
        "print(json.dumps({'correct': out['correct'], "
        "'loaded': runner.forbidden_modules(), 'torch': "
        "'repro_torch' in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "loaded": [], "torch": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", SimpleNamespace())
    assert "repro" not in runner.forbidden_modules() or "repro" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax.numpy", SimpleNamespace())
    assert "jax" in runner.forbidden_modules()


def test_run_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, str(PERFBENCH / "run.py"), "--workload",
         "stablelm3b-squad-tight", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""


# -- the work counters ------------------------------------------------------

DENSE = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2,
         "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "mlp_act": "swiglu",
         "vocab_size": 10}
SSM = {"family": "ssm", "num_layers": 1, "d_model": 4, "d_ff": 0,
       "vocab_size": 10, "ssm_state": 2, "ssm_head_dim": 2, "ssm_expand": 2,
       "ssm_chunk": 4, "conv_kernel": 4}


def test_dense_flops_against_a_hand_count():
    S = 3
    # q 2*3*8*8, k and v 2*2*3*8*4, o 2*3*8*8, scores and values
    # 4*2*4*(9/2), MLP 2*3*8*16*3
    attn = 384 + 384 + 384 + 144
    mlp = 2304
    assert flops.layer_fwd_flops(DENSE, S) == attn + mlp
    head = 2 * 3 * 8 * 10
    assert flops.sequence_train_flops(DENSE, S) == 3 * (2 * (attn + mlp)
                                                        + head)
    assert flops.step_train_flops(DENSE, [3, 3]) == \
        2 * flops.sequence_train_flops(DENSE, 3)


def test_ssm_flops_against_a_hand_count():
    # H = 4, per position 2*Q*N + H*(2*Q*P + 4*P*N) = 16 + 4*(16 + 16)
    assert flops.ssd_flops_per_position(SSM) == 144
    S = 5
    proj = 2 * S * 4 * (16 + 4 + 4) + 2 * S * 8 * 4
    conv = 2 * S * 4 * 12
    assert flops.layer_fwd_flops(SSM, S) == proj + conv + S * 144


# d 4 for the mixers side by side: attention of 2 heads (1 KV) of 2, the
# SSM dict's SSD shape, a SwiGLU MLP of 8
SMALL = dict(SSM, num_heads=2, num_kv_heads=1, head_dim=2, d_ff=8)
LOCAL = dict(DENSE, sliding_window=2, global_interval=2)
MOE = dict(DENSE, family="moe", num_experts=4, experts_per_token=2,
           moe_d_ff=6)
# at S 3: attention q, k and v, o 96 each and scores 4*2*2*(9/2) 72;
# the SSD mixer 768 + 288 + 432 (test_ssm_flops_against_a_hand_count);
# the MLP 2*3*4*8*3 576; the head 2*3*4*10 240
ATTN3, SSD3, MLP3, HEAD3 = 360, 1488, 576, 240


@pytest.mark.parametrize("m, S, layer, want", [
    # a local layer under a window of 2: 9/2 - (3 - 2)^2/2 = 4 pairs,
    # scores 4*2*4*4; projections 1152, MLP 2304
    (LOCAL, 3, 0, 1152 + 128 + 2304),
    # every second layer is global: 9/2 pairs
    (LOCAL, 3, 1, 1152 + 144 + 2304),
    # no longer than the window: a local layer is the causal count
    (LOCAL, 2, 0, flops.layer_fwd_flops(DENSE, 2)),
    # S 10 over W 4: 100/2 - 36/2 = 32 pairs
    (dict(LOCAL, sliding_window=4, global_interval=0), 10, 1,
     flops.layer_fwd_flops(DENSE, 10) - 4 * 2 * 4 * (50 - 32)),
    # hymba: attention and the SSD mixer in parallel, then the MLP
    (dict(SMALL, family="hybrid"), 3, 0, ATTN3 + SSD3 + MLP3),
    # MoE: attention 1296, router 2*3*8*4, two experts 2*(2*3*8*6*3);
    # d_ff 16 is not run
    (MOE, 3, 0, 1296 + 192 + 2 * 864),
    # and a shared expert of 5: 2*3*8*5*3
    (dict(MOE, shared_expert_d_ff=5), 3, 0, 1296 + 192 + 2 * 864 + 720),
    (dict(SMALL, num_layers=3, layer_types=["mamba", "attention", "mamba"]),
     3, 1, ATTN3 + MLP3),
    (dict(SMALL, num_layers=3, layer_types=["mamba", "attention", "mamba"]),
     3, 2, SSD3 + MLP3),
])
def test_layer_flops_against_hand_counts(m, S, layer, want):
    assert flops.layer_fwd_flops(m, S, layer) == want


def test_a_stack_of_mixed_layers_sums_its_layers():
    m = dict(SMALL, num_layers=3, layer_types=["mamba", "attention", "mamba"])
    assert flops.layer_kinds(m) == ["mamba", "attention", "mamba"]
    assert flops.sequence_train_flops(m, 3) == \
        3 * (2 * (SSD3 + MLP3) + ATTN3 + MLP3 + HEAD3)
    assert flops.sequence_train_flops(LOCAL, 3) == \
        3 * (3584 + 3600 + 2 * 3 * 8 * 10)
    assert flops.layer_kinds(dict(SMALL, family="hybrid")) == ["hybrid"]
    assert flops.layer_kinds(dict(MOE, num_layers=2)) == ["attention"] * 2


@pytest.mark.parametrize("m, error, says", [
    (dict(DENSE, family="enc"), NotImplementedError, "'enc'"),
    (dict(SMALL, num_layers=2, layer_types=["mamba", "linear_attention"]),
     NotImplementedError, "'linear_attention'"),
    (dict(SMALL, num_layers=2, layer_types=["mamba"]), ValueError, "1 "),
])
def test_an_unknown_layer_kind_raises(m, error, says):
    with pytest.raises(error, match=says):
        flops.sequence_train_flops(m, 3)


def _config_model(name):
    return json.loads((PERFBENCH / "configs" / f"{name}.json")
                      .read_text())["model"]


# granite-4.0-h-micro's shape (its public config.json): 36 Mamba-2 and 4
# attention layers, a SwiGLU MLP of 8192 after each, no window
GRANITE_TYPES = ["attention" if i in (5, 15, 25, 35) else "mamba"
                 for i in range(40)]
GRANITE = {"num_layers": 40, "d_model": 2048, "num_heads": 32,
           "num_kv_heads": 8, "head_dim": 64, "d_ff": 8192,
           "mlp_act": "swiglu", "vocab_size": 100352, "ssm_state": 128,
           "ssm_head_dim": 64, "ssm_expand": 2, "ssm_chunk": 64,
           "conv_kernel": 4, "layer_types": GRANITE_TYPES}


@pytest.mark.parametrize("config, S, want", [
    ("stablelm_3b", 153, 2459198914560.0),
    ("stablelm_3b", 330, 5332864204800.0),
    ("stablelm_3b", 512, 8319821414400.0),
    ("mamba2_1p3b", 153, 1291197874176.0),
    ("mamba2_1p3b", 330, 2784936591360.0),
    ("mamba2_1p3b", 512, 4320871317504.0),
    ("granite", 330, 6417384652800.0),
])
def test_frozen_sequence_totals(config, S, want):
    m = GRANITE if config == "granite" else _config_model(config)
    assert flops.sequence_train_flops(m, S) == want


@pytest.mark.parametrize("config", ["stablelm_3b", "mamba2_1p3b", "granite"])
def test_the_order_of_the_layers_sum_changes_no_bit(config):
    m = GRANITE if config == "granite" else _config_model(config)
    for S in (153, 330, 512):
        per = [flops.layer_fwd_flops(m, S, i) for i in range(m["num_layers"])]
        assert all(x == int(x) and x < 2**53 for x in per)
        head = 2.0 * S * m["d_model"] * m["vocab_size"]
        for order in (per, per[::-1]):
            total = 0.0
            for x in order:
                total += x
            assert 3.0 * (total + head) == flops.sequence_train_flops(m, S)


def test_flash_and_ssd_call_work():
    # H 2, Hkv 1, hd 4, bf16, true lengths 3 and 1: 6 + 1 causal pairs
    f, b = flops.flash_call_work(2, 1, 4, 2, [3, 1], False)
    assert f == 4 * 2 * 4 * 7
    q, kv, lse = 4 * 2 * 4 * 2, 4 * 1 * 4 * 2, 4 * 2 * 4
    assert b == q + 2 * kv + q + lse
    fb, bb = flops.flash_call_work(2, 1, 4, 2, [3, 1], True)
    assert fb == 2.5 * f and bb > b
    sf, sb = flops.ssd_call_work(SSM, 2, [5], False)
    assert sf == 5 * 144
    assert sb == (5 * 4 * 2 * 2) * 2 + 5 * 4 * 4 + 2 * 5 * 2 * 2
    assert flops.ssd_call_work(SSM, 2, [5], True)[0] == 2 * sf
    assert flops.roofline_s(1e12, 1.0, 1e12, 1.0) == 1.0
    assert flops.roofline_s(1.0, 2e9, 1e12, 1e9) == 2.0


# -- the readers' arithmetic ------------------------------------------------

def _record(steps, window_s=2.0, oom=0):
    cfg = json.loads((PERFBENCH / "configs" / "stablelm_3b.json")
                     .read_text())
    cell = SimpleNamespace(model=cfg["model"], config=cfg)
    return SimpleNamespace(cell=cell, window=steps, window_s=window_s,
                           setup_s=5.0, oom_events=oom, peak_bytes=2**31,
                           trace=None, stretch=[])


def _step(lengths, S, host_s, remat=0, peak=100, predicted=80, ok=True):
    st = SimpleNamespace(tokens=sum(lengths), padded_tokens=len(lengths) * S,
                         recompute_layers=remat, max_memory_bytes=peak,
                         predicted_peak_bytes=predicted)
    return runner.StepRecord(ok, host_s, list(lengths), 1.0 if ok else None,
                             st if ok else None)


def test_readers_arithmetic():
    steps = [_step([30, 20], 32, 0.1, remat=4, peak=120, predicted=100),
             _step([10, 10], 16, 0.3, remat=0, peak=90, predicted=100),
             _step([5, 5], 8, 0.5, ok=False)]
    run = _record(steps, window_s=2.0, oom=3)
    read = lambda n: runner.load_reader(n).read(run)
    assert read("tokens_per_s") == pytest.approx(70 / 2.0)
    assert read("pad_fraction") == pytest.approx(1 - 70 / 96)
    assert read("recompute_layers_per_step") == pytest.approx(2.0)
    assert read("peak_over_predicted") == pytest.approx(1.2)
    assert read("oom_retries") == 3
    assert read("step_ms_p90") == pytest.approx(500.0)
    assert read("peak_mem_gib") == pytest.approx(2.0)
    assert read("setup_s") == 5.0
    m = run.cell.model
    want = (flops.step_train_flops(m, [30, 20])
            + flops.step_train_flops(m, [10, 10])) / (2.0 * 989e12)
    assert read("mfu") == pytest.approx(want)
    for name in ("device_idle_frac", "step_mfu", "flash_roofline",
                 "ssd_roofline"):
        assert read(name) is None          # nothing traced: no reading


def test_nearest_rank_percentile():
    xs = list(range(1, 11))
    assert stats.nearest_rank(xs, 0.9) == 9
    assert stats.nearest_rank(xs, 0.5) == 5
    assert stats.nearest_rank([7.0], 0.9) == 7.0
    assert stats.nearest_rank(list(range(1, 21)), 0.9) == 18


def test_traced_readers():
    calls = [trace.Call("flash", "fwd", [[(1, 2, 4, 4), "torch.bfloat16",
                                          None],
                                         [(1, 1, 4, 4), "torch.bfloat16",
                                          None],
                                         [(1, 1, 4, 4), "torch.bfloat16",
                                          None], [(1,), "torch.int32", [3]]])]
    td = trace.TraceData(window_s=2.0, busy_s=1.5, tagged_s={"flash": 1e-9},
                         calls=calls, device_ops=[], idle_gaps=[],
                         n_device_events=1)
    run = _record([_step([3], 4, 0.1)])
    run.trace, run.stretch = td, [_step([3], 4, 0.1)]
    read = lambda n: runner.load_reader(n).read(run)
    assert read("device_idle_frac") == pytest.approx(0.25)
    f, b = flops.flash_call_work(2, 1, 4, 2, [3], False)
    want = 100 * flops.roofline_s(f, b, 989e12, 3.35e12) / 1e-9
    assert read("flash_roofline") == pytest.approx(want)
    assert read("ssd_roofline") is None
    assert read("step_mfu") == pytest.approx(
        100 * flops.step_train_flops(run.cell.model, [3]) / (2.0 * 989e12))


def test_mfu_readers_sum_a_mixed_stack_layer_by_layer():
    m = dict(SMALL, num_layers=3, layer_types=["mamba", "attention", "mamba"])
    run = _record([_step([3, 3], 4, 0.1)], window_s=2.0)
    run.cell.model = m
    run.stretch = [_step([3, 3], 4, 0.1)]
    run.trace = trace.TraceData(window_s=2.0, busy_s=1.0, tagged_s={},
                                calls=[], device_ops=[], idle_gaps=[],
                                n_device_events=1)
    # two sequences of 3: 2 * 3 * (2 * mamba + attention + head)
    flops_ = 2 * 3 * (2 * (SSD3 + MLP3) + ATTN3 + MLP3 + HEAD3)
    read = lambda n: runner.load_reader(n).read(run)
    assert read("mfu") == flops_ / (2.0 * 989e12)
    assert read("step_mfu") == 100.0 * flops_ / (2.0 * 989e12)


def test_trace_union_and_innermost():
    assert trace._union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    events = [(0, 100, "step"), (10, 20, "a"), (30, 60, "b"), (40, 50, "c")]
    assert trace._innermost(events, [5, 15, 25, 45, 55, 150]) == \
        ["step", "a", "step", "c", "b", None]


# -- the traffic --------------------------------------------------------------

def test_traffic_gives_every_seed_the_same_sizes():
    mix = Mix.load("squad")
    assert mix.quantum == 32 and mix.buckets() == list(range(160, 513, 32))
    a = next(mix.window_batches(2**31 + 11, 1000))
    b = next(mix.window_batches(2**31 + 11, 1000))
    c = next(mix.window_batches(7, 1000))
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    key = lambda bs: sorted(tuple(sorted(x["lengths"])) for x in bs)
    assert key(a) == key(c) and len(a) == 16
    assert any((x["lengths"] != y["lengths"]).any() for x, y in zip(a, c))
    for x in a:
        S = x["tokens"].shape[1]
        assert S == bucket_length(x["lengths"].max(), 32)
        assert (x["weights"].sum(1) == x["lengths"]).all()
        assert len({tuple(r) for r in x["tokens"]}) == 8   # rows differ
        assert x["lengths"].min() >= 153 and x["lengths"].max() <= 512


def test_each_pair_of_configuration_and_traffic_is_one_cell():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_the_roomy_mix_is_the_squad_mix_under_its_own_name():
    squad, roomy = Mix.load("squad"), Mix.load("squad_roomy")
    drop = lambda spec: {k: v for k, v in spec.items()
                         if k not in ("name", "about")}
    assert roomy.name == "squad_roomy" and drop(roomy.spec) == drop(squad.spec)
    seed = 2**31 + 5
    pairs = (list(zip(squad.warmup_batches(seed, 1000),
                      roomy.warmup_batches(seed, 1000)))
             + list(zip(next(squad.window_batches(seed, 1000)),
                        next(roomy.window_batches(seed, 1000)))))
    for a, b in pairs:
        assert all((a[k] == b[k]).all() for k in a)


def test_warmup_covers_the_windows_buckets_likeliest_first():
    mix = Mix.load("squad")
    warm = mix.warmup_batches(5, 1000)
    used = mix.window_buckets()
    assert used == sorted({bucket_length(x.max(), 32) for x in mix.cycle()})
    assert set(used) < set(mix.buckets())
    n = len(used)
    cycle = [tuple(x) for x in mix.cycle()]
    assert [tuple(b["lengths"]) for b in warm[n:]] == cycle
    warm = warm[:n]
    got = [b["tokens"].shape[1] for b in warm]
    assert sorted(got) == used
    odds = mix.bucket_odds()
    assert [odds[S] for S in got] == sorted((odds[S] for S in used),
                                            reverse=True)
    assert got[0] in (384, 416, 448)
    other = mix.warmup_batches(6, 1000)[:n]
    assert [b["tokens"].shape[1] for b in other] == got
    assert any((x["tokens"] != y["tokens"]).any() for x, y in zip(warm, other))
    assert all(np.isin(b["lengths"], np.arange(153, 513)).all() for b in warm)
    assert math.isclose(sum(odds.values()), 1.0)


class _Event:
    def __init__(self, name, start, end, tid=1, device=False):
        self._n, self._s, self._e, self._t = name, start, end, tid
        self._d = device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def start_thread_id(self):
        return self._t

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_span_time_is_the_operations_inside_the_range_less_its_markers():
    ev = [_Event(trace.STRETCH, 0, 1000), _Event(trace.STEP, 10, 990),
          _Event("aten::mm", 20, 30), _Event("perfbench.flash.fwd", 40, 60),
          # on the device: the range laid over its kernels, markers first
          # and last, a kernel launched outside the range
          _Event("perfbench.flash.fwd", 100, 400, device=True),
          _Event("marker", 100, 110, device=True),
          _Event("flash_fwd_tc_kernel", 120, 300, device=True),
          _Event("copy", 310, 350, device=True),
          _Event("marker", 390, 400, device=True),
          _Event("gemm", 500, 700, device=True)]
    tagged, ops, idle = trace.spans(_prof(ev))
    assert tagged == {"flash": pytest.approx(220e-9)}
    assert ops["flash"][0] == ["flash_fwd_tc_kernel", pytest.approx(180e-9)]
    # idle: 0-100, 110-120, 300-310, 350-390, 400-500, 700-1000
    assert sum(v for _, v in idle) == pytest.approx(560e-9)
    window_s, clock, busy_s, top, n = trace.busy(_prof(ev[5:]), 1.0)
    assert window_s == 1.0 and clock.startswith("host")   # no edges
    assert busy_s == pytest.approx(440e-9) and n == 5
    assert top[0][0] == "gemm"


def test_busy_window_is_between_the_edge_kernels_and_not_cut():
    edge = "spin_kernel(long)"
    ev = [_Event(edge, 100, 101, device=True),
          _Event("gemm", 150, 300, device=True),
          _Event("copy", 250, 400, device=True),
          _Event(edge, 899, 900, device=True)]
    window_s, clock, busy_s, top, n = trace.busy(_prof(ev), 5.0)
    assert window_s == pytest.approx(800e-9) and clock == "trace"
    assert busy_s == pytest.approx(250e-9) and n == 2
    # an operation outside the edges counts, and shows as busy > window
    late = ev + [_Event("late", 1000, 1700, device=True)]
    window_s, _, busy_s, _, _ = trace.busy(_prof(late), 5.0)
    assert busy_s > window_s
    # an edge missed: the host's clock, said so
    window_s, clock, busy_s, _, _ = trace.busy(_prof(ev[:3]), 5.0)
    # the edge traced lies before the first other device event
    assert window_s == 5.0 and clock.startswith("host (1 edge kernels "
                                                "traced, one at -0.0000 s")
    assert busy_s == pytest.approx(250e-9)
