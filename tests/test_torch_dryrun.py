"""The port's dry run against the reference's: the input shapes and
assignment rules, the model FLOPs, the dry-run plan strings, the
per-device counts of a sharded step, the roofline sweep's methods, the
report tables, the entry point and a step sharded over two processes.

CPU, reduced widths, everything on ``meta`` except the two-process step.
A mesh larger than one device needs a process group that large: each
test that builds one makes a ``fake`` group (``dryrun.fake_group``) and
destroys it, and its fixture checks that none is left, so a later test
in this worker sees no group.  The counts are held exactly: on (4, 1)
every matmul runs on a quarter of the batch, the gradients are
all-reduced over the data axis in their parameters' dtype, and ZeRO-1
gathers each updated parameter from its moments' shards.
"""
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config import INPUT_SHAPES as REF_SHAPES
from repro.launch import report as ref_report
from repro.launch.roofline import model_flops_for as ref_model_flops
from repro.launch.roofline import plan_unit_flops as ref_flops
from repro.launch.steps import input_specs as ref_input_specs
from repro.launch.steps import plan_remat_mask as ref_plan_remat_mask
from repro.launch.steps import shape_applicable as ref_applicable
from repro.models.registry import get_config as jax_get_config
from repro_torch.config import INPUT_SHAPES, ShapeConfig
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import MeshUnavailable, make_production_mesh
from repro_torch.launch.roofline import (collective_bytes, model_flops_for,
                                         plan_unit_flops)
from repro_torch.launch.roofline_sweep import _measure, roofline_pair
from repro_torch.launch.steps import (build_setup, count_setup,
                                      input_specs, plan_remat_mask,
                                      shape_applicable)
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.sharding.budget import (MeshBudget,
                                         fixed_train_bytes_per_device)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return env


@contextlib.contextmanager
def _group(n):
    """A fake group of ``n`` ranks for one test; none before, none after."""
    assert not dist.is_initialized()
    with dryrun.fake_group(n):
        yield
    assert not dist.is_initialized()


def _mesh(shape):
    return make_production_mesh(shape=shape, device_type="cpu")


# ---------------------------------------------------------------------------
# the entry point (a subprocess: the fake group is the entry point's)
# ---------------------------------------------------------------------------

def _run_dryrun(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)


def test_dryrun_single_pair_runs():
    p = _run_dryrun("--arch", "mamba2-1.3b", "--shape", "decode_32k")
    assert p.returncode == 0, p.stdout + p.stderr
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec
    assert rec["step"] == "serve_step"
    assert rec["flops_per_dev"] > 0
    assert rec["mesh"] == "16x16"
    assert "sweep clean: 1 ok, 0 skipped" in p.stderr


def test_dryrun_skips_long_decode_for_full_attention():
    rec = dryrun.run_one("yi-9b", "long_500k", multi_pod=False,
                         remat="mimose", zero1=False, seq_parallel=False,
                         logits_f32=True)
    assert rec["status"] == "skipped"
    assert "full-attention" in rec["reason"]
    assert not dist.is_initialized()


def test_mesh_refuses_without_a_group_of_its_size():
    # in THIS process there is no group: the mesh must refuse politely
    assert not dist.is_initialized()
    with pytest.raises(MeshUnavailable, match="needs 256 devices"):
        make_production_mesh()


# ---------------------------------------------------------------------------
# shapes, assignment rules, model FLOPs: the reference's exactly
# ---------------------------------------------------------------------------

_PORT_DTYPES = {"tokens": torch.long, "labels": torch.long,
                "lengths": torch.int32, "weights": torch.float32,
                "vision_embeds": torch.float32, "frames": torch.float32}


def test_input_specs_all_pairs_build():
    """Every (arch x shape) either yields the reference's keys and shapes
    (in the port's batch dtypes, on meta) or is the reference's skip."""
    n_ok = n_skip = 0
    for arch in dryrun.ASSIGNED:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            assert (ok, why) == ref_applicable(jcfg, REF_SHAPES[name])
            if not ok:
                assert "full-attention" in why
                n_skip += 1
                continue
            batch = input_specs(cfg, shape)
            ref = ref_input_specs(jcfg, REF_SHAPES[name])
            assert list(batch) == list(ref)
            for k, t in batch.items():
                assert tuple(t.shape) == tuple(ref[k].shape), (arch, name, k)
                assert t.dtype == _PORT_DTYPES[k] and t.is_meta
            n_ok += 1
    assert n_ok + n_skip == 40
    assert n_skip == 7        # 7 pure-full-attention archs skip long_500k


def test_param_counts_and_model_flops_match_reference():
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert cfg.param_count() == jcfg.param_count(), arch
        assert cfg.active_param_count() == jcfg.active_param_count(), arch
        assert (cfg.is_decoder_only(), cfg.uses_attention(),
                cfg.subquadratic()) == (jcfg.is_decoder_only(),
                                        jcfg.uses_attention(),
                                        jcfg.subquadratic())
    pairs = 0
    for arch in dryrun.ASSIGNED:
        for name in INPUT_SHAPES:
            assert model_flops_for(get_config(arch), INPUT_SHAPES[name]) \
                == ref_model_flops(jax_get_config(arch), REF_SHAPES[name])
            pairs += 1
    assert pairs == 40


def test_lm_switches_match_reference():
    """``logits_f32`` off keeps bf16 logits and ``last_logits_only``
    gives the last position's, as the reference's switches do; the
    defaults leave the forward as it was (fp32, every position)."""
    from repro_torch.models.lm import LM
    cfg = get_config("qwen3_1p7b").reduced()          # bf16
    lm = LM(cfg, device="cpu", seed=0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    with torch.no_grad():
        full = lm(batch)
        lm.logits_f32 = False
        low = lm(batch)
        lm.logits_f32, lm.last_logits_only = True, True
        last = lm(batch)
    assert full.dtype == torch.float32 and full.shape == (2, 16,
                                                          cfg.vocab_size)
    assert low.dtype == torch.bfloat16
    assert torch.equal(low.float(), full)
    assert last.shape == (2, 1, cfg.vocab_size)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-2, atol=1e-2)
    assert lm.act_sharding is None


# ---------------------------------------------------------------------------
# the dry run's plan: the reference's strings on the same vectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_mb,offload", [(1, False), (4, False),
                                            (1, True)])
def test_plan_remat_mask_matches_reference(monkeypatch, max_mb, offload):
    """``plan_remat_mask`` at (4, 2) ZeRO-1 against the reference's, both
    planners fed the same per-device byte vectors (the stub collectors
    of tests/test_torch_sharding.py) at budgets from tight to loose."""
    import jax
    import repro.core.planner as ref_planner
    import repro_torch.core.planner as planner
    from repro.models.lm import build_model
    from repro_torch.models.lm import LM
    from test_torch_sharding import (STUB_REDUCED, FakeMesh,
                                     MeshStubCollector, _stub_batches)
    from torch_pins import pin_reference_constants
    pin_reference_constants(monkeypatch)
    jlm = build_model(jax_get_config("bert_base_paper").reduced(
        **STUB_REDUCED))
    jparams = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    lm = LM(get_config("bert_base_paper").reduced(**STUB_REDUCED),
            device="cpu")
    monkeypatch.setattr(ref_planner, "ShuttlingCollector",
                        lambda m, mesh_budget=None:
                        MeshStubCollector(m, ref_flops))
    monkeypatch.setattr(planner, "ShuttlingCollector",
                        lambda m, mesh_budget=None:
                        MeshStubCollector(m, plan_unit_flops))
    shape = {"data": 4, "model": 2}
    fixed = fixed_train_bytes_per_device(
        lm, MeshBudget.from_shape((4, 2), 1.0, zero1=True), scanned=False)
    jb, tb = _stub_batches(256)
    act = float(MeshStubCollector(lm, plan_unit_flops).collect(tb)
                .device_activation_vector().sum())
    masks = set()
    for frac in (0.05, 0.3, 0.6, 1.5):
        hbm = fixed + frac * act
        kw = dict(mode="mimose", zero1=True, hbm_per_chip=hbm,
                  offload=offload, max_microbatches=max_mb)
        want = ref_plan_remat_mask(jlm, jparams, jb, mesh=FakeMesh(shape),
                                   **kw)
        got = plan_remat_mask(
            lm, tb, mesh=MeshBudget.from_shape((4, 2), hbm), **kw)
        assert tuple(int(a) for a in got[0]) == \
            tuple(int(a) for a in want[0]), frac
        assert got[1] == want[1]
        masks.add(tuple(int(a) for a in got[0]))
    assert len(masks) > 1                 # the budgets reach other plans
    n = lm.num_plan_units()
    for mode, want in (("none", (0,) * n), ("all", (1,) * n)):
        got = plan_remat_mask(lm, tb, mode=mode, mesh=None)
        assert (tuple(int(a) for a in got[0]), got[1]) == (want, 1)
    with pytest.raises(ValueError, match="actions for"):
        plan_remat_mask(lm, tb, mode=(0, 1), mesh=None)


# ---------------------------------------------------------------------------
# one device's counts of a sharded step (fake groups, meta shards)
# ---------------------------------------------------------------------------

QWEN3 = dict(dtype="float32")
SMALL = ShapeConfig("train_small", 64, 8, "train")


def _counts(shape, cfg=None, **kw):
    cfg = cfg or get_config("qwen3_1p7b").reduced(**QWEN3)
    setup = build_setup(cfg, SMALL, _mesh(shape), remat="none", **kw)
    counts = count_setup(setup, _mesh(shape))
    return setup, counts, collective_bytes(counts.collectives)


def test_counts_per_device_on_a_data_mesh():
    """(4, 1): a quarter of the one-device FLOPs, the gradients
    all-reduced in their parameters' bytes (and one fp32 scalar: the
    loss's token count summed over the data shards); with ZeRO-1 the
    parameters gathered back from the moments' shards, in their own
    bytes, and the moments a quarter of their size per device."""
    with _group(4):
        _, one, coll_one = _counts((1, 1))
        setup, four, coll = _counts((4, 1))
        params = setup.args[0]
        pbytes = sum(p.numel() * p.element_size() for p in params.values())
        assert coll_one == {}
        assert four.flops * 4 == one.flops > 0
        assert coll == {"all-reduce": pbytes + 4}
        z_setup, z, z_coll = _counts((4, 1), zero1=True)
        assert z.flops == four.flops
        assert z_coll == {"all-reduce": pbytes + 4, "all-gather": pbytes}
        moments = 2 * 4 * sum(p.numel() for p in params.values())
        assert four.arg_bytes - z.arg_bytes == moments * 3 / 4
        assert 0 < z.temp_bytes and 0 < z.bytes < four.bytes


def test_counts_per_device_on_a_tensor_parallel_mesh():
    """(4, 2) and (1, 2): each device's matmuls are an eighth and a half
    of the one-device FLOPs (Megatron's split of the heads, the MLP and
    the vocabulary), and every collective is an all-reduce."""
    with _group(8):
        _, one, _ = _counts((1, 1))
        _, eight, coll = _counts((4, 2))
        _, two, coll2 = _counts((1, 2))
    assert eight.flops * 8 == two.flops * 2 == one.flops
    assert set(coll) == set(coll2) == {"all-reduce"}


def test_remat_policy_is_refused():
    cfg = get_config("qwen3_1p7b").reduced(**QWEN3)
    with pytest.raises(ValueError, match="no torch counterpart"):
        build_setup(cfg, SMALL, None, remat_policy="dots_saveable")


def test_extrapolated_roofline_equals_the_direct_count(monkeypatch):
    """The roofline sweep's two-point extrapolation (models cut to 4 and
    8 layers) gives back the direct count of the whole model: reduced
    qwen3 in scan mode (scan-extrapolated), and reduced gemma3's
    local:global pattern (pattern-composed)."""
    from repro_torch.launch import roofline_sweep
    cases = [("qwen3_1p7b", dict(num_layers=10, scan_chunks=5,
                                 remat_mode="scan", vocab_size=256)),
             ("gemma3_12b", dict(num_layers=5, remat_mode="scan",
                                 vocab_size=256))]
    with _group(256):
        mesh = _mesh((16, 16))
        for arch, over in cases:
            cfg = get_config(arch).reduced(**over)
            monkeypatch.setattr(roofline_sweep, "get_config",
                                lambda _, c=cfg: c)
            rec = roofline_pair(arch, "train_4k")
            assert rec["status"] == "ok", rec
            direct = _measure(cfg, INPUT_SHAPES["train_4k"], mesh,
                              remat="all")
            assert rec["flops_per_dev"] == direct["flops"] > 0
            assert rec["bytes_per_dev"] == direct["bytes"]
            assert rec["coll_bytes_per_dev"] == direct["coll"]
            assert rec["method"] == ("pattern-composed(all-local,all-global)"
                                     if arch == "gemma3_12b" else
                                     "scan-extrapolated(K=4,8)")


# ---------------------------------------------------------------------------
# the report's tables: the reference's text on the same records
# ---------------------------------------------------------------------------

def _records():
    ok = {"arch": "qwen3_1p7b", "shape": "train_4k", "mesh": "16x16",
          "status": "ok", "step": "train_step", "compile_s": 6.3,
          "temp_gib_per_dev": 184.29, "arg_gib_per_dev": 1.0,
          "remat_mask": "0101x2", "t_compute_ms": 1.5, "t_memory_ms": 2.5,
          "t_collective_ms": 0.5, "bottleneck": "memory",
          "useful_flops_ratio": 0.786, "mfu_bound": 0.2}
    return [dict(ok, compile_s=1.0), ok,
            {"arch": "yi_9b", "shape": "long_500k", "mesh": "16x16",
             "status": "skipped", "reason": "skipped: pure full-attention"},
            {"arch": "kimi_k2_1t_a32b", "shape": "train_4k",
             "mesh": "2x16x16", "status": "error", "error": "x" * 80}]


@pytest.mark.parametrize("kind", ["dryrun", "roofline"])
def test_report_tables_match_reference(tmp_path, kind):
    path = tmp_path / "recs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    assert report.load(str(path)) == ref_report.load(str(path))
    assert len(report.load(str(path))) == 3
    outs = []
    for main in (report.main, None):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if main is None:
                argv = sys.argv
                sys.argv = ["report", str(path), "--kind", kind]
                try:
                    ref_report.main()
                finally:
                    sys.argv = argv
            else:
                main([str(path), "--kind", kind])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") == 5


# ---------------------------------------------------------------------------
# a step sharded over two processes
# ---------------------------------------------------------------------------

_TWO = """
import os, sys, json, torch, torch.distributed as dist
from repro_torch.config import ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_setup, place
from repro_torch.models.registry import get_config
from repro_torch.sharding import specs as SP
torch.manual_seed(0)
torch.set_num_threads(1)
rank, shape = int(sys.argv[1]), tuple(int(x) for x in sys.argv[2].split("x"))
dist.init_process_group("gloo", init_method=sys.argv[3], rank=rank,
                        world_size=shape[0] * shape[1])
cfg = get_config("qwen3_1p7b").reduced(dtype="float32")
mesh = make_production_mesh(shape=shape, device_type="cpu")
setup = build_setup(cfg, ShapeConfig("t", 32, 4, "train"), mesh,
                    remat="none", device="cpu", seed=0)
params, opt_state = setup.args[0], setup.args[1]
g = torch.Generator().manual_seed(1)
B, S = 4, 32
batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
         "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
         "weights": torch.ones((B, S)),
         "lengths": torch.tensor([32, 20, 32, 9], dtype=torch.int32)}
losses = []
for _ in range(2):
    b = place(batch, SP.batch_shardings(batch, mesh), mesh)
    params, opt_state, loss = setup.fn(params, opt_state, b)
    losses.append(float(loss.full_tensor()))
full = {n: p.full_tensor() for n, p in params.items()}
if rank == 0:
    torch.save({"losses": losses, "params": full}, sys.argv[4])
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sharded_run(shape, out, deadline):
    n = shape[0] * shape[1]
    url = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO, str(r), f"{shape[0]}x{shape[1]}", url,
         str(out)], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    return torch.load(out)


def test_two_process_steps_match_one_process(tmp_path):
    """Two train steps of reduced qwen3 (fp32, no remat) on gloo: data
    over two processes (2, 1) and the heads, MLP and vocabulary over two
    (1, 2), against the one-process (1, 1) step, losses and updated
    parameters within 1e-5; the three runs within 120 s."""
    deadline = time.monotonic() + 120
    one = _sharded_run((1, 1), tmp_path / "one.pt", deadline)
    for shape in ((2, 1), (1, 2)):
        got = _sharded_run(shape, tmp_path / f"{shape}.pt", deadline)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5,
                                   atol=1e-5)
        for n, p in one["params"].items():
            torch.testing.assert_close(got["params"][n], p, rtol=1e-5,
                                       atol=1e-5, msg=f"{shape} {n}")
