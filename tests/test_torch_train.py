"""The port's trainer and launcher, and the port's import rule.

Four seeded steps of the port's ``Trainer`` (CPU, reduced
``bert_base_paper``, converted params, ``swag`` batches) against the
reference's ``Trainer``.  Tolerance on each step's loss: rtol 2e-5.
Step 1 differs only by fp32 summation order (~1e-6); later steps add
AdamW's update of grads that differ in their last bits.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.planner import MimosePlanner as JaxMimose
from repro.data.pipeline import make_batches as jax_make_batches
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch import bridge
from repro_torch.core.planner import MimosePlanner, fixed_train_bytes
from repro_torch.data.pipeline import make_batches
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
REDUCED = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512,
               dtype="float32")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    return env


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_trainer_losses_match_reference(impl):
    steps, bs = 4, 4
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config("bert_base_paper").reduced(**REDUCED),
            attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    # a budget that forces some units to REMAT on both sides (values do
    # not depend on the plan)
    budget = fixed_train_bytes(lm.parameters()) + 2e6

    jtr = JaxTrainer(jlm, JaxMimose(jlm, budget, quantum=32,
                                    warmup_samples=2),
                     JaxAdamW(lr=jax_cosine(1e-3, 2, steps)))
    jp = jax.tree_util.tree_map(lambda a: a.copy(), params)
    jstate = jtr.optimizer.init(jp)
    want = []
    for b in jax_make_batches("swag", batch_size=bs, vocab_size=512,
                              num_batches=steps, quantum=32, seed=0):
        jp, jstate, loss = jtr.step(jp, jstate, b)
        want.append(loss)

    planner = MimosePlanner(lm, budget, quantum=32, warmup_samples=2)
    tr = Trainer(lm, planner, AdamW(lr=cosine_schedule(1e-3, 2, steps)))
    tr.run(make_batches("swag", batch_size=bs, vocab_size=512,
                        num_batches=steps, quantum=32, seed=0))
    got = [s.loss for s in tr.history]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert any(s.remat_units for s in tr.history)
    assert got[-1] < got[0]


def test_launcher_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "3"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "summary:" in res.stdout


@pytest.mark.parametrize("arch,impl", [("hymba_1p5b", "xla"),
                                       ("granite-moe-1b-a400m", "flash")])
def test_launcher_runs_new_families_on_cpu(arch, impl):
    """``--arch`` takes a registered id or its dashed name, and
    ``--reduced`` cuts the hybrid and MoE families to CPU size; the step
    lines carry ce and aux (granite's aux > 0).  (hymba's flash route on
    the CPU runs the SSD scan's sequential plain version, which
    ``tests/test_torch_hybrid.py`` covers at a smaller size.)"""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--arch", arch, "--attn-impl", impl, "--steps", "2",
         "--batch-size", "4", "--budget-mb", "60"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "summary:" in res.stdout
    steps = [ln for ln in res.stdout.splitlines()
             if ln.startswith("step ") and ln.split()[1].isdigit()]
    assert len(steps) == 2
    aux = [float(ln.split(" aux ")[1].split(")")[0]) for ln in steps]
    assert all(a > 0 for a in aux) == arch.startswith("granite")


def test_launcher_trains_kimi_only_reduced():
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "kimi-k2-1t-a32b", "--device", "cpu",
                           "--steps", "1"])


def test_launcher_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])


def test_port_imports_nothing_of_jax_or_the_reference():
    """Import every module of ``repro_torch`` in a fresh interpreter and
    check that neither ``jax`` nor ``repro`` (nor ``msgpack``, which the
    card's machine lacks) was loaded, and that no import made a process
    group (the dry run makes its fake one in its entry point only)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import made a group'\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith(('jax.', 'jaxlib')) or n == 'repro' "
        "or n.startswith('repro.') or n == 'msgpack')\n"
        "print(' '.join(n for n in sys.modules "
        "if n.startswith('repro_torch')))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = set(res.stdout.split())
    assert len(loaded) >= 20
    # the planner's decision space, host offload, telemetry, the MoE
    # and hybrid families (with their configs) and sharding are reached
    # by the walk
    assert {"repro_torch.core.simulator", "repro_torch.core.solver",
            "repro_torch.models.moe", "repro_torch.models.hymba",
            "repro_torch.configs.granite_moe_1b_a400m",
            "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.configs.hymba_1p5b",
            "repro_torch.configs.qwen3_1p7b", "repro_torch.configs.yi_9b",
            "repro_torch.core.baselines", "repro_torch.train.accumulate",
            "repro_torch.launch.calibrate", "repro_torch.train.transfer",
            "repro_torch.launch.bench_offload_bw",
            "repro_torch.launch.report", "repro_torch.obs",
            "repro_torch.obs.metrics", "repro_torch.obs.events",
            "repro_torch.obs.tracing", "repro_torch.train.checkpoint",
            "repro_torch.train.resilience", "repro_torch.sharding",
            "repro_torch.sharding.budget", "repro_torch.sharding.specs",
            "repro_torch.launch.mesh", "repro_torch.launch.steps",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline_sweep",
            "repro_torch.sharding.dtensor"} <= loaded
