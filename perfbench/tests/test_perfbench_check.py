"""The reference check on the CPU: the plain references' gradients
against finite differences, a sound run passing, the control failing,
and a run with the timed path broken underneath failing, once for each
fault a training cell can have (one card: no exchange between chips)."""
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pbench import check, model_init, refcore, runner
from pbench.traffic import Mix
from references import dense_lm, mamba2_lm

TINY = Path(__file__).resolve().parent / "tiny"


def _cell(name):
    return runner.load_cell(name, bench_path=TINY / "none", directory=TINY)


def _run(name, faults=None):
    return runner.run(_cell(name), seed=2**31 + 7, seconds=0, trace=False,
                      t0=time.perf_counter(), device="cpu",
                      log=lambda s: None, faults=faults)


@pytest.mark.parametrize("module,cell", [(dense_lm, "tiny-dense"),
                                         (mamba2_lm, "tiny-ssm")])
def test_reference_gradient_against_finite_differences(module, cell):
    c = _cell(cell)
    spec = module.param_spec(c.model)
    params = {n: t.double().requires_grad_(True) for n, t in
              model_init.weights(spec, 3, "cpu").items()}
    batch = Mix.load("tiny", TINY / "traffic").warmup_batches(3, 256)[0]
    L = int(batch["lengths"][0])
    tok = torch.as_tensor(batch["tokens"][0, :L], dtype=torch.long)
    lab = torch.as_tensor(batch["labels"][0, :L], dtype=torch.long)
    w = torch.ones(L, dtype=torch.float64)
    ein = refcore.einsum_for("fp64")
    loss = module.row_loss(params, c.model, tok, lab, w, ein)
    loss.backward()
    rng = np.random.default_rng(0)
    names = ["embed", "blocks.0.norm1.scale", "final_norm.scale"] + [
        n for n in params if n.endswith(("wq", "mlp.wo", "in_proj",
                                         "A_log", "conv_w"))][:3]
    for name in names:
        p = params[name]
        for _ in range(2):
            idx = tuple(int(rng.integers(s)) for s in p.shape)
            if name == "embed":           # a row the sequence reads
                idx = (int(tok[0]),) + idx[1:]
            h = 1e-6
            with torch.no_grad():
                p[idx] += h
                up = module.row_loss(params, c.model, tok, lab, w, ein)
                p[idx] -= 2 * h
                down = module.row_loss(params, c.model, tok, lab, w, ein)
                p[idx] += h
            fd = float(up - down) / (2 * h)
            assert p.grad[idx].item() == pytest.approx(fd, rel=1e-5,
                                                       abs=1e-8), name


@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-ssm"])
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-ssm"])
def test_control_is_not_correct(cell):
    """The reference in float8, put in the program's place."""
    c = _cell(cell)
    batches = c.mix.warmup_batches(5, c.model["vocab_size"])[:3]
    ref = runner.reference_readings(c, 5, batches, "cpu")
    ctrl = runner.reference_readings(c, 5, batches, "cpu", precision="fp8")
    ok, checks = check.judge(check.compare(ctrl, ref),
                             c.workload["checks"])
    assert not ok, checks


def _state_unchanged(prog):
    # the step computes its gradients and returns the state as it was
    prog.trainer._update = lambda fn, grads, opt_state, *a: (opt_state,
                                                             a[-1])


def _parameters_not_written(prog):
    # AdamW updates its moments and writes the new parameters into
    # copies: the state moves, the model does not
    opt = prog.trainer.optimizer
    apply = opt.apply

    def apply_to_copies(cur, grads, state, params, moments):
        return apply(cur, grads, state,
                     {n: p.detach().clone() for n, p in params.items()},
                     moments)
    object.__setattr__(opt, "apply", apply_to_copies)   # a frozen dataclass


def _half_batch(prog):
    lm = prog.trainer.lm
    full = lm.loss

    def half(batch, actions=None):
        B = batch["tokens"].shape[0]
        return full({k: v[:B // 2] for k, v in batch.items()}, actions)
    lm.loss = half


def _gradient_altered(prog):
    # the largest leaf's gradient doubled where the backward produces it
    tr = prog.trainer
    build = tr._build_step

    def built(actions, microbatch=1):
        fn = build(actions, microbatch)

        def grads(batch):
            loss, metrics, g = fn.grads(batch)
            g = dict(g)
            name = max(g, key=lambda n: float(g[n].float().norm()))
            g[name] = g[name] * 2
            return loss, metrics, g
        return fn._replace(grads=grads)
    tr._build_step = built


@pytest.mark.parametrize("fault", [_state_unchanged,
                                   _parameters_not_written, _half_batch,
                                   _gradient_altered])
@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-ssm"])
def test_broken_step_is_not_correct(cell, fault):
    out = _run(cell, faults=fault)
    assert not out["correct"], out["checks"]
