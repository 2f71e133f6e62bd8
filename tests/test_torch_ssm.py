"""The port's Mamba2 model, scan mode and mamba2 trainer against the
reference's.

Parameters come from the reference's ``LM.init`` and are converted
through numpy (``repro_torch.bridge``, which unstacks the scan mode's
layer axis); inputs come from numpy with a seed.  The reference runs its
only SSD path, the jnp ``ssd_chunked``; the port runs its ``xla`` path
(the same formulation in PyTorch) and its ``flash`` path (on CPU
tensors the kernel's plain version, the sequential recurrence, in the
forward and ``ssd_chunked``'s vector-Jacobian product in the backward).

The reduced model is 4 layers in 2 scan chunks, d_model 64, fp32, the
reference's reduced SSD sizes (N = 16, P = 16, chunk 16).  Tolerances:
the mixer's output rtol 1e-4 / atol 1e-5 (fp32, the same formula, sums
in another order, and on ``flash`` the recurrence instead of the
chunked form); the loss rtol 1e-5; gradients rtol 1e-3 / atol 1e-5
relative to each leaf's largest entry (fp32 through 4 layers); trainer
losses rtol 2e-5 per step, as for the dense trainer.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.collector import ShuttlingCollector as JaxCollector
from repro.core.planner import MimosePlanner as JaxMimose
from repro.data.pipeline import make_batches as jax_make_batches
from repro.data.pipeline import pad_batch
from repro.launch.roofline import unit_fwd_flops as jax_unit_fwd_flops
from repro.models import mamba2 as JM
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch import bridge
from repro_torch.actions import Action
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.core.planner import MimosePlanner, fixed_train_bytes
from repro_torch.data.pipeline import make_batches
from repro_torch.launch.roofline import unit_fwd_flops
from repro_torch.models import mamba2 as TM
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
ARCH = "mamba2_1p3b"
REDUCED = dict(num_layers=4, d_model=64, vocab_size=128, dtype="float32",
               remat_mode="scan", scan_chunks=2)
PLANS = {"keep": (Action.KEEP, Action.KEEP),
         "mixed": (Action.REMAT, Action.KEEP),
         "remat": (Action.REMAT, Action.REMAT)}


def _cfgs(**over):
    kw = dict(REDUCED, **over)
    return jax_get_config(ARCH).reduced(**kw), get_config(ARCH).reduced(**kw)


def _torch_lm(tcfg, params, impl):
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    return lm


def _ragged(S=48, B=2, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(S // 2, S + 1, B)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    weights = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    tokens = tokens * weights.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels, "weights": weights,
            "lengths": lens}


def _to_torch(batch):
    dt = {"tokens": torch.long, "labels": torch.long, "lengths": torch.int32}
    return {k: torch.as_tensor(np.asarray(v), dtype=dt.get(k, torch.float32))
            for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jlm = build_model(jcfg)
    return jlm, jlm.init(jax.random.PRNGKey(0)), tcfg


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------

def test_full_config_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))


def test_full_width_params_match_reference_tree():
    """The full-width model, built on ``meta``: the reference's leaves,
    shapes and dtypes (bf16, with ``A_log``, ``dt_bias`` and ``D`` fp32),
    one entry per layer, and 8 plan units of 6 layers."""
    jlm = build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    lm = LM(get_config(ARCH), device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in lm.state_dict().items()}
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                want[".".join(["blocks", str(i)] + keys[1:])] = (
                    tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            want[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    assert got == want
    assert got["blocks.0.ssm.A_log"][1] == "float32"
    assert got["blocks.0.ssm.in_proj"] == ((2048, 8512), "bfloat16")
    assert 1.34e9 < sum(p.numel() for p in lm.parameters()) < 1.35e9
    assert lm.unit_bounds() == [(6 * c, 6 * c + 6) for c in range(8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_stacked_bit_for_bit(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    params = build_model(jcfg).init(jax.random.PRNGKey(1))
    lm = LM(tcfg, device="cpu")
    bridge.load_tree(lm, params)
    assert lm.blocks[2].ssm.in_proj.dtype == getattr(torch, dtype)
    assert lm.blocks[2].ssm.A_log.dtype == torch.float32
    back = bridge.tree_from_state_dict(lm.state_dict(), stacked=True)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        assert np.array_equal(a.view(bits), b.view(bits)), path


# ---------------------------------------------------------------------------
# the SSD formulation and the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    """The port's ``ssd_chunked`` against the reference's (y and the
    final state), with a ragged tail (S = 100, chunk 32)."""
    rng = np.random.default_rng(2)
    B, S, H, P, N = 2, 100, 4, 16, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_state else None)
    jy, js = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                            32, None if s0 is None else jnp.asarray(s0))
    ty, ts = TM.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm,
                                                          Cm)),
                            32, None if s0 is None else torch.from_numpy(s0))
    # the reference suite's tolerance for this algorithm
    # (tests/test_kernels.py::test_ssd_chunked_jnp_matches_reference_and_state)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_mamba2_apply_with_lengths_matches_reference(models, impl):
    _, params, tcfg = models
    jcfg, _ = _cfgs()
    ssm = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["ssm"])
    rng = np.random.default_rng(5)
    B, S = 2, 40
    u = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    lens = np.array([23, 40], np.int32)
    want, _ = JM.mamba2_apply(ssm, jcfg, jnp.asarray(u),
                              seq_lens=jnp.asarray(lens))
    tp = _torch_tree(ssm)
    got = TM.mamba2_apply(tp, tcfg, torch.from_numpy(u),
                          seq_lens=torch.from_numpy(lens), impl=impl)
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L].numpy(),
                                   np.asarray(want)[b, :L], rtol=1e-4,
                                   atol=1e-5)


def test_softplus_is_the_references_above_the_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 21.0, 40.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(TM.softplus(x).numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the LM in scan mode: loss and every gradient under KEEP, mixed, REMAT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_grads(models):
    jlm, params, _ = models
    batch = pad_batch(_ragged(), 64)

    def loss_fn(p):
        return jlm.loss(p, _to_jax(batch))[0]
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return batch, float(loss), bridge.state_dict_from_tree(grads)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_scan_lm_loss_and_grads_match_reference(models, reference_grads,
                                                impl, plan):
    _, params, tcfg = models
    batch, want_loss, want_grads = reference_grads
    lm = _torch_lm(tcfg, params, impl)
    assert lm.num_plan_units() == 2
    loss, metrics = lm.loss(_to_torch(batch), PLANS[plan])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert float(metrics["tokens"]) == float(batch["weights"].sum())
    grads = {n: p.grad for n, p in lm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        want = want_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_padded_loss_with_lengths_equals_unpadded(models, impl):
    """tests/test_ragged.py::test_padded_loss_with_lengths_equals_unpadded
    for mamba2: padding is a causal suffix with zero weight and dt is
    zeroed past the lengths, so the padded loss equals the unpadded."""
    _, params, tcfg = models
    lm = _torch_lm(tcfg, params, impl)
    raw = _ragged(S=50, seed=5)
    padded = pad_batch(raw, 64)
    with torch.no_grad():
        l_raw, m_raw = lm.loss(_to_torch({k: v for k, v in raw.items()
                                          if k != "lengths"}))
        l_len, m_len = lm.loss(_to_torch(padded))
    assert float(m_raw["tokens"]) == float(m_len["tokens"])
    np.testing.assert_allclose(float(l_len), float(l_raw), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["bert_base_paper", ARCH])
def test_scan_matches_unrolled(arch):
    """tests/test_arch_smoke.py::test_scan_matches_unrolled: the same
    weights give the same loss in both modes, on both impls."""
    cfg = get_config(arch).reduced(num_layers=4, d_model=64, vocab_size=128,
                                   dtype="float32")
    jcfg = jax_get_config(arch).reduced(num_layers=4, d_model=64,
                                        vocab_size=128, dtype="float32")
    params = build_model(jcfg).init(jax.random.PRNGKey(4))
    batch = _to_torch(pad_batch(_ragged(S=40, seed=6), 16))
    losses = []
    for impl in ("xla", "flash"):
        for mode in ("unrolled", "scan"):
            lm = _torch_lm(dataclasses.replace(cfg, remat_mode=mode,
                                               scan_chunks=2), params, impl)
            assert lm.num_plan_units() == (4 if mode == "unrolled" else 2)
            with torch.no_grad():
                losses.append(float(lm.loss(batch)[0]))
    np.testing.assert_allclose(losses, losses[0], rtol=1e-5)


def test_remat_chunk_saves_one_input_per_layer(models):
    """A REMAT chunk checkpoints each of its layers (the reference
    checkpoints the scan body), so the forward keeps exactly its k layer
    inputs for the backward and nothing else of the chunk."""
    _, params, tcfg = models
    lm = _torch_lm(tcfg, params, "flash")
    batch = _to_torch(pad_batch(_ragged(), 16))
    B, S = batch["tokens"].shape
    x = torch.randn(B, S, tcfg.d_model, requires_grad=True)

    def saved_by(actions):
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            lm.blocks_forward(x, actions, None, batch["lengths"])
        return saved
    remat = saved_by((Action.REMAT, Action.REMAT))
    assert remat == [(B, S, tcfg.d_model)] * tcfg.num_layers
    assert len(saved_by((Action.KEEP, Action.KEEP))) > 10 * tcfg.num_layers


# ---------------------------------------------------------------------------
# planner pieces: collector, cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_collector_chunk_bytes_within_band_of_reference(models, impl):
    """Per chunk the port counts what PyTorch's autograd saves, not what
    ``jax.vjp`` keeps.  On the reduced chunk (2 layers) the ``xla`` path
    counts 0.79x the reference's bytes (``ssd_chunked``'s residuals, as
    the reference's path) and the ``flash`` path 0.40x (the scan keeps
    only its inputs); both are held to a band around that, for S in 32 ..
    128.  Output bytes and FLOPs are the reference's exactly."""
    jlm, params, tcfg = models
    band = {"xla": (0.7, 0.9), "flash": (0.33, 0.48)}[impl]
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    for S in (32, 64, 128):
        ref = JaxCollector(jlm).collect(
            params, {"tokens": jnp.ones((2, S), jnp.int32)})
        ours = ShuttlingCollector(lm).collect(
            {"tokens": torch.ones((2, S), dtype=torch.long)})
        ratio = ours.activation_vector() / ref.activation_vector()
        assert np.all((ratio > band[0]) & (ratio < band[1])), (S, ratio)
        np.testing.assert_array_equal(ours.output_vector(),
                                      ref.output_vector())
        np.testing.assert_array_equal(ours.flops_vector(),
                                      ref.flops_vector())


def test_eight_equal_chunks_cost_one_trace():
    """The full config's 8 chunks of 6 layers share a signature and
    parameter shapes: one meta trace serves all 8 (built on ``meta``)."""
    lm = LM(get_config(ARCH), attn_impl="flash", device="meta")
    res = ShuttlingCollector(lm).collect(
        {"tokens": torch.zeros((2, 64), dtype=torch.long)})
    assert res.traced_units == 1 and res.dedup_hits == 7
    assert len(set(res.activation_vector())) == 1
    assert [u.signature for u in lm.plan_units(
        {"tokens": torch.zeros((2, 64))})] == [("chunk", True, 6)] * 8


def test_unit_fwd_flops_ssm_matches_reference():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for B, S, layers in ((8, 416, 6), (2, 64, 1), (4, 1000, 3)):
        assert unit_fwd_flops(cfg, "ssm", batch=B, seq=S, layers=layers) \
            == jax_unit_fwd_flops(jcfg, "ssm", batch=B, seq=S, layers=layers)


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_trainer_losses_match_reference(models, impl):
    """Four Mimose steps of the port's trainer against the reference's,
    under a budget that forces a mixed plan on both sides."""
    jlm, params, tcfg = models
    steps, bs = 4, 4
    lm = _torch_lm(tcfg, params, impl)
    act = ShuttlingCollector(lm).collect(
        {"tokens": torch.ones((bs, 128), dtype=torch.long)})
    budget = (fixed_train_bytes(lm.parameters())
              + 0.6 * act.total_activation_bytes())

    jtr = JaxTrainer(jlm, JaxMimose(jlm, budget, quantum=32,
                                    warmup_samples=2),
                     JaxAdamW(lr=jax_cosine(1e-3, 2, steps)))
    jp = jax.tree_util.tree_map(lambda a: a.copy(), params)
    jstate = jtr.optimizer.init(jp)
    want = []
    for b in jax_make_batches("swag", batch_size=bs, vocab_size=128,
                              num_batches=steps, quantum=32, seed=0):
        jp, jstate, loss = jtr.step(jp, jstate, b)
        want.append(loss)

    planner = MimosePlanner(lm, budget, quantum=32, warmup_samples=2)
    tr = Trainer(lm, planner, AdamW(lr=cosine_schedule(1e-3, 2, steps)))
    tr.run(make_batches("swag", batch_size=bs, vocab_size=128,
                        num_batches=steps, quantum=32, seed=0))
    got = [s.loss for s in tr.history]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert any(0 < s.remat_units < 2 for s in tr.history)
    assert got[-1] < got[0]


def test_launcher_runs_reduced_mamba2_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--arch", ARCH, "--attn-impl", "flash", "--steps",
         "3"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "units=2" in res.stdout and "summary:" in res.stdout
