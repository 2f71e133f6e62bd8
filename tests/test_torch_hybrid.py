"""The port's hybrid (Hymba) family against the reference's.

Parameters come from the reference's ``LM.init`` (the reduced
``hymba_1p5b``, with the window cut to 64 and every second layer global,
at S = 128, so the banded local path and the window mask both bite)
through ``repro_torch.bridge``; inputs from numpy with a seed.  The
reference runs with ``attn_impl="xla"``; the port runs its ``xla`` path
and its ``flash`` path (the kernels' plain versions on CPU tensors).

Tolerances (fp32, the same formulas in another summation order):
``hymba_apply`` and ``sdpa_banded_local`` rtol 1e-5 / atol 1e-5 (the
SSD path through the flash route's sequential recurrence: 1e-4); the
loss rtol 1e-5; gradients rtol 1e-3 / atol 1e-5 relative to each leaf's
largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import pad_batch
from repro.launch import roofline as ref_roofline
from repro.models import hymba as JH
from repro.models import layers as JL
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch import bridge
from repro_torch.actions import Action
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.launch import roofline
from repro_torch.models import hymba as TH
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "hymba_1p5b"
# the reduced config's window and global interval, cut so they bite at
# S = 128 (the full config's are 1024 and 8)
WINDOW = dict(sliding_window=64, global_interval=2)
S_LONG = 128
# the full config's odd shapes at a small width: a GQA group of 5 (10
# query heads over 2 kv heads) and SSD heads of P = 50 (d_inner 200)
ODD = dict(num_heads=10, num_kv_heads=2, head_dim=16, d_model=100,
           ssm_head_dim=50, ssm_state=16, ssm_chunk=16)


def _cfgs(**over):
    over = {"dtype": "float32", **WINDOW, **over}
    return (jax_get_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**over))


def _batch(S=S_LONG, B=2, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(S // 2, S + 1, B)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    weights = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    tokens = tokens * weights.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels, "weights": weights,
            "lengths": lens.astype(np.int32)}


def _to_torch(batch):
    dt = {"tokens": torch.long, "labels": torch.long, "lengths": torch.int32}
    return {k: torch.as_tensor(np.asarray(v), dtype=dt.get(k, torch.float32))
            for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tree(node):
    """A reference sub-tree as nested dicts of torch tensors."""
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.from_numpy(np.array(node))


# ---------------------------------------------------------------------------
# the block and the banded attention
# ---------------------------------------------------------------------------

def test_sdpa_banded_local_matches_reference():
    rng = np.random.default_rng(1)
    B, S, H, Hkv, hd, W = 2, 128, 10, 2, 16, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    want = JL.sdpa_banded_local(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), W)
    got = TL.sdpa_banded_local(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # it is the causal window mask: the same as the masked dense form
    pos = torch.arange(S)[None].expand(B, S)
    dense = TL.sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              TL.build_mask(pos, pos, W, False))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", ["reduced", "odd"])
@pytest.mark.parametrize("is_global", [False, True])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_hymba_apply_matches_reference(shape, is_global, impl):
    """The hybrid mixer (attention and SSD in parallel, fp32 scales set
    away from 1) with lengths, on rows below each length; ``odd`` is the
    full config's GQA group of 5 and SSD head dim 50."""
    jcfg, tcfg = _cfgs(**(ODD if shape == "odd" else {}))
    p = JH.hymba_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = dict(p, attn_scale=jnp.float32(0.7), ssm_scale=jnp.float32(1.3))
    rng = np.random.default_rng(4)
    B = 2
    x = rng.standard_normal((B, S_LONG, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_LONG, dtype=np.int32),
                          (B, S_LONG)).copy()
    lens = np.array([90, S_LONG], np.int32)
    want, _, _ = jax.jit(lambda p_, x_, pos_, l_: JH.hymba_apply(
        p_, jcfg, x_, positions=pos_, layer_is_global=is_global,
        seq_lens=l_))(p, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(lens))
    got = TH.hymba_apply(_tree(p), tcfg, torch.from_numpy(x),
                         positions=torch.from_numpy(pos),
                         layer_is_global=is_global, impl=impl,
                         seq_lens=torch.from_numpy(lens))
    tol = 1e-5 if impl == "xla" else 1e-4
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L].numpy(),
                                   np.asarray(want)[b, :L], rtol=tol,
                                   atol=tol)


def test_hymba_scales_stay_fp32_in_a_bf16_model():
    _, tcfg = _cfgs()
    lm = LM(dataclasses.replace(tcfg, dtype="bfloat16"), device="cpu")
    mixer = lm.blocks[0]["mixer"]
    assert mixer["attn_scale"].dtype == torch.float32
    assert mixer["attn_scale"].shape == ()
    assert mixer["ssm_scale"].dtype == torch.float32
    assert mixer["attn"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# whole reduced models: loss and every gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module",
                params=[("unrolled", {}), ("scan", {}), ("unrolled", ODD)],
                ids=["unrolled", "scan", "odd"])
def reference(request):
    mode, over = request.param
    jcfg, tcfg = _cfgs(remat_mode=mode, **over)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    batch = pad_batch(_batch(), 64)

    def loss_fn(p):
        return jlm.loss(p, _to_jax(batch))[0]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return tcfg, params, batch, float(loss), bridge.state_dict_from_tree(
        grads)


@pytest.mark.parametrize("plan", ["keep", "remat"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_lm_loss_and_grads_match_reference(reference, impl, plan):
    tcfg, params, batch, want_loss, want_grads = reference
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    act = Action.REMAT if plan == "remat" else Action.KEEP
    loss, metrics = lm.loss(_to_torch(batch), (act,) * lm.num_plan_units())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    grads = {n: p.grad for n, p in lm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        want = want_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_padded_loss_with_lengths_equals_unpadded(reference, impl):
    """Padding is a causal suffix with zero weight, and the SSD state
    never sees it: the loss on the padded bucket with lengths equals
    the unpadded loss."""
    tcfg, params, _, _, _ = reference
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    raw = _batch(S=100, seed=5)
    padded = pad_batch(raw, 64)
    assert padded["tokens"].shape[1] == S_LONG
    with torch.no_grad():
        l_raw, m_raw = lm.loss(_to_torch({k: v for k, v in raw.items()
                                          if k != "lengths"}))
        l_len, m_len = lm.loss(_to_torch(padded))
    assert float(m_raw["tokens"]) == float(m_len["tokens"])
    np.testing.assert_allclose(float(l_len), float(l_raw), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the planner's view: plan units, collector on meta, FLOPs
# ---------------------------------------------------------------------------

def test_full_config_plan_units_are_local_chunks_and_global_layers():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config(ARCH))
    lm = LM(cfg, device="meta")
    bounds = lm.unit_bounds()
    assert bounds == [(s, s + 7) if i % 2 == 0 else (s, s + 1)
                      for i, s in enumerate([0, 7, 8, 15, 16, 23, 24, 31])]
    meta = lm.plan_unit_meta({"tokens": torch.zeros((8, 448))})
    assert [m["is_global"] for m in meta] == [False, True] * 4
    assert [m["layers"] for m in meta] == [7, 1] * 4
    assert all(m["kind"] == "hybrid" for m in meta)


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_collector_traces_hybrid_units_on_meta(mode):
    """Two traces per input size, whatever the depth: one local and one
    global unit (scan mode: one chunk of each width); the dedup
    signatures keep local and global apart."""
    _, tcfg = _cfgs(remat_mode=mode, num_layers=6, global_interval=3)
    lm = LM(tcfg, attn_impl="flash", device="meta")
    res = ShuttlingCollector(lm).collect(
        {"tokens": torch.zeros((2, S_LONG), dtype=torch.long)})
    full = ShuttlingCollector(lm, dedup=False).collect(
        {"tokens": torch.zeros((2, S_LONG), dtype=torch.long)})
    assert res.traced_units == 2
    assert (res.activation_vector() == full.activation_vector()).all()
    assert (res.activation_vector() > 0).all()
    sigs = [u.signature for u in lm.plan_units(
        {"tokens": torch.zeros((2, S_LONG), dtype=torch.long)})]
    if mode == "scan":
        assert sigs == [("chunk", False, 2), ("chunk", True, 1)] * 2
    else:
        assert sigs == [("block", False)] * 2 + [("block", True)] \
            + [("block", False)] * 2 + [("block", True)]


def test_unit_fwd_flops_hybrid_matches_reference():
    cfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    for B, S, layers, g in ((8, 448, 7, False), (8, 448, 1, True),
                            (2, 2048, 7, False)):
        assert roofline.unit_fwd_flops(tcfg, "hybrid", batch=B, seq=S,
                                       layers=layers, is_global=g) == \
            ref_roofline.unit_fwd_flops(cfg, "hybrid", batch=B, seq=S,
                                        layers=layers, is_global=g)
