"""The port's dense layers and LM against the reference's.

Parameters come from the reference's ``LM.init`` and are converted
through numpy (``repro_torch.bridge``); inputs come from numpy with a
seed.  The reference runs with ``attn_impl="xla"``; the port runs both
its ``xla`` path and its ``flash`` path (the flash function's plain
versions on CPU tensors).

Tolerances: layer outputs rtol 1e-5 / atol 1e-5 (fp32, same formula,
other summation order); the loss rtol 1e-5 (one fp32 reduction over
B*S*V logits); gradients rtol 1e-3 / atol 1e-5 relative to each leaf's
largest entry (fp32 through 2 blocks of matmuls and the flash
backward's exp(s - lse) recombination).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import pad_batch
from repro.models import layers as JL
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch import bridge
from repro_torch.actions import Action
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config

torch.backends.cuda.matmul.allow_tf32 = False

REDUCED = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512,
               dtype="float32")
PLANS = {"keep": (Action.KEEP, Action.KEEP),
         "mixed": (Action.REMAT, Action.KEEP),
         "remat": (Action.REMAT, Action.REMAT)}


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("bert_base_paper").reduced(**REDUCED)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    tcfg = get_config("bert_base_paper").reduced(**REDUCED)
    return jlm, params, tcfg


def _torch_lm(tcfg, params, impl):
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    return lm


def _ragged(S=48, B=2, vocab=512, seed=0):
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


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = JL.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = TL.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                        10000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "swiglu", "relu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    names = ["wi", "wo"] + (["wg"] if act == "swiglu" else [])
    shapes = {"wi": (64, 128), "wg": (64, 128), "wo": (128, 64)}
    p = {n: (rng.standard_normal(shapes[n]) / 8).astype(np.float32)
         for n in names}
    want = JL.mlp_apply({n: jnp.asarray(a) for n, a in p.items()},
                        jnp.asarray(x), act)
    got = TL.mlp_apply({n: torch.from_numpy(a) for n, a in p.items()},
                       torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_attention_with_lengths_matches_reference(models, impl):
    """No-cache causal self attention with ``kv_len`` against the
    reference's (``xla``) on rows below each length."""
    _, params, tcfg = models
    attn = params["blocks"][0]["attn"]
    rng = np.random.default_rng(4)
    B, S = 2, 48
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    lens = np.array([30, 48], np.int32)
    jcfg = jax_get_config("bert_base_paper").reduced(**REDUCED)
    want, _ = JL.attention_apply(attn, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), impl="xla",
                                 kv_len=jnp.asarray(lens))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in attn.items()}
    got = TL.attention_apply(tp, tcfg, torch.from_numpy(x),
                             positions=torch.from_numpy(pos), impl=impl,
                             kv_len=torch.from_numpy(lens))
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L].numpy(), _np(want)[b, :L],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the LM: loss and every gradient under KEEP, mixed and REMAT plans
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
def test_lm_loss_and_grads_match_reference(models, reference_grads, impl,
                                           plan):
    _, params, tcfg = models
    batch, want_loss, want_grads = reference_grads
    lm = _torch_lm(tcfg, params, impl)
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
    """tests/test_engine.py::test_padded_bucket_loss_equals_unpadded and
    tests/test_ragged.py::test_padded_loss_with_lengths_equals_unpadded:
    padding is a causal suffix with zero weight, so the loss on the
    padded bucket (with or without lengths) equals the unpadded loss."""
    _, params, tcfg = models
    lm = _torch_lm(tcfg, params, impl)
    raw = _ragged(S=50, seed=5)
    padded = pad_batch(raw, 64)
    with torch.no_grad():
        l_raw, m_raw = lm.loss(_to_torch({k: v for k, v in raw.items()
                                          if k != "lengths"}))
        l_len, m_len = lm.loss(_to_torch(padded))
        l_pad, _ = lm.loss(_to_torch({k: v for k, v in padded.items()
                                      if k != "lengths"}))
    assert float(m_raw["tokens"]) == float(m_len["tokens"])
    np.testing.assert_allclose(float(l_len), float(l_raw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(l_pad), float(l_raw), rtol=1e-5,
                               atol=1e-6)


def test_unsupported_config_is_rejected():
    """A remat mode the port does not run is refused by name."""
    cfg = get_config("bert_base_paper").reduced(**REDUCED)
    with pytest.raises(NotImplementedError, match="remat_mode"):
        LM(dataclasses.replace(cfg, remat_mode="layerwise"), device="cpu")


# the settings the port refused until the encoder-decoder and
# vision-language families came: (config, overrides).  An encdec family
# needs encoder layers (the reference's decoder blocks read an encoder
# output), and a vlm family vision tokens to be one
FORMERLY_REFUSED = {
    "mrope": ("bert_base_paper", dict(mrope=True)),
    "encoder_layers": ("bert_base_paper",
                       dict(encoder_layers=2, encoder_frames=16)),
    "vision_tokens": ("bert_base_paper", dict(vision_tokens=4)),
    "family-encdec": ("bert_base_paper",
                      dict(family="encdec", encoder_layers=2)),
    "family-vlm": ("bert_base_paper",
                   dict(family="vlm", vision_tokens=4, mrope=True)),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
    "qwen2_vl_7b": ("qwen2_vl_7b", {}),
}


@pytest.mark.parametrize("setting", sorted(FORMERLY_REFUSED))
def test_formerly_refused_setting_builds_and_gives_the_reference_loss(
        setting):
    """Each setting the port refused before (M-RoPE, encoder layers,
    vision tokens, the encdec and vlm families, and the two configs that
    waited for them) builds and gives the reference's loss, with
    ``lengths``, and the stub inputs its batch needs."""
    arch, over = FORMERLY_REFUSED[setting]
    base = REDUCED if arch == "bert_base_paper" else dict(dtype="float32")
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(**base), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(**base), **over)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    batch = pad_batch(_ragged(), 64)
    rng = np.random.default_rng(9)
    B, S = batch["tokens"].shape
    if tcfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, 24, tcfg.d_model)).astype(np.float32)
    if tcfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, tcfg.vision_tokens, tcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p: jlm.loss(p, _to_jax(batch))[0])(params)
    lm = _torch_lm(tcfg, params, "xla")
    assert lm.num_plan_units() == jlm.num_plan_units()
    with torch.no_grad():
        loss, _ = lm.loss(_to_torch(batch))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm_3b", "gemma3_12b", "stablelm-3b",
                                  "gemma3-12b"])
def test_registry_resolves_the_head_dim_80_and_256_configs(arch):
    """stablelm (hd 80) and gemma3 (hd 256), under their ids and dashed
    names, are the reference's configurations field by field."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))


@pytest.mark.parametrize("arch,key", [("seamless-m4t-large-v2", "frames"),
                                      ("qwen2_vl_7b", "vision_embeds")])
def test_launcher_refuses_the_stub_input_families_by_name(arch, key, capsys):
    """The launcher builds no stub inputs (nor does the reference's): it
    refuses the two families by name before building a model, and says
    how they train."""
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--reduced", "--arch", arch,
                           "--steps", "1"])
    err = capsys.readouterr().err
    assert arch in err and repr(key) in err and "Trainer" in err


# ---------------------------------------------------------------------------
# the dense variants the other decoder-only configs need: qk-norm, GQA
# kv = 4, head dims 80, 128 and 256, an untied lm head, gemma3's local
# and global layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_qk_norm_attention_matches_reference(impl):
    """qwen3's attention (qk-norm on each head before RoPE), with
    ``kv_len``, on rows below each length."""
    jcfg = jax_get_config("qwen3_1p7b").reduced(dtype="float32")
    tcfg = get_config("qwen3_1p7b").reduced(dtype="float32")
    attn = JL.attention_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    attn = dict(attn, q_norm={"scale": jnp.linspace(0.5, 1.5, 32)},
                k_norm={"scale": jnp.linspace(1.2, 0.8, 32)})
    rng = np.random.default_rng(6)
    B, S = 2, 48
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    lens = np.array([30, 48], np.int32)
    want, _ = JL.attention_apply(attn, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), impl="xla",
                                 kv_len=jnp.asarray(lens))
    tp = {k: ({"scale": torch.from_numpy(np.array(v["scale"]))}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in attn.items()}
    got = TL.attention_apply(tp, tcfg, torch.from_numpy(x),
                             positions=torch.from_numpy(pos), impl=impl,
                             kv_len=torch.from_numpy(lens))
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L].numpy(), _np(want)[b, :L],
                                   rtol=1e-5, atol=1e-5)


# arch -> (its reduced() keywords beyond dtype and mode, the batch's
# length before padding to 64): stablelm at its head dim 80, gemma3 at
# 256 with reduced()'s window 64 and global interval 2 and sequences
# past the window, so its local layers mask
DENSE_VARIANTS = {"qwen3_1p7b": ({}, 48), "yi_9b": ({}, 48),
                  "stablelm_3b": (dict(head_dim=80), 48),
                  "gemma3_12b": (dict(head_dim=256), 112)}


@pytest.fixture(scope="module",
                params=[(a, m) for a in DENSE_VARIANTS
                        for m in ("unrolled", "scan")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def dense_variant(request):
    arch, mode = request.param
    extra, S = DENSE_VARIANTS[arch]
    over = dict(dtype="float32", remat_mode=mode, **extra)
    jlm = build_model(jax_get_config(arch).reduced(**over), attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    batch = pad_batch(_ragged(S), 64)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, _to_jax(batch))[0]))(params)
    return (get_config(arch).reduced(**over), params, batch, float(loss),
            bridge.state_dict_from_tree(grads))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dense_variant_loss_and_grads_match_reference(dense_variant, impl):
    """qwen3 (qk-norm, tied), yi (GQA, untied ``lm_head``), stablelm (hd
    80, untied) and gemma3 (hd 256, tied, local layers windowed),
    reduced, unrolled and in scan mode."""
    tcfg, params, batch, want_loss, want_grads = dense_variant
    if tcfg.sliding_window:
        assert tcfg.global_interval == 2 and batch["tokens"].shape[1] > \
            tcfg.sliding_window
    lm = _torch_lm(tcfg, params, impl)
    assert (lm.lm_head is None) == tcfg.tie_embeddings
    loss, _ = lm.loss(_to_torch(batch), (Action.REMAT,)
                      + (Action.KEEP,) * (lm.num_plan_units() - 1))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    grads = {n: p.grad for n, p in lm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        want = want_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=1e-3, atol=1e-5, err_msg=name)
