"""Parameter conversion between the reference's tree and the port's LM."""
import jax
import numpy as np
import pytest

from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch import bridge
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config

REDUCED = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512,
               dtype="float32")


def test_params_round_trip_bit_for_bit():
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config("bert_base_paper").reduced(**REDUCED), device="cpu")
    bridge.load_tree(lm, params)
    back = bridge.tree_from_state_dict(lm.state_dict())
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path


def test_port_init_matches_reference_layout_and_scale():
    """The port's own init has the reference's tree, shapes and
    distributions (dense ~ N(0, 1/d_in), embed ~ N(0, 0.02^2), scales 1)."""
    cfg = get_config("bert_base_paper").reduced(**REDUCED)
    lm = LM(cfg, device="cpu", seed=3)
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    want = bridge.state_dict_from_tree(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    got = lm.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert abs(float(got["embed"].std()) - 0.02) < 2e-3
    wq = got["blocks.0.attn.wq"]
    assert abs(float(wq.std()) * np.sqrt(wq.shape[0]) - 1.0) < 0.05
    assert float(got["final_norm.scale"].min()) == 1.0
    again = LM(cfg, device="cpu", seed=3).state_dict()
    assert all(np.array_equal(got[k].numpy(), again[k].numpy())
               for k in got)


NEW_FAMILIES = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b", "hymba_1p5b",
                "qwen3_1p7b", "yi_9b"]


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_round_trip_bit_for_bit(arch, mode):
    """The expert axis ``(E, d, ff)`` inside each layer, the untied
    ``lm_head``, ``q_norm`` / ``k_norm`` and hymba's 0-d fp32 scales
    (stacked to ``(L,)`` in scan mode) cross into the port and back:
    ``tree_from_state_dict(..., stacked=True)`` gives the reference's
    scan-mode tree."""
    over = dict(dtype="float32", remat_mode=mode)
    jlm = build_model(jax_get_config(arch).reduced(**over))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config(arch).reduced(**over), device="cpu")
    bridge.load_tree(lm, params)
    back = bridge.tree_from_state_dict(lm.state_dict(),
                                       stacked=mode == "scan")
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path
    names = set(lm.state_dict())
    if arch == "hymba_1p5b":
        assert lm.state_dict()["blocks.0.mixer.attn_scale"].shape == ()
    if arch in ("granite_moe_1b_a400m", "kimi_k2_1t_a32b"):
        cfg = lm.cfg
        assert tuple(lm.state_dict()["blocks.1.moe.wi"].shape) == (
            cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    assert ("lm_head" in names) == (not lm.cfg.tie_embeddings)
    assert ("blocks.0.attn.q_norm.scale" in names) == lm.cfg.qk_norm
