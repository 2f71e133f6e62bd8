"""Parameter conversion between the reference's tree and the port's LM."""
import jax
import numpy as np

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
