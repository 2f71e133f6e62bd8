"""The port's vision-language family (``qwen2_vl_7b``) against the
reference's.

Parameters come from the reference's ``LM.init`` (the reduced config:
2 layers, d 128, 4 / 2 heads x 32, 16 vision tokens, M-RoPE sections
(16, 24, 24) cut to the 16 slots of hd 32, fp32) through
``repro_torch.bridge``; inputs, the stub ``vision_embeds`` included,
come from numpy with a seed.  The reference runs with
``attn_impl="xla"``; the port runs its ``xla`` path and its ``flash``
path (the kernels' plain versions on CPU tensors, over the vision
prefix and the text, ``kv_len`` = lengths + vision tokens).

Tolerances (fp32, those of ``tests/test_torch_model.py``): layer outputs
and M-RoPE rtol 1e-5 / atol 1e-5; the loss rtol 1e-5; gradients rtol
1e-3 / atol 1e-5 relative to each leaf's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import SublinearPlanner as RefSublinear
from repro.core.collector import input_size_of as ref_input_size_of
from repro.launch.roofline import plan_unit_flops as ref_flops
from repro.models import layers as JL
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch import bridge
from repro_torch.actions import Action
from repro_torch.core.baselines import SublinearPlanner
from repro_torch.core.collector import ShuttlingCollector, input_size_of
from repro_torch.core.planner import MimosePlanner, fixed_train_bytes
from repro_torch.data.pipeline import make_batches
from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW
from repro_torch.train.accumulate import accumulated_grads, split_batch
from repro_torch.train.trainer import Trainer
from torch_pins import pin_reference_constants

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "qwen2_vl_7b"
S_TEXT, VT = 48, 16
SECTIONS = (16, 24, 24)


def _cfgs(**over):
    over = {"dtype": "float32", **over}
    return (jax_get_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**over))


def _batch(S=S_TEXT, B=2, vt=VT, d=128, vocab=512, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(S // 2, S + 1, B)
    lens = np.asarray(lens, np.int32)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    weights = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    tokens = tokens * weights.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    ve = rng.standard_normal((B, vt, d)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "weights": weights,
            "lengths": lens, "vision_embeds": ve}


def _to_torch(batch):
    dt = {"tokens": torch.long, "labels": torch.long, "lengths": torch.int32}
    return {k: torch.as_tensor(np.asarray(v), dtype=dt.get(k, torch.float32))
            for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.from_numpy(np.array(node))


# ---------------------------------------------------------------------------
# M-RoPE and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [128, 32])
def test_apply_mrope_matches_reference(hd):
    """At the full config's hd 128 the sections fill the 64 slots; at the
    reduced hd 32 they overrun its 16 and are cut, as the reference's
    ``sec[: hd // 2]``.  Three streams that differ, so a wrong section
    map shows."""
    rng = np.random.default_rng(1)
    B, S, H = 2, 40, 3
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (3, B, S)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, SECTIONS)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         SECTIONS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # equal streams reduce it to plain RoPE over that stream
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    np.testing.assert_allclose(
        TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                       SECTIONS).numpy(),
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]),
                      1e6).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_mrope_attention_with_lengths_matches_reference(impl):
    """Causal self attention under M-RoPE positions at the full config's
    head dim, with ``kv_len``, on rows below each length."""
    jcfg, tcfg = _cfgs(head_dim=128, num_heads=4, num_kv_heads=2)
    attn = JL.attention_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    rng = np.random.default_rng(6)
    B, S = 2, S_TEXT
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mpos = rng.integers(0, 64, (3, B, S)).astype(np.int32)
    lens = np.array([30, 48], np.int32)
    want, _ = JL.attention_apply(attn, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), impl="xla",
                                 mrope_positions=jnp.asarray(mpos),
                                 kv_len=jnp.asarray(lens))
    got = TL.attention_apply(_tree(attn), tcfg, torch.from_numpy(x),
                             positions=torch.from_numpy(pos), impl=impl,
                             mrope_positions=torch.from_numpy(mpos),
                             kv_len=torch.from_numpy(lens))
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L].numpy(),
                                   np.asarray(want)[b, :L], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("vt", [VT, 1024])
def test_embedded_inputs_and_mrope_positions_match_reference(vt):
    """The vision prefix, the (3, B, S) positions (patches on a √vt grid
    at t = 0, the text offset by the side) and 1-D positions over the
    whole sequence; 1024 is the full config's 32 x 32 grid."""
    jcfg, tcfg = _cfgs(vision_tokens=vt, vocab_size=256)
    params = build_model(jcfg).init(jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    bridge.load_tree(lm, params)
    raw = _batch(vt=vt, vocab=256)
    want = build_model(jcfg)._embed_inputs(params, _to_jax(raw))
    got = lm._embed_inputs(_to_torch(raw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert tuple(got[2].shape) == (3, 2, vt + S_TEXT)


# ---------------------------------------------------------------------------
# the whole reduced model: loss over the text, every gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["unrolled", "scan"])
def reference(request):
    jcfg, tcfg = _cfgs(remat_mode=request.param, num_layers=4,
                       scan_chunks=2)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    batch = _batch()

    def loss_fn(p):
        return jlm.loss(p, _to_jax(batch))[0]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return (jlm, tcfg, params, batch, float(loss),
            bridge.state_dict_from_tree(grads))


@pytest.mark.parametrize("plan", ["keep", "remat", "offload"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_lm_loss_and_grads_match_reference(reference, impl, plan):
    jlm, tcfg, params, batch, want_loss, want_grads = reference
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    n = lm.num_plan_units()
    assert n == jlm.num_plan_units()
    act = {"keep": Action.KEEP, "remat": Action.REMAT,
           "offload": Action.OFFLOAD}[plan]
    loss, metrics = lm.loss(_to_torch(batch), (Action.KEEP,) * (n - 1)
                            + (act,))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert float(metrics["tokens"]) == float(batch["weights"].sum())
    grads = {name: p.grad for name, p in lm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        want = want_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_padded_loss_with_lengths_equals_unpadded(impl):
    """Padding is a causal suffix behind the vision prefix with zero
    weight: the padded bucket's loss with lengths equals the unpadded
    loss."""
    from repro_torch.data.pipeline import pad_batch
    _, tcfg = _cfgs()
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    raw = _batch(S=40, seed=5)
    padded = pad_batch(raw, 64)
    assert padded["tokens"].shape[1] == 64
    with torch.no_grad():
        l_raw, m_raw = lm.loss(_to_torch({k: v for k, v in raw.items()
                                          if k != "lengths"}))
        l_len, m_len = lm.loss(_to_torch(padded))
    assert float(m_raw["tokens"]) == float(m_len["tokens"])
    np.testing.assert_allclose(float(l_len), float(l_raw), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the planner's view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_plan_units_meta_and_flops_match_reference(mode):
    """S = vision tokens + text in every unit's meta and input shape;
    names and signatures are the reference's (whose decoder-only
    signatures end in a ``None`` encoder geometry the port leaves out);
    FLOPs equal."""
    jcfg, tcfg = _cfgs(remat_mode=mode, num_layers=4, scan_chunks=2)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(tcfg, device="meta")
    raw = _batch()
    tb = _to_torch(raw)
    want_units = jlm.plan_units(params, _to_jax(raw))
    units = lm.plan_units(tb)
    assert [u.name for u in units] == [u.name for u in want_units]
    assert [u.signature + (None,) for u in units] == \
        [u.signature for u in want_units]
    assert lm.plan_unit_meta(tb) == jlm.plan_unit_meta(_to_jax(raw))
    assert all(m["seq"] == VT + S_TEXT for m in lm.plan_unit_meta(tb))
    np.testing.assert_array_equal(plan_unit_flops(lm, tb),
                                  ref_flops(jlm, _to_jax(raw)))
    assert {lm.unit_input_shape(u, tb) for u in units} == \
        {(2, VT + S_TEXT, tcfg.d_model)}


def test_input_size_counts_vision_tokens_like_reference():
    raw = _batch()
    assert input_size_of(_to_torch(raw)) == ref_input_size_of(raw) \
        == 2 * S_TEXT + 2 * VT


def test_collector_traces_the_residual_stream_with_the_prefix():
    _, tcfg = _cfgs(num_layers=3)
    lm = LM(tcfg, attn_impl="flash", device="meta")
    res = ShuttlingCollector(lm).collect(_to_torch(_batch()))
    assert (res.traced_units, res.dedup_hits) == (1, 2)
    out = 2 * (VT + S_TEXT) * tcfg.d_model * 4
    assert (res.output_vector() == out).all()
    assert (res.activation_vector() > 0).all()


class _StubResult:
    def __init__(self, coef, size, flops):
        self.input_size = size
        self.collect_time_s = 0.0
        self._act = size * coef
        self._out = np.full(len(coef), size * 256.0)
        self._flops = flops

    def activation_vector(self):
        return self._act.copy()

    def flops_vector(self):
        return self._flops.copy()

    def output_vector(self):
        return self._out.copy()

    def offloadable_vector(self):
        return 0.8 * self._act

    def opt_vector(self):
        return np.zeros(len(self._act))


class _StubCollector:
    def __init__(self, lm, n, size_fn, flops_fn):
        self.coef = np.random.default_rng(0).uniform(2e3, 4e3, n)
        self.lm, self.size_fn, self.flops_fn = lm, size_fn, flops_fn

    def collect(self, *args):
        batch = args[-1]
        return _StubResult(self.coef, self.size_fn(batch),
                           self.flops_fn(self.lm, batch))


@pytest.mark.parametrize("frac", [0.05, 0.3, 2.0])
def test_sublinear_static_plan_matches_reference(monkeypatch, frac):
    """The probes keep the batch's ``vision_embeds``; the sizes and the
    plan are the reference's."""
    pin_reference_constants(monkeypatch)
    jcfg, tcfg = _cfgs(num_layers=3)
    jlm, lm = build_model(jcfg), LM(tcfg, device="meta")
    n = lm.num_plan_units()
    B, S = 4, 64
    fixed = 4e6
    budget = fixed + frac * B * (S + VT) * 3e3 * n
    kw = dict(max_input_size=B * (S + VT), fixed_bytes=fixed,
              warmup_samples=3)
    ref, ours = RefSublinear(jlm, budget, **kw), SublinearPlanner(lm, budget,
                                                                  **kw)
    ref.collector = _StubCollector(jlm, n, ref_input_size_of, ref_flops)
    ours.collector = _StubCollector(lm, n, input_size_of, plan_unit_flops)
    for s in (32, 64, 48):
        raw = _batch(S=s, B=B)
        ra, ri = ref.plan(None, raw)
        a, i = ours.plan(_to_torch(raw))
        assert tuple(int(x) for x in ra) == tuple(int(x) for x in a)
        assert ri.plan.n_remat == i.plan.n_remat
        assert ri.quantized_size == i.quantized_size


# ---------------------------------------------------------------------------
# accumulation, the trainer, the bridge
# ---------------------------------------------------------------------------

def test_split_batch_carries_vision_embeds_with_an_inert_pad_row():
    raw = _batch(B=5, lens=[48, 40, 30, 20, 10])
    mbs = split_batch(_to_torch(raw), 2)
    assert tuple(mbs["vision_embeds"].shape) == (2, 3, VT, 128)
    flat = mbs["vision_embeds"].reshape(6, VT, 128)
    np.testing.assert_array_equal(flat[:5].numpy(), raw["vision_embeds"])
    assert float(flat[5].abs().sum()) == 0.0
    assert int(mbs["lengths"].reshape(6)[5]) == 0
    assert float(mbs["weights"].reshape(6, -1)[5].sum()) == 0.0


@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_grads_match_the_full_batch(k):
    """k = 2 and 3 (3 pads a length-0 row: its vision prefix is zeros
    and its text weight 0) against k = 1, at the tolerances of
    ``tests/test_microbatch.py``."""
    _, tcfg = _cfgs()
    lm = LM(tcfg, attn_impl="flash", device="cpu")
    batch = _to_torch(_batch(B=4, seed=6))
    want_loss, _, want = accumulated_grads(lm, batch, 1)
    loss, _, grads = accumulated_grads(lm, batch, k)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-6)
    assert set(grads) == set(want)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=n)


def _vision(vt, d):
    rng = np.random.default_rng(7)
    return {"vision_embeds": lambda B, S: rng.standard_normal(
        (B, vt, d)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_trainer_runs_mimose_with_vision_embeds(mode):
    """``Trainer.run`` under Mimose for 3 steps with the
    ``vision_embeds`` function (tests/test_system.py::
    test_encdec_and_vlm_train_with_planner) at a budget that makes it
    rematerialise; the input size counts the prefix."""
    _, tcfg = _cfgs(remat_mode=mode, num_layers=4, scan_chunks=2)
    lm = LM(tcfg, attn_impl="flash", device="cpu")
    act = ShuttlingCollector(lm).collect(_to_torch(_batch(S=128))
                                         ).total_activation_bytes()
    planner = MimosePlanner(lm, fixed_train_bytes(lm.parameters())
                            + 0.4 * act, warmup_samples=1, quantum=64)
    tr = Trainer(lm, planner, AdamW(lr=1e-3))
    tr.run(make_batches("swag", batch_size=2, vocab_size=tcfg.vocab_size,
                        num_batches=3, quantum=64, seed=0,
                        extra=_vision(VT, tcfg.d_model)))
    assert len(tr.history) == 3
    assert all(np.isfinite(s.loss) for s in tr.history)
    assert any(s.remat_units for s in tr.history)
    for s in tr.history:
        assert s.recompute_dec_layers == s.recompute_layers
    assert tr.prewarm([192], 2, extra=_vision(VT, tcfg.d_model)) == 1


def test_bridge_round_trips_stacked_scan_blocks():
    jcfg, tcfg = _cfgs(remat_mode="scan", num_layers=4, scan_chunks=2)
    params = build_model(jcfg).init(jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    bridge.load_tree(lm, params)
    assert lm.lm_head is not None
    back = bridge.tree_from_state_dict(lm.state_dict(), stacked=True)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        a = np.asarray(a)
        assert a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path
