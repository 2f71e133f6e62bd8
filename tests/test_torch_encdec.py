"""The port's encoder-decoder family (``seamless_m4t_large_v2``) against
the reference's.

Parameters come from the reference's ``LM.init`` (the reduced config:
2 encoder and 2 decoder layers, d 128, fp32) through
``repro_torch.bridge``; inputs, the stub ``frames`` included, come from
numpy with a seed.  The reference runs with ``attn_impl="xla"`` (its
Pallas kernel does not run under the installed jax); the port runs its
``xla`` path and its ``flash`` path (the kernels' plain versions on CPU
tensors: the decoder's causal self attention; the encoder's and the
cross attention run plain on both paths, as in the reference).

Tolerances (fp32, the same formulas in another summation order, those
of ``tests/test_torch_model.py``): layer outputs rtol 1e-5 / atol 1e-5;
the loss rtol 1e-5; gradients rtol 1e-3 / atol 1e-5 relative to each
leaf's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actions import Action as RefAction
from repro.core.baselines import SublinearPlanner as RefSublinear
from repro.core.collector import input_size_of as ref_input_size_of
from repro.launch.roofline import plan_unit_flops as ref_flops
from repro.models import layers as JL
from repro.models.lm import block_apply as ref_block_apply
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
from repro_torch.models.lm import LM, block_apply
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW
from repro_torch.train.accumulate import accumulated_grads, split_batch
from repro_torch.train.trainer import Trainer
from torch_pins import pin_reference_constants

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "seamless_m4t_large_v2"
S_TEXT, F_FRAMES = 48, 40
PLANS = {"keep": lambda ne, nd: (Action.KEEP,) * (ne + nd),
         "remat": lambda ne, nd: (Action.REMAT,) * (ne + nd),
         "mixed": lambda ne, nd: ((Action.REMAT,) + (Action.KEEP,) * (ne - 1)
                                  + (Action.KEEP,) * (nd - 1)
                                  + (Action.REMAT,))}


def _cfgs(**over):
    over = {"dtype": "float32", **over}
    return (jax_get_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**over))


def _batch(S=S_TEXT, B=2, F=None, d=128, vocab=512, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(S // 2, S + 1, B)
    lens = np.asarray(lens, np.int32)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    weights = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    tokens = tokens * weights.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    frames = rng.standard_normal((B, F or S, d)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "weights": weights,
            "lengths": lens, "frames": frames}


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


def _close_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy() if torch.is_tensor(want[name]) else want[name]
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=1e-3,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# attention and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("mode", ["bidirectional", "bidirectional_kv_len",
                                  "cross", "cross_kv_len"])
def test_encoder_and_cross_attention_match_reference(mode, impl):
    """The encoder's bidirectional self attention (all keys, or keys
    below ``kv_len``) and cross attention over F != S keys (``kv_len``
    ignored there, as in the reference) run plain on both impls and
    equal the reference's on every row."""
    jcfg, tcfg = _cfgs()
    attn = JL.attention_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(2)
    B, S, F = 2, S_TEXT, F_FRAMES
    hd = tcfg.resolved_head_dim()
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    lens = np.array([30, 48], np.int32) if mode.endswith("kv_len") else None
    kw_j, kw_t = {}, {}
    if mode.startswith("cross"):
        kv = [rng.standard_normal((B, F, tcfg.num_kv_heads, hd))
              .astype(np.float32) for _ in range(2)]
        kw_j["cross_kv"] = tuple(jnp.asarray(a) for a in kv)
        kw_t["cross_kv"] = tuple(torch.from_numpy(a) for a in kv)
    else:
        kw_j["causal"] = kw_t["causal"] = False
    if lens is not None:
        kw_j["kv_len"] = jnp.asarray(lens)
        kw_t["kv_len"] = torch.from_numpy(lens)
    want, _ = JL.attention_apply(attn, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), impl="xla",
                                 **kw_j)
    got = TL.attention_apply(_tree(attn), tcfg, torch.from_numpy(x),
                             positions=torch.from_numpy(pos), impl=impl,
                             **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_block_apply_matches_reference(kind, impl):
    """An ``enc`` block (bidirectional, no lengths) and a ``dec`` block
    (causal self attention with lengths, then cross attention over an
    encoder output of F frames) on the rows below each length."""
    jcfg, tcfg = _cfgs()
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    p = (params["encoder"]["blocks"][0] if kind == "enc"
         else params["blocks"][1])
    rng = np.random.default_rng(3)
    B, S, F = 2, S_TEXT, F_FRAMES
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, F, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    lens = (np.array([31, 48], np.int32) if kind == "dec"
            else np.array([S, S], np.int32))
    kw = {} if kind == "enc" else {"seq_lens": lens, "enc_out": enc}
    want, _, _ = ref_block_apply(p, jcfg, jnp.asarray(x), kind,
                                 positions=jnp.asarray(pos), impl="xla",
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    got, aux = block_apply(_tree(p), tcfg, torch.from_numpy(x), kind,
                           positions=torch.from_numpy(pos), impl=impl,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert aux is None
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L].numpy(),
                                   np.asarray(want)[b, :L], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the whole reduced model: loss and every gradient, the encoder's included
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["unrolled", "scan"])
def reference(request):
    jcfg, tcfg = _cfgs(remat_mode=request.param, scan_chunks=2)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    batch = _batch(F=F_FRAMES)

    def loss_fn(p):
        return jlm.loss(p, _to_jax(batch))[0]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return (jlm, tcfg, params, batch, float(loss),
            bridge.state_dict_from_tree(grads))


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_lm_loss_and_grads_match_reference(reference, impl, plan):
    jlm, tcfg, params, batch, want_loss, want_grads = reference
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    assert lm.num_plan_units() == jlm.num_plan_units()
    acts = PLANS[plan](tcfg.encoder_layers, len(lm.unit_bounds()))
    loss, metrics = lm.loss(_to_torch(batch), acts)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert float(metrics["tokens"]) == float(batch["weights"].sum())
    grads = {n: p.grad for n, p in lm.named_parameters()}
    assert any(n.startswith("encoder.blocks.") for n in grads)
    assert all(float(g.abs().max()) > 0 for n, g in grads.items()
               if n.startswith("encoder."))
    _close_grads(grads, want_grads)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_and_grads(lm, batch, acts):
    loss, _ = lm.loss(batch, acts)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in lm.named_parameters()}
    lm.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("plan", ["decoder", "every", "encoder_remat"])
def test_offload_keeps_the_encoder_gradient(plan, impl, one_thread):
    """OFFLOAD over a decoder layer that reads the encoder's output: the
    cross attention's gradient reaches the encoder.  Every decoder unit
    OFFLOAD (encoder KEEP, or REMAT), or every unit OFFLOAD: the loss and
    every gradient, the encoder's included, equal the same plan under
    REMAT and under all-KEEP bitwise (the encoder output's gradient
    takes one term per decoder layer, in the same order under every
    action); the lane moved exactly the OFFLOAD layers' inputs."""
    _, tcfg = _cfgs()
    lm = LM(tcfg, attn_impl=impl, device="cpu", seed=1)
    batch = _to_torch(_batch(F=F_FRAMES, seed=4))
    ne, nd = tcfg.encoder_layers, tcfg.num_layers
    enc_act = {"decoder": Action.KEEP, "every": Action.OFFLOAD,
               "encoder_remat": Action.REMAT}[plan]
    acts = (enc_act,) * ne + (Action.OFFLOAD,) * nd
    as_remat = tuple(Action.REMAT if a is Action.OFFLOAD else a
                     for a in acts)
    keep = _loss_and_grads(lm, batch, (Action.KEEP,) * (ne + nd))
    remat = _loss_and_grads(lm, batch, as_remat)
    got = _loss_and_grads(lm, batch, acts)
    st = lm.transfer_lane.reset_stats()
    B, S = batch["tokens"].shape
    F = batch["frames"].shape[1]
    want_bytes = 4 * tcfg.d_model * B * (nd * S + (ne * F if plan == "every"
                                                   else 0))
    assert st["bytes_out"] == st["bytes_in"] == want_bytes
    assert torch.equal(got[0], remat[0])
    for n, g in got[1].items():
        assert torch.equal(g, remat[1][n]), n
        assert torch.equal(g, keep[1][n]), n
    enc = [n for n in got[1] if n.startswith("encoder.")]
    assert enc and all(float(got[1][n].abs().max()) > 0 for n in enc)
    assert torch.equal(got[0], keep[0])


# ---------------------------------------------------------------------------
# the planner's view: plan units, signatures, FLOPs, input size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_plan_units_meta_and_flops_match_reference(mode):
    """Encoder units first (``enc<i>``, signature ``("enc",)``); the
    decoder's carry the encoder geometry ``(B, F, d)`` in their
    signature; meta, names, signatures and FLOPs equal the reference's."""
    jcfg, tcfg = _cfgs(remat_mode=mode, num_layers=4, scan_chunks=2)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(tcfg, device="meta")
    raw = _batch(F=F_FRAMES)
    tb = _to_torch(raw)
    want_units = jlm.plan_units(params, _to_jax(raw))
    units = lm.plan_units(tb)
    assert [u.name for u in units] == [u.name for u in want_units]
    assert [u.index for u in units] == [u.index for u in want_units]
    assert [u.signature for u in units] == [u.signature for u in want_units]
    assert units[0].signature == ("enc",)
    assert units[-1].signature[-1] == (2, F_FRAMES, tcfg.d_model)
    assert lm.plan_unit_meta(tb) == jlm.plan_unit_meta(_to_jax(raw))
    np.testing.assert_array_equal(plan_unit_flops(lm, tb),
                                  ref_flops(jlm, _to_jax(raw)))
    assert [lm.unit_input_shape(u, tb) for u in units] == \
        [(2, F_FRAMES, tcfg.d_model)] * tcfg.encoder_layers \
        + [(2, S_TEXT, tcfg.d_model)] * len(lm.unit_bounds())


def test_input_size_counts_frames_like_reference():
    raw = _batch(F=F_FRAMES)
    assert input_size_of(_to_torch(raw)) == ref_input_size_of(raw) \
        == 2 * S_TEXT + 2 * F_FRAMES
    plain = {k: v for k, v in raw.items() if k != "frames"}
    assert input_size_of(_to_torch(plain)) == ref_input_size_of(plain)


def test_collector_traces_one_encoder_and_one_decoder_unit():
    """Per geometry one encoder and one decoder trace; a new frame count
    at the same text length traces the decoder again (``enc_sig``)."""
    _, tcfg = _cfgs(num_layers=3)
    lm = LM(tcfg, attn_impl="flash", device="meta")
    col = ShuttlingCollector(lm)
    res = col.collect(_to_torch(_batch(F=F_FRAMES)))
    assert (res.traced_units, res.dedup_hits) == (2, 3)
    full = ShuttlingCollector(lm, dedup=False).collect(
        _to_torch(_batch(F=F_FRAMES)))
    assert (res.activation_vector() == full.activation_vector()).all()
    assert (res.activation_vector() > 0).all()
    other = col.collect(_to_torch(_batch(F=2 * F_FRAMES)))
    assert other.traced_units == 2
    assert other.activation_vector()[-1] > res.activation_vector()[-1]


# ---------------------------------------------------------------------------
# Sublinear's static plan on the same vectors
# ---------------------------------------------------------------------------

class _StubResult:
    def __init__(self, coef, batch, size, flops):
        self.input_size = size
        self.collect_time_s = 0.0
        lin, out = coef
        self._act = size * lin
        self._out = np.full(len(lin), size * out)
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
    """Seeded per-unit bytes linear in the input size (frames counted),
    the same in both packages."""

    def __init__(self, lm, n, size_fn, flops_fn):
        rng = np.random.default_rng(0)
        self.coef = (rng.uniform(2e3, 4e3, n), 256.0)
        self.lm, self.size_fn, self.flops_fn = lm, size_fn, flops_fn

    def collect(self, *args):
        batch = args[-1]
        return _StubResult(self.coef, batch, self.size_fn(batch),
                           self.flops_fn(self.lm, batch))


@pytest.mark.parametrize("frac", [0.05, 0.3, 2.0])
def test_sublinear_static_plan_matches_reference(monkeypatch, frac):
    """Sublinear probes reshape ``frames`` with the tokens (reference
    ``baselines.py:85-87``): the same probes, sizes and plan."""
    pin_reference_constants(monkeypatch)
    jcfg, tcfg = _cfgs(num_layers=3)
    jlm, lm = build_model(jcfg), LM(tcfg, device="meta")
    n = lm.num_plan_units()
    B, S = 4, 64
    fixed = 4e6
    budget = fixed + frac * 2 * B * S * 3e3 * n
    kw = dict(max_input_size=2 * B * S, fixed_bytes=fixed,
              warmup_samples=3)
    ref, ours = RefSublinear(jlm, budget, **kw), SublinearPlanner(lm, budget,
                                                                  **kw)
    ref.collector = _StubCollector(jlm, n, ref_input_size_of, ref_flops)
    ours.collector = _StubCollector(lm, n, input_size_of, plan_unit_flops)
    for s in (32, 64, 48):
        raw = _batch(S=s, B=B, F=s)
        ra, ri = ref.plan(None, raw)
        a, i = ours.plan(_to_torch(raw))
        assert tuple(int(x) for x in ra) == tuple(int(x) for x in a)
        assert ri.plan.n_remat == i.plan.n_remat
        assert ri.quantized_size == i.quantized_size


# ---------------------------------------------------------------------------
# accumulation, the trainer, the bridge
# ---------------------------------------------------------------------------

def test_split_batch_carries_frames_with_an_inert_pad_row():
    raw = _batch(B=5, F=F_FRAMES, lens=[48, 40, 30, 20, 10])
    mbs = split_batch(_to_torch(raw), 2)
    assert tuple(mbs["frames"].shape) == (2, 3, F_FRAMES, 128)
    flat = mbs["frames"].reshape(6, F_FRAMES, 128)
    np.testing.assert_array_equal(flat[:5].numpy(), raw["frames"])
    assert float(flat[5].abs().sum()) == 0.0
    assert int(mbs["lengths"].reshape(6)[5]) == 0
    assert float(mbs["weights"].reshape(6, -1)[5].sum()) == 0.0


@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_grads_match_the_full_batch(k):
    """k = 2 and 3 (3 pads a length-0 row) against k = 1, at the
    tolerances of ``tests/test_microbatch.py``."""
    _, tcfg = _cfgs()
    lm = LM(tcfg, attn_impl="flash", device="cpu")
    batch = _to_torch(_batch(B=4, F=F_FRAMES, seed=6))
    want_loss, _, want = accumulated_grads(lm, batch, 1)
    loss, _, grads = accumulated_grads(lm, batch, k)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-6)
    assert set(grads) == set(want)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=n)


def _frames(d):
    rng = np.random.default_rng(7)
    return {"frames": lambda B, S: rng.standard_normal(
        (B, S, d)).astype(np.float32)}


def test_trainer_runs_mimose_with_frames():
    """``Trainer.run`` under Mimose for 3 steps with the ``frames``
    function (tests/test_system.py::test_encdec_and_vlm_train_with_planner)
    at a budget that makes it rematerialise: finite losses; the
    encoder's units come first in the moment-parking names and in the
    recomputed-layer counts; ``prewarm`` takes the same function."""
    _, tcfg = _cfgs()
    lm = LM(tcfg, attn_impl="flash", device="cpu")
    act = ShuttlingCollector(lm).collect(_to_torch(_batch(S=128, F=128))
                                         ).total_activation_bytes()
    planner = MimosePlanner(lm, fixed_train_bytes(lm.parameters())
                            + 0.4 * act, warmup_samples=1, quantum=64)
    tr = Trainer(lm, planner, AdamW(lr=1e-3))
    assert tr._unit_names[0] and all(n.startswith("encoder.blocks.0.")
                                     for n in tr._unit_names[0])
    assert all(n.startswith("blocks.1.") for n in tr._unit_names[-1])
    tr.run(make_batches("swag", batch_size=2, vocab_size=tcfg.vocab_size,
                        num_batches=3, quantum=64, seed=0,
                        extra=_frames(tcfg.d_model)))
    assert len(tr.history) == 3
    assert all(np.isfinite(s.loss) for s in tr.history)
    assert any(s.remat_units for s in tr.history)
    layers = lm.plan_unit_layers()
    for s in tr.history:
        assert s.recompute_dec_layers <= s.recompute_layers <= len(layers)
    assert tr.prewarm([192], 2, extra=_frames(tcfg.d_model)) == 1


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_bridge_round_trips_the_encoder_subtree(mode):
    """``encoder.blocks.<i>`` (a list in both modes) and
    ``encoder.final_norm`` cross into the port and back; in scan mode the
    decoder's ``blocks`` stack again and the encoder's do not."""
    jcfg, tcfg = _cfgs(remat_mode=mode, scan_chunks=2)
    params = build_model(jcfg).init(jax.random.PRNGKey(0))
    lm = LM(tcfg, device="cpu")
    bridge.load_tree(lm, params)
    assert "encoder.final_norm.scale" in lm.state_dict()
    assert "encoder.blocks.1.attn.wq" in lm.state_dict()
    assert "blocks.0.cross.wk" in lm.state_dict()
    back = bridge.tree_from_state_dict(lm.state_dict(),
                                       stacked=mode == "scan")
    assert isinstance(back["encoder"]["blocks"], list)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        a = np.asarray(a)
        assert a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path


def test_reference_offload_plan_values_as_remat():
    """The port's all-OFFLOAD plan against the JAX LM running the same
    typed plan with ``offload_exec=False`` (its OFFLOAD as remat: the
    reference cannot execute OFFLOAD under the installed jax)."""
    jcfg, tcfg = _cfgs()
    jlm = build_model(jcfg, attn_impl="xla")
    jlm.offload_exec = False
    params = jlm.init(jax.random.PRNGKey(0))
    raw = _batch(F=F_FRAMES, seed=8)
    n = jlm.num_plan_units()
    ref_acts = (RefAction.OFFLOAD,) * n
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jlm.loss(
        p, _to_jax(raw), remat_mask=ref_acts)[0]))(params)
    lm = LM(tcfg, attn_impl="flash", device="cpu")
    bridge.load_tree(lm, params)
    got_loss, got = _loss_and_grads(lm, _to_torch(raw), (Action.OFFLOAD,) * n)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    _close_grads(got, bridge.state_dict_from_tree(grads))
