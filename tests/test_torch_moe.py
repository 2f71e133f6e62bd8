"""The port's MoE family against the reference's.

Parameters come from the reference's ``LM.init`` (reduced configs,
``get_config(a).reduced(dtype="float32")`` as in
``tests/test_arch_smoke.py``) through ``repro_torch.bridge``; inputs from
numpy with a seed.  The reference runs with ``attn_impl="xla"``.

Tolerances (fp32, the same formulas in another summation order):
``moe_apply`` output rtol 1e-5 / atol 1e-5, aux rtol 1e-5; routing
(expert indices and the kept mask) exactly equal, with the smallest
top-k margin of the input checked to be far above fp32 error, so a flip
would show as a failure, not be hidden; the loss rtol 1e-5; gradients
rtol 1e-3 / atol 1e-5 relative to each leaf's largest entry.

The flash path is held on batches without ``lengths``: with them the
flash backward drops the padded query rows' gradient (K3 counts
``q_pos < kv_len`` only, as the reference's kernel), which the aux loss
reaches through the router at padded tokens; the plain path keeps it.
ROADMAP §C records the divergence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import pad_batch
from repro.launch import roofline as ref_roofline
from repro.models import moe as JM
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch import bridge
from repro_torch.actions import Action
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.launch import roofline
from repro_torch.models import moe as TM
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"]


def _cfgs(arch, **over):
    over = dict(dtype="float32", **over)
    return (jax_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _batch(S=48, B=2, vocab=512, seed=0, lengths=True):
    rng = np.random.default_rng(seed)
    lens = rng.integers(S // 2, S + 1, B)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    weights = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    tokens = tokens * weights.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    out = {"tokens": tokens, "labels": labels, "weights": weights}
    if lengths:
        out["lengths"] = lens.astype(np.int32)
    return out


def _to_torch(batch):
    dt = {"tokens": torch.long, "labels": torch.long, "lengths": torch.int32}
    return {k: torch.as_tensor(np.asarray(v), dtype=dt.get(k, torch.float32))
            for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_grads(lm, want_grads):
    grads = {n: p.grad for n, p in lm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        want = want_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=1e-3, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the block: dispatch, routing, aux
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def moe_block(request):
    jcfg, tcfg = _cfgs(request.param)
    p = JM.moe_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    tp = bridge.state_dict_from_tree(p)
    tree = {}
    for path, t in tp.items():
        node = tree
        *head, leaf = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t
    return jcfg, tcfg, p, tree, x


def test_moe_apply_matches_reference(moe_block):
    jcfg, tcfg, p, tree, x = moe_block
    want, want_aux = JM.moe_apply(p, jcfg, jnp.asarray(x))
    got, aux = TM.moe_apply(tree, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0


def test_moe_routing_equals_reference(moe_block):
    """Expert indices and the kept mask equal the reference's, on an
    input whose top-k margins are far above fp32 error; at capacity
    factor 0.6 some (token, slot) pairs are dropped, and the output with
    those drops matches too."""
    jcfg, tcfg, p, tree, x = moe_block
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.6)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.6)
    K = jcfg.experts_per_token
    g = JM._group_size(jcfg, x.shape[1])
    xg = jnp.asarray(x).reshape(-1, g, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("Ggd,de->Gge", xg, p["router"]), -1)
    gate, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, jcfg.num_experts, dtype=jnp.float32)
    flat = onehot.reshape(onehot.shape[0], -1, jcfg.num_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    pos = jnp.einsum("GgkE,GgkE->Ggk", pos, onehot)
    keep = pos < JM._capacity(jcfg, g)
    # the (K)-th largest probability against the (K+1)-th, per token
    srt = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    assert float((srt[..., K - 1] - srt[..., K]).min()) > 1e-5
    r = TM.route(tree, tcfg, torch.from_numpy(x))
    assert r.capacity == JM._capacity(jcfg, g)
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    # some pairs are dropped at this capacity, so the mask is exercised
    assert not bool(r.keep.all())
    want, _ = JM.moe_apply(p, jcfg, jnp.asarray(x))
    got, _ = TM.moe_apply(tree, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        r.gate.numpy(),
        np.asarray(gate / gate.sum(-1, keepdims=True) * keep), rtol=1e-5,
        atol=1e-6)


def test_capacity_and_group_size_match_reference():
    jcfg, tcfg = _cfgs("granite_moe_1b_a400m")
    for S in (1, 7, 48, 96, 448, 512, 600, 1024):
        assert TM._group_size(tcfg, S) == JM._group_size(jcfg, S)
        g = TM._group_size(tcfg, S)
        assert TM._capacity(tcfg, g) == JM._capacity(jcfg, g)


def test_moe_runs_on_meta():
    """The block runs on ``meta`` tensors (the collector's trace): the
    one-hot masks compare against an ``arange``."""
    _, tcfg = _cfgs("granite_moe_1b_a400m")
    with torch.device("meta"):
        p = TM.moe_init(torch.Generator(), tcfg, torch.float32)
    x = torch.empty((2, 24, tcfg.d_model), device="meta")
    out, aux = TM.moe_apply(p, tcfg, x)
    assert out.shape == x.shape and out.device.type == "meta"
    assert aux.shape == ()


# ---------------------------------------------------------------------------
# whole reduced models: loss (ce + aux) and every gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS
                                        for m in ("unrolled", "scan")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def reference(request):
    arch, mode = request.param
    jcfg, tcfg = _cfgs(arch, remat_mode=mode)
    jlm = build_model(jcfg, attn_impl="xla")
    params = jlm.init(jax.random.PRNGKey(0))
    out = {}
    for name, lengths in (("ragged", True), ("plain", False)):
        batch = pad_batch(_batch(lengths=lengths), 64)
        (loss, m), grads = jax.jit(jax.value_and_grad(
            lambda p: jlm.loss(p, _to_jax(batch)), has_aux=True))(params)
        out[name] = (batch, float(loss), float(m["aux"]),
                     bridge.state_dict_from_tree(grads))
    return tcfg, params, out


@pytest.mark.parametrize("impl,batch_kind", [("xla", "ragged"),
                                             ("xla", "plain"),
                                             ("flash", "plain")])
def test_lm_loss_aux_and_grads_match_reference(reference, impl, batch_kind):
    tcfg, params, out = reference
    batch, want_loss, want_aux, want_grads = out[batch_kind]
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    loss, metrics = lm.loss(_to_torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), want_aux, rtol=1e-5)
    assert float(metrics["aux"]) > 0
    np.testing.assert_allclose(float(metrics["ce"] + metrics["aux"]),
                               float(loss.detach()), rtol=1e-6)
    _assert_grads(lm, want_grads)


@pytest.mark.parametrize("act", [Action.REMAT, Action.OFFLOAD])
def test_aux_crosses_checkpointing_and_offload(reference, act):
    """The aux loss and its gradients through REMAT
    (``torch.utils.checkpoint``) and OFFLOAD (``_OffloadLayer``'s two
    outputs and two incoming gradients) equal the KEEP step's."""
    tcfg, params, out = reference
    batch = _to_torch(out["ragged"][0])
    lm = LM(tcfg, attn_impl="xla", device="cpu")
    bridge.load_tree(lm, params)
    n = lm.num_plan_units()
    res = {}
    for a in (Action.KEEP, act):
        loss, m = lm.loss(batch, (a,) * n)
        loss.backward()
        res[a] = (float(loss.detach()), float(m["aux"]),
                  {k: p.grad.clone() for k, p in lm.named_parameters()})
        lm.zero_grad(set_to_none=True)
    assert res[act][:2] == res[Action.KEEP][:2]
    for k, g in res[Action.KEEP][2].items():
        assert torch.equal(res[act][2][k], g), k
    if act is Action.OFFLOAD:
        st = lm.transfer_lane.reset_stats()
        B, S = batch["tokens"].shape
        assert st["bytes_out"] == tcfg.num_layers * B * S * tcfg.d_model * 4


# ---------------------------------------------------------------------------
# the planner's view: collector on meta, FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_collector_traces_moe_units_on_meta(mode):
    _, tcfg = _cfgs("granite_moe_1b_a400m", remat_mode=mode, num_layers=4,
                    scan_chunks=2)
    lm = LM(tcfg, attn_impl="flash", device="meta")
    res = ShuttlingCollector(lm).collect(
        {"tokens": torch.zeros((2, 64), dtype=torch.long)})
    acts = res.activation_vector()
    assert len(acts) == lm.num_plan_units() and (acts > 0).all()
    assert len(set(acts.tolist())) == 1           # equal units
    assert res.traced_units == 1 and res.dedup_hits == len(acts) - 1
    assert all(r.flops > 0 for r in res.records)


@pytest.mark.parametrize("arch", ARCHS)
def test_unit_fwd_flops_moe_matches_reference(arch):
    cfg = jax_get_config(arch)
    tcfg = get_config(arch)
    for B, S, layers in ((8, 448, 3), (2, 96, 1)):
        assert roofline.unit_fwd_flops(tcfg, "moe", batch=B, seq=S,
                                       layers=layers) == \
            ref_roofline.unit_fwd_flops(cfg, "moe", batch=B, seq=S,
                                        layers=layers)


def test_full_configs_match_reference():
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))


def test_flash_with_lengths_differs_from_plain_only_through_the_aux():
    """On a batch with ``lengths`` the flash backward drops the padded
    query rows' gradient (K3 counts ``q_pos < kv_len``, as the
    reference's kernel).  Only the aux loss sends gradient there (the
    router sees padded tokens), so with ``router_aux_coef = 0`` the
    flash path's loss and gradients equal the plain path's; with the
    aux they do not (ROADMAP §C)."""
    _, tcfg = _cfgs("granite_moe_1b_a400m")
    batch = _to_torch(pad_batch(_batch(), 64))
    worst = {}
    for coef in (0.0, tcfg.router_aux_coef):
        cfg = dataclasses.replace(tcfg, router_aux_coef=coef)
        grads = {}
        for impl in ("xla", "flash"):
            lm = LM(cfg, attn_impl=impl, device="cpu", seed=4)
            loss, _ = lm.loss(batch)
            loss.backward()
            grads[impl] = (float(loss.detach()),
                           {n: p.grad for n, p in lm.named_parameters()})
        np.testing.assert_allclose(grads["flash"][0], grads["xla"][0],
                                   rtol=1e-5)
        worst[coef] = max(
            float((g - grads["xla"][1][n]).abs().max())
            / max(float(grads["xla"][1][n].abs().max()), 1e-12)
            for n, g in grads["flash"][1].items())
    assert worst[0.0] < 1e-3
    assert worst[tcfg.router_aux_coef] > 1e-2
