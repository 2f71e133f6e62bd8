"""The port's adaptive microbatching (``train/accumulate.py``, the
planner's split search, the trainer's k-way step) against the
reference's ``repro.train.accumulate`` and ``tests/test_microbatch.py``.

Inputs are seeded numpy; parameters come from the reference's
``LM.init`` through ``repro_torch.bridge``.  Tolerances are those of
``tests/test_microbatch.py``: loss rtol 1e-5 / atol 1e-6, gradients
rtol 2e-4 / atol 1e-6 (fp32; the split sums the same terms in another
order, and the port's autograd against ``jax.grad`` adds another
order again).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro.train.accumulate import accumulated_grads as jax_accumulated
from repro.train.accumulate import split_batch as jax_split
from repro_torch import bridge
from repro_torch.core.baselines import DTRSimPlanner, SublinearPlanner
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.core.planner import (MimosePlanner, NonePlanner,
                                      fixed_train_bytes)
from repro_torch.core.simulator import simulate
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW
from repro_torch.train.accumulate import accumulated_grads, split_batch
from repro_torch.train.trainer import Trainer

REDUCED = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
               dtype="float32")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


def _ragged(B, S, vocab, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(S // 4, S + 1, B).astype(np.int32)
        lens[0] = S
    lens = np.asarray(lens, np.int32)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    w = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    tokens = tokens * w.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels, "weights": w,
            "lengths": lens}


def _torch(batch):
    dt = {"tokens": torch.long, "labels": torch.long,
          "lengths": torch.int32}
    return {k: torch.as_tensor(np.asarray(v)).to(dt.get(k, torch.float32))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    params = jlm.init(jax.random.PRNGKey(0))
    cfg = get_config("bert_base_paper").reduced(**REDUCED)
    lms = {}
    for impl in ("xla", "flash"):
        lms[impl] = LM(cfg, attn_impl=impl, device="cpu")
        bridge.load_tree(lms[impl], params)
    return jlm, params, lms


# ---------------------------------------------------------------------------
# split_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,k", [(6, 1), (6, 2), (6, 3), (5, 2), (8, 3),
                                 (3, 4)])
def test_split_batch_matches_reference(B, k):
    batch = _ragged(B, 16, 100, seed=B + k)
    want = jax_split({key: jnp.asarray(v) for key, v in batch.items()}, k)
    got = split_batch(_torch(batch), k)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_split_batch_pad_rows_are_inert():
    """A non-divisor split pads with token 0, weight 0 and length 0;
    missing weights are materialised as ones over the real rows."""
    mbs = split_batch(_torch(_ragged(5, 16, 100)), 2)       # 5 -> 6 rows
    assert tuple(mbs["tokens"].shape) == (2, 3, 16)
    assert float(mbs["weights"].reshape(6, 16)[5].sum()) == 0.0
    assert int(mbs["lengths"].reshape(6)[5]) == 0
    assert int(mbs["tokens"].reshape(6, 16)[5].abs().sum()) == 0
    plain = {"tokens": torch.ones((3, 8), dtype=torch.long),
             "labels": torch.ones((3, 8), dtype=torch.long)}
    w = split_batch(plain, 2)["weights"].reshape(4, 8)
    assert float(w[:3].sum()) == 24.0 and float(w[3].sum()) == 0.0


# ---------------------------------------------------------------------------
# accumulation numerics against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_grads_match_reference(models, impl, k):
    """Loss and every gradient of the port's k-way accumulation against
    the reference's ``accumulated_grads`` on a ragged batch of 8 rows
    (k = 3 adds a pad row of length 0)."""
    jlm, params, lms = models
    batch = _ragged(8, 48, 256, seed=3)
    jl, jm, jg = jax_accumulated(
        jlm, params, {key: jnp.asarray(v) for key, v in batch.items()}, k)
    loss, metrics, grads = accumulated_grads(lms[impl], _torch(batch), k)
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    want = bridge.state_dict_from_tree(jg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_accumulation_matches_full_batch(models, k):
    """The port's k-way result equals its own full-batch loss and
    gradients (k = 3 pads one length-0 row; k = 8 is one row each)."""
    lm = models[2]["flash"]
    batch = _torch(_ragged(8, 40, 256, seed=11))
    loss, _ = lm.loss(batch)
    params = dict(lm.named_parameters())
    full = torch.autograd.grad(loss, list(params.values()))
    got_loss, _, got = accumulated_grads(lm, batch, k)
    np.testing.assert_allclose(float(got_loss), float(loss.detach()),
                               **LOSS_TOL)
    for name, g in zip(params, full):
        np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_all_pad_microbatch_contributes_nothing(models):
    """A microbatch whose rows all have weight 0 adds no loss, no
    gradient and no tokens."""
    lm = models[2]["xla"]
    batch = _torch(_ragged(4, 32, 256, seed=5, lens=[32, 20, 0, 0]))
    loss, m, grads = accumulated_grads(lm, batch, 2)
    ref_loss, ref_m, ref_grads = accumulated_grads(
        lm, {key: v[:2] for key, v in batch.items()}, 1)
    np.testing.assert_allclose(float(loss), float(ref_loss), **LOSS_TOL)
    assert float(m["tokens"]) == float(ref_m["tokens"])
    for name in grads:
        np.testing.assert_allclose(grads[name].numpy(),
                                   ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


# ---------------------------------------------------------------------------
# the MoE's auxiliary loss under accumulation (reduced granite)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_models():
    over = dict(dtype="float32")
    jlm = build_model(jax_get_config("granite_moe_1b_a400m").reduced(**over))
    params = jlm.init(jax.random.PRNGKey(1))
    lm = LM(get_config("granite_moe_1b_a400m").reduced(**over),
            device="cpu")
    bridge.load_tree(lm, params)
    return jlm, params, lm


@pytest.mark.parametrize("k", [2, 3])
def test_moe_accumulated_grads_match_reference(moe_models, k):
    """The k-way step's loss, ce, aux and every gradient against the
    reference's ``accumulated_grads`` (aux: the token-weighted mean of
    the microbatches'; k = 3 adds a pad row of length 0)."""
    jlm, params, lm = moe_models
    batch = _ragged(8, 48, 512, seed=3)
    jl, jm, jg = jax.jit(lambda p, b: jax_accumulated(jlm, p, b, k))(
        params, {key: jnp.asarray(v) for key, v in batch.items()})
    loss, metrics, grads = accumulated_grads(lm, _torch(batch), k)
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   err_msg=key, **LOSS_TOL)
    want = bridge.state_dict_from_tree(jg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_moe_split_keeps_ce_and_weights_aux_by_tokens(moe_models):
    """k = 2 against k = 1: the cross entropy is the full batch's (to
    the loss tolerance), and aux is the token-weighted mean of the two
    microbatches' own aux, not the full batch's."""
    _, _, lm = moe_models
    batch = _torch(_ragged(8, 48, 512, seed=7))
    with torch.no_grad():
        full, m1 = lm.loss(batch)
        halves = split_batch(batch, 2)
        parts = [lm.loss({key: v[i] for key, v in halves.items()})[1]
                 for i in range(2)]
    _, m2, _ = accumulated_grads(lm, batch, 2)
    np.testing.assert_allclose(float(m2["ce"]), float(m1["ce"]),
                               **LOSS_TOL)
    tok = [float(m["tokens"]) for m in parts]
    want_aux = sum(float(m["aux"]) * t for m, t in zip(parts, tok)) \
        / sum(tok)
    np.testing.assert_allclose(float(m2["aux"]), want_aux, **LOSS_TOL)
    assert abs(float(m2["aux"]) - float(m1["aux"])) > 1e-6


# ---------------------------------------------------------------------------
# planner threading
# ---------------------------------------------------------------------------

def _plain(B, S):
    return {"tokens": torch.ones((B, S), dtype=torch.long),
            "labels": torch.ones((B, S), dtype=torch.long)}


def test_pad_waste_priced_for_non_divisor_k(models):
    planner = MimosePlanner(models[2]["xla"], 1e12, max_microbatches=3)
    batch = _plain(8, 16)
    fl = np.full(2, 1e9)
    assert planner.pad_waste_s(batch, 2, fl) == 0.0         # 8 % 2 == 0
    assert planner.pad_waste_s(batch, 3, fl) > 0.0          # 8 -> 9 rows
    assert planner.pad_waste_s(batch, 3, None) == 0.0       # byte-only


def test_candidate_ks_capped_at_batch_size(models):
    planner = MimosePlanner(models[2]["xla"], 1e12, max_microbatches=8)
    assert planner.candidate_microbatches(_plain(3, 16)) == [1, 2, 3]


def test_plan_key_includes_max_microbatches_and_roofline_constants(models):
    """Plans built under one microbatch ceiling, link rate or
    accumulation price are never replayed under another
    (tests/test_core.py::test_plan_cache_key_includes_roofline_constants
    and tests/test_microbatch.py::test_plan_cache_key_includes_max_microbatches)."""
    lm = models[2]["xla"]
    batch = _plain(4, 64)
    base = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1)
    split = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1,
                          max_microbatches=4)
    priced = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1,
                           microbatch_overhead_s=1.0)
    slow_link = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1)
    slow_link.pcie_gbps = 4.0
    same = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1)
    assert base.plan_key(batch) == same.plan_key(batch)
    for other in (split, priced, slow_link):
        assert base.plan_key(batch) != other.plan_key(batch)
        assert base.plan_key(batch)[:2] == other.plan_key(batch)[:2]


def test_plan_key_reads_the_roofline_constants_when_called(models,
                                                           monkeypatch):
    """A planner built before the constants are rebound prices its
    plans, and keys them, at the rebound values: no class attribute or
    constructor keeps a copy."""
    import repro_torch.core.planner as planner_mod
    lm = models[2]["xla"]
    batch = _plain(4, 64)
    planners = [MimosePlanner(lm, 1e12, quantum=32, warmup_samples=1),
                NonePlanner(lm),
                SublinearPlanner(lm, 1e12, max_input_size=256),
                DTRSimPlanner(lm, 1e12)]
    before = [p.plan_key(batch) for p in planners]
    monkeypatch.setattr(planner_mod, "MICROBATCH_OVERHEAD_S", 1.5)
    monkeypatch.setattr(planner_mod, "PCIE_BW", 4e9)
    for p, key in zip(planners, before):
        after = p.plan_key(batch)
        assert after != key and after[:3] == key[:3]
        assert p.accum_overhead_s() == 1.5
        assert p.link_bytes_per_s() == 4e9


def test_offload_is_refused_until_the_port_executes_it(models):
    """The port executes OFFLOAD and OFFLOAD_OPT now, so both knobs are
    accepted; what stays refused is the reference's: ``opt_offload``
    without ``offload``, and ``offload`` without the cost-aware
    selector."""
    lm = models[2]["xla"]
    p = MimosePlanner(lm, 1e12, offload=True, opt_offload=True)
    assert p.offload and p.opt_offload
    with pytest.raises(ValueError, match="needs offload=True"):
        MimosePlanner(lm, 1e12, opt_offload=True)
    with pytest.raises(ValueError, match="cost_aware"):
        MimosePlanner(lm, 1e12, offload=True, cost_aware=False)


def test_mimose_picks_split_for_tight_budget(models):
    """Below the k = 1 remat-all peak no k = 1 plan fits: the planner
    splits, and the cached plan keeps its k."""
    lm = models[2]["xla"]
    batch = _plain(8, 64)
    col = ShuttlingCollector(lm)
    fixed = fixed_train_bytes(lm.parameters())
    peaks = [simulate(col.collect(_plain(-(-8 // k), 64))
                      .activation_vector(), [True] * 2, fixed).peak_bytes
             for k in (1, 2)]
    planner = MimosePlanner(lm, 0.5 * sum(peaks), quantum=32,
                            warmup_samples=1, max_microbatches=4)
    _, info = planner.plan(batch)
    assert info.plan.microbatch > 1
    _, info2 = planner.plan(batch)
    assert info2.cache_hit and info2.plan.microbatch == info.plan.microbatch


# ---------------------------------------------------------------------------
# trainer execution and stats
# ---------------------------------------------------------------------------

class ForcedSplit(NonePlanner):
    """No checkpointing, every step split ``k`` ways."""

    def __init__(self, lm, k):
        super().__init__(lm)
        self.k = k

    def plan(self, batch):
        actions, info = super().plan(batch)
        info.plan.microbatch = self.k
        return actions, info


def test_trainer_runs_split_step_like_the_full_step(models):
    """Two steps at k = 3 give the losses of two full-batch steps, and
    the stats count the split and its pad row."""
    lm_cfg = get_config("bert_base_paper").reduced(**REDUCED)
    params = models[1]
    losses = {}
    for k in (1, 3):
        lm = LM(lm_cfg, device="cpu")
        bridge.load_tree(lm, params)
        tr = Trainer(lm, ForcedSplit(lm, k), AdamW(lr=1e-3))
        tr.run([_ragged(8, 32, 256, seed=s) for s in (1, 2)])
        losses[k] = [s.loss for s in tr.history]
        st = tr.history[-1]
        assert st.microbatches == k
        assert st.padded_tokens == (9 if k == 3 else 8) * 32
        assert tr.summary()["mean_microbatches"] == float(k)
    np.testing.assert_allclose(losses[3], losses[1], rtol=1e-5)


def test_trainer_step_key_includes_microbatch(models):
    lm = models[2]["xla"]
    tr = Trainer(lm, NonePlanner(lm))
    batch = tr._prepare({"tokens": np.ones((4, 32), np.int32),
                         "labels": np.ones((4, 32), np.int32)})
    acts = (False,) * lm.num_plan_units()
    assert tr._step_key(acts, batch, 1) != tr._step_key(acts, batch, 2)
    _, new1 = tr._get_step_fn(acts, batch, 1)
    _, new2 = tr._get_step_fn(acts, batch, 2)
    _, again = tr._get_step_fn(acts, batch, 2)
    assert new1 and new2 and not again


# ---------------------------------------------------------------------------
# chip_smoke.py's planners path, planned on a meta model at full width
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_tight_budget_forces_a_split_at_full_width():
    """The budget the planners path derives for its tight run lies
    between the simulator's k = 2 and k = 1 remat-all peaks of the
    largest bucket, and the planner, on a full-width ``meta`` model fed
    the path's own batches, splits that bucket."""
    cs = _chip_smoke()
    args = dict(cs.BERT_ARGS, steps=cs.PLANNER_STEPS)
    batches = cs.main_path_batches(args)
    budget = cs.tight_budget_mb(args, batches) * 2**20
    lm = LM(get_config(args["arch"]), attn_impl="flash", device="meta")
    fixed = fixed_train_bytes(lm.parameters())
    S = max(b["tokens"].shape[1] for b in batches)
    col = ShuttlingCollector(lm)
    peak = {k: simulate(col.collect(_plain(8 // k, S)).activation_vector(),
                        [True] * 12, fixed).peak_bytes for k in (1, 2)}
    assert peak[2] < budget < peak[1]
    planner = MimosePlanner(lm, budget, quantum=args["quantum"],
                            warmup_samples=3, max_microbatches=4)
    ks = {}
    for b in batches:
        _, info = planner.plan({key: torch.as_tensor(np.asarray(v))
                                for key, v in b.items()})
        ks[b["tokens"].shape[1]] = info.plan.microbatch
    assert ks[S] >= 2
