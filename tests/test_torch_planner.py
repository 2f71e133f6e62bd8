"""The port's Mimose core (estimator, scheduler, cache, collector,
planner) against the reference's.

The estimator, scheduler and cache are copies, so on the same vectors
they must give the same results.  The collector counts what PyTorch's
autograd saves, which is not what ``jax.vjp`` keeps: on the reduced
``bert_base_paper`` block with plain (``xla``) attention the port counts
0.43-0.54x the reference's bytes for S in 32..256.  The reference's
linearisation holds three score-sized tensors per block (the masked
scores, the exponentials and the softmax output) plus GELU's four
(B, S, d_ff) intermediates; autograd holds the softmax output and the
permuted copy ``einsum`` makes of it, and one GELU input.  So the byte
vector is held to [0.35, 0.75] of the reference's, and both grow the
same way (superlinear in S).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cache import LRUCache as JaxLRU
from repro.core.collector import ShuttlingCollector as JaxCollector
from repro.core.estimator import PolyEstimator as JaxPoly
from repro.core.scheduler import greedy_plan as jax_greedy
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch.core.cache import LRUCache
from repro_torch.core.collector import ShuttlingCollector
from repro_torch.core.estimator import PolyEstimator
from repro_torch.core.planner import (MimosePlanner, NonePlanner,
                                      fixed_train_bytes)
from repro_torch.core.scheduler import greedy_plan
from repro_torch.core.simulator import simulate
from repro_torch.launch import roofline
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config

REDUCED = dict(num_layers=4, d_model=128, d_ff=256, vocab_size=512,
               dtype="float32")


@pytest.fixture(scope="module")
def lms():
    cfg = get_config("bert_base_paper").reduced(**REDUCED)
    return {impl: LM(cfg, attn_impl=impl, device="cpu")
            for impl in ("xla", "flash")}


def _batch(S, B=2):
    return {"tokens": torch.ones((B, S), dtype=torch.long),
            "labels": torch.ones((B, S), dtype=torch.long)}


# ---------------------------------------------------------------------------
# copied modules: identical results on identical inputs
# ---------------------------------------------------------------------------

def test_poly_estimator_matches_reference():
    rng = np.random.default_rng(0)
    ours, ref = PolyEstimator(2, min_samples=3), JaxPoly(2, min_samples=3)
    for s in (512, 1024, 2048, 4096):
        acts = rng.uniform(1e6, 1e8, 6) + 3.0 * s * s
        ours.add_sample(s, acts)
        ref.add_sample(s, acts)
        assert ours.ready == ref.ready
    for s in (700, 3000, 8192):
        np.testing.assert_array_equal(ours.predict(s), ref.predict(s))


@pytest.mark.parametrize("byte_only", [True, False])
def test_greedy_plan_matches_reference(byte_only):
    rng = np.random.default_rng(1)
    for trial in range(200):
        n = int(rng.integers(1, 24))
        est = rng.uniform(1.0, 1e9, n)
        if trial % 2:
            est = np.round(est / 1e8) * 1e8 + 1.0      # ties and buckets
        fl = rng.uniform(1e9, 1e13, n)
        fixed = float(rng.uniform(0, 1e9))
        budget = fixed + float(est.sum()) * float(rng.uniform(0.0, 1.1))
        a = greedy_plan(est, budget, fixed, flops=fl, byte_only=byte_only)
        b = jax_greedy(est, budget, fixed, flops=fl, byte_only=byte_only)
        assert tuple(int(x) for x in a.as_actions()) == \
            tuple(int(x) for x in b.as_actions()), trial
        assert a.covered_bytes == b.covered_bytes
        assert a.recompute_flops == b.recompute_flops


def test_lru_cache_matches_reference():
    ops = [("set", k % 7) for k in range(20)] + [("get", 3), ("set", 11),
                                                 ("pop", 5), ("set", 12)]
    ours, ref = LRUCache(4), JaxLRU(4)
    for op, key in ops:
        for c in (ours, ref):
            if op == "set":
                c[key] = key * 10
            elif op == "get":
                c.get(key)
            else:
                c.pop(key)
        assert list(ours.keys()) == list(ref.keys())
        assert ours.evictions == ref.evictions


# ---------------------------------------------------------------------------
# collector
# ---------------------------------------------------------------------------

def test_collector_monotone_in_input_size(lms):
    col = ShuttlingCollector(lms["flash"])
    totals = [col.collect(_batch(S)).total_activation_bytes()
              for S in (32, 64, 128)]
    assert totals[0] < totals[1] < totals[2]


def test_collector_superlinear_with_xla_linear_with_flash(lms):
    """Plain attention saves the (S, S) softmax: doubling S more than
    doubles the bytes.  The flash function saves O(S) residuals."""
    t = {impl: [ShuttlingCollector(lm).collect(_batch(S))
                .total_activation_bytes() for S in (64, 128)]
         for impl, lm in lms.items()}
    assert t["xla"][1] > 2.0 * t["xla"][0]
    assert t["flash"][1] <= 2.0 * t["flash"][0]
    assert t["flash"][1] < t["xla"][1]


def test_collector_bytes_within_tolerance_of_reference():
    cfg = dict(REDUCED, num_layers=2)
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**cfg))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config("bert_base_paper").reduced(**cfg), device="cpu")
    for S in (32, 64, 128, 256):
        ref = JaxCollector(jlm).collect(
            params, {"tokens": jnp.ones((2, S), jnp.int32)})
        ours = ShuttlingCollector(lm).collect(_batch(S))
        ratio = ours.activation_vector() / ref.activation_vector()
        assert np.all((ratio > 0.35) & (ratio < 0.75)), (S, ratio)
        np.testing.assert_array_equal(ours.output_vector(),
                                      ref.output_vector())
        np.testing.assert_array_equal(ours.flops_vector(),
                                      ref.flops_vector())
        assert np.all(ours.offloadable_vector()
                      <= ours.activation_vector())


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "hymba_1p5b"])
def test_collector_new_families_match_reference_flops_and_outputs(arch):
    """The moe and hybrid units: FLOPs and output bytes equal to the
    reference's; residual bytes positive and below the reference's (the
    ratio is data, ROADMAP §C: ``tests/torch_collector_ratios.py``)."""
    from torch_collector_ratios import collections
    for S, (ours, ref) in collections(arch, "xla").items():
        np.testing.assert_array_equal(ours.flops_vector(),
                                      ref.flops_vector())
        np.testing.assert_array_equal(ours.output_vector(),
                                      ref.output_vector())
        acts = ours.activation_vector()
        assert np.all(acts > 0) and np.all(acts < ref.activation_vector())


def test_weight_grad_residuals_exceed_input_only_count(lms):
    """The planner counts what the input gradient needs (as the
    reference); training also keeps each matmul's input for the weight
    gradient, so that count is a strict lower bound."""
    from repro_torch.core.collector import unit_residual_bytes
    lm = lms["flash"]
    unit = lm.plan_units(_batch(64))[0]
    shape = (2, 64, lm.cfg.d_model)
    x_only = unit_residual_bytes(unit, shape, lm.dtype)
    train = unit_residual_bytes(unit, shape, lm.dtype, weight_grads=True)
    assert train["activation_bytes"] > x_only["activation_bytes"]
    assert train["param_bytes"] == x_only["param_bytes"]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dedup_collector_matches_per_unit_byte_for_byte(lms, impl):
    lm = lms[impl]
    base = ShuttlingCollector(lm, dedup=False).collect(_batch(96))
    fast = ShuttlingCollector(lm, dedup=True).collect(_batch(96))
    for r0, r1 in zip(base.records, fast.records):
        assert r0 == r1
    assert fast.traced_units == 1 and fast.dedup_hits == 3
    assert base.traced_units == 4 and base.dedup_hits == 0


# ---------------------------------------------------------------------------
# planner (tests/test_core.py planner tests, ported)
# ---------------------------------------------------------------------------

def test_planner_cache_hit_and_estimator_accuracy(lms):
    lm = lms["flash"]
    fixed = fixed_train_bytes(lm.parameters())
    total128 = ShuttlingCollector(lm).collect(
        _batch(128)).total_activation_bytes()
    planner = MimosePlanner(lm, fixed + total128 // 2, warmup_samples=3,
                            quantum=32)
    for i, S in enumerate((32, 64, 96)):
        _, info = planner.plan(_batch(S))
        assert info.collected and not info.cache_hit
        assert planner.estimator.ready == (i == 2)
    mask, info = planner.plan(_batch(128))
    assert not info.cache_hit and not info.collected     # predicted
    pred = planner.estimator.predict(2 * 128).sum()
    assert abs(pred - total128) / total128 < 0.02
    assert 0 < sum(mask) < len(mask)                     # mixed plan
    mask2, info2 = planner.plan(_batch(128))
    assert info2.cache_hit and mask2 == mask
    assert planner.stats["cache_hits"] == 1
    assert planner.stats["collections"] == 3


def test_planner_no_remat_when_budget_ample(lms):
    planner = MimosePlanner(lms["flash"], budget_bytes=1e12,
                            warmup_samples=1)
    mask, _ = planner.plan(_batch(64))
    assert not any(mask)


def test_planner_remats_under_tight_budget(lms):
    lm = lms["xla"]
    fixed = fixed_train_bytes(lm.parameters())
    planner = MimosePlanner(lm, fixed, warmup_samples=1)
    mask, info = planner.plan(_batch(64))
    assert all(mask)
    assert info.plan.covered_bytes == info.plan.est_activation_bytes


def test_planner_audit_detects_and_fixes_drift(lms):
    lm = lms["xla"]
    planner = MimosePlanner(lm, budget_bytes=1e12, warmup_samples=2,
                            quantum=8, audit_every=1)
    for S in (32, 48):
        planner.plan(_batch(S))
    assert planner.estimator.ready
    planner.estimator.fit()
    planner.estimator._coeffs = planner.estimator._coeffs * 3.0
    planner.plan(_batch(96))
    assert planner.stats["audits"] >= 1 and planner.stats["refits"] >= 1
    truth = ShuttlingCollector(lm).collect(
        _batch(128)).total_activation_bytes()
    pred = planner.estimator.predict(2 * 128).sum()
    assert abs(pred - truth) / truth < 0.05


def test_fixed_train_bytes_accounts_adam(lms):
    params = list(lms["xla"].parameters())
    n = sum(p.numel() for p in params)
    assert fixed_train_bytes(params) == 4 * n + 4 * n + 8 * n


def test_none_planner_keeps_everything(lms):
    mask, info = NonePlanner(lms["xla"]).plan(_batch(64))
    assert not any(mask) and len(mask) == 4 and info.quantized_size == 128


# ---------------------------------------------------------------------------
# the planning rate follows the model's dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recompute_priced_at_the_rate_of_the_models_dtype(dtype):
    """A planner hands the simulator FLOPs that, over ``PEAK_FLOPS``,
    give the recompute time at the GEMM rate of the model's dtype: fp32
    models at ``PEAK_FLOPS`` (the vector passes unchanged), bf16 models
    at ``PEAK_FLOPS_BF16``."""
    cfg = dataclasses.replace(
        get_config("granite_moe_1b_a400m").reduced(), dtype=dtype)
    lm = LM(cfg, device="meta")
    planner = MimosePlanner(lm, 1e12, quantum=32)
    flops = np.array([3e12, 5e12])
    scaled = planner.planning_flops(flops)
    rate = (roofline.PEAK_FLOPS if dtype == "float32"
            else roofline.PEAK_FLOPS_BF16)
    if dtype == "float32":
        assert scaled is flops
    r = simulate([1e6, 1e6], [True, False], 0.0, [0.0, 0.0], scaled)
    np.testing.assert_allclose(r.recompute_time_s, 3e12 / rate, rtol=1e-12)
    assert planner.planning_flops(None) is None


def test_recompute_scale_reads_the_constants_when_called(monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", 2.0 * roofline.PEAK_FLOPS)
    assert roofline.recompute_scale(torch.bfloat16) == 0.5
    assert roofline.recompute_scale("float16") == 0.5
    assert roofline.recompute_scale("float32") == 1.0
