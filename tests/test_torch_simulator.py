"""The port's liveness simulator (``repro_torch/core/simulator.py``)
against the reference's ``repro.core.simulator``.

The module is a copy, so on the same seeded vectors every result must
be identical — exactly, not within a tolerance — once the port's
roofline constants are pinned to the reference's (``torch_pins``):
KEEP / REMAT / OFFLOAD / OFFLOAD_OPT plans, k in 1..4, with and without
the optional vectors.  Unpinned, the port prices recompute and host
traffic at its own H100 constants.
"""
import numpy as np
import pytest

from repro.core import simulator as ref
from repro.launch import roofline as ref_roofline
from repro_torch.core import simulator as sim
from repro_torch.launch import roofline
from torch_pins import pin_reference_constants


@pytest.fixture
def pinned(monkeypatch):
    return pin_reference_constants(monkeypatch)


def _instance(rng, n, codes=4, vectors=("out", "off", "opt", "fl")):
    act = rng.uniform(1.0, 1e8, n)
    kw = {}
    if "out" in vectors:
        kw["output_bytes"] = rng.uniform(0.0, 3e7, n)
    if "fl" in vectors:
        kw["flops"] = rng.uniform(0.0, 1e12, n)
    if "off" in vectors:
        kw["offload_bytes"] = rng.uniform(0.0, 1.2e8, n)
    if "opt" in vectors:
        kw["opt_bytes"] = rng.uniform(-1e6, 5e7, n)
    plan = [int(c) for c in rng.integers(0, codes, n)]
    return act, plan, kw


def _fields(r):
    return (r.peak_bytes, r.recompute_bytes, r.recompute_units, r.timeline,
            r.recompute_flops, r.offload_bytes, r.offload_units,
            r.offload_time_s, r.exposed_transfer_s, r.opt_offload_bytes,
            r.opt_offload_units, r.opt_transfer_s, r.microbatches,
            r.accum_overhead_s, r.recompute_time_s, r.step_overhead_s)


VECTOR_SETS = [(), ("fl",), ("out", "fl"), ("out", "off", "fl"),
               ("out", "off", "opt", "fl")]


@pytest.mark.parametrize("vectors", VECTOR_SETS)
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_simulate_matches_reference(pinned, vectors, k):
    rng = np.random.default_rng(100 * k + len(vectors))
    for _ in range(40):
        n = int(rng.integers(0, 12))
        act, plan, kw = _instance(rng, n, vectors=vectors)
        fixed = float(rng.uniform(0, 1e9))
        extra = dict(microbatch=k, accum_overhead_s=float(rng.uniform(0, 1e-2)),
                     overlap=float(rng.uniform(0, 1)))
        if rng.random() < 0.5:
            extra["pcie_bytes_per_s"] = float(rng.uniform(1e9, 6e10))
        got = sim.simulate(act, plan, fixed, **kw, **extra)
        want = ref.simulate(act, plan, fixed, **kw, **extra)
        assert _fields(got) == _fields(want)


@pytest.mark.parametrize("mask_kind", ["bools", "actions"])
def test_simulate_takes_bool_masks_and_actions(pinned, mask_kind):
    rng = np.random.default_rng(7)
    act = rng.uniform(1.0, 1e8, 8)
    mask = [bool(b) for b in rng.integers(0, 2, 8)]
    plan = mask if mask_kind == "bools" else [int(b) for b in mask]
    assert _fields(sim.simulate(act, plan, 1e6)) == \
        _fields(ref.simulate(act, plan, 1e6))


@pytest.mark.parametrize("vectors", VECTOR_SETS)
@pytest.mark.parametrize("k", [1, 3])
def test_simulate_many_matches_reference(pinned, vectors, k):
    rng = np.random.default_rng(7 + k)
    for _ in range(10):
        n = int(rng.integers(1, 9))
        act, _, kw = _instance(rng, n, vectors=vectors)
        plans = rng.integers(0, 4, (64, n))
        fixed = float(rng.uniform(0, 1e9))
        extra = dict(microbatch=k, accum_overhead_s=1e-3, overlap=0.3)
        got = sim.simulate_many(act, plans, fixed, **kw, **extra)
        want = ref.simulate_many(act, plans, fixed, **kw, **extra)
        for field in ("peak_bytes", "step_overhead_s", "recompute_flops",
                      "offload_bytes", "exposed_transfer_s",
                      "opt_offload_bytes"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), field)
        assert (got.microbatches, got.accum_overhead_s) == \
            (want.microbatches, want.accum_overhead_s)
        # and each row is the scalar replay, up to summation order
        for j in range(0, 64, 16):
            one = sim.simulate(act, plans[j], fixed, **kw, **extra)
            np.testing.assert_allclose(got.peak_bytes[j], one.peak_bytes,
                                       rtol=1e-12)
            np.testing.assert_allclose(got.step_overhead_s[j],
                                       one.step_overhead_s, rtol=1e-12)


def test_simulate_many_rejects_a_flat_plan():
    with pytest.raises(ValueError):
        sim.simulate_many([1.0, 2.0], [0, 1])


@pytest.mark.parametrize("frag", [1.0, 1.25, 1.5])
def test_dtr_simulate_matches_reference(frag):
    rng = np.random.default_rng(int(frag * 100))
    for _ in range(50):
        n = int(rng.integers(0, 16))
        act = rng.uniform(1.0, 1e8, n)
        fixed = float(rng.uniform(0, 1e8))
        budget = fixed + float(act.sum()) * float(rng.uniform(0.0, 1.5))
        assert sim.dtr_simulate(act, budget, fixed, frag) == \
            ref.dtr_simulate(act, budget, fixed, frag)


def test_peak_if_checkpointing_unit_matches_reference():
    rng = np.random.default_rng(3)
    act = rng.uniform(1.0, 1e8, 12)
    for which in range(12):
        assert sim.peak_if_checkpointing_unit(act, which, 5e7) == \
            ref.peak_if_checkpointing_unit(act, which, 5e7)


def test_port_constants_are_the_h100s_not_the_tpus():
    """The port's planning constants are its own: none is the
    reference's TPU value, and each is a positive rate or time."""
    for name in ("PEAK_FLOPS", "PCIE_BW", "MICROBATCH_OVERHEAD_S"):
        mine, tpu = getattr(roofline, name), getattr(ref_roofline, name)
        assert mine > 0 and mine != tpu, name
    # the bf16 rate against the TPU's (its PEAK_FLOPS is a bf16 rate)
    assert roofline.PEAK_FLOPS_BF16 > roofline.PEAK_FLOPS
    assert roofline.PEAK_FLOPS_BF16 != ref_roofline.PEAK_FLOPS


def test_unpinned_simulate_prices_at_the_port_constants():
    """Without the pin, recompute time is FLOPs over the port's
    ``PEAK_FLOPS`` and the link default is the port's ``PCIE_BW``."""
    r = sim.simulate([1e6, 2e6], [1, 2], 0.0, [0.0, 0.0], [4e12, 1e12],
                     overlap=0.0, microbatch=2, accum_overhead_s=1e-3)
    assert r.recompute_time_s == r.recompute_flops / roofline.PEAK_FLOPS
    assert r.offload_time_s == 2.0 * r.offload_bytes / roofline.PCIE_BW
    assert r.step_overhead_s == (r.recompute_time_s + r.exposed_transfer_s
                                 + 1e-3)
