"""The rest of the port's scheduler (``repro_torch/core/scheduler.py``)
against the reference's ``repro.core.scheduler``: bucketing, the action
tables, the hybrid remat+offload selection, the escalation ladder, the
joint (microbatch, action) search and the seed's list-based Algorithm 1.

The module is a copy, so with the port's roofline constants pinned to
the reference's (``torch_pins``) every plan must agree exactly: the
same actions and k, the same freed bytes, recompute FLOPs and host
bytes.  ``tests/test_torch_planner.py::test_greedy_plan_matches_reference``
holds the KEEP/REMAT path.
"""
import numpy as np
import pytest

from repro.core import scheduler as ref
from repro_torch.actions import Action
from repro_torch.core import scheduler as sch
from torch_pins import pin_reference_constants


@pytest.fixture
def pinned(monkeypatch):
    return pin_reference_constants(monkeypatch)


def _vectors(rng, n, opt=True):
    est = rng.uniform(1e6, 1e8, n)
    if rng.random() < 0.3:
        est = np.round(est / 2e7) * 2e7 + 1.0         # ties and buckets
    d = {"est_mem": est,
         "output_bytes": rng.uniform(0.0, 3e7, n),
         "offload_bytes": rng.uniform(0.0, 1.2e8, n),
         "flops": rng.uniform(1e9, 1e13, n)}
    if opt:
        d["opt_bytes"] = rng.uniform(0.0, 6e7, n)
    return d


def _same_plan(a, b):
    assert tuple(int(x) for x in a.as_actions()) == \
        tuple(int(x) for x in b.as_actions())
    for field in ("excess_bytes", "covered_bytes", "est_activation_bytes",
                  "n_remat", "recompute_flops", "offload_bytes",
                  "n_offload", "opt_offload_bytes", "n_opt", "microbatch",
                  "source"):
        assert getattr(a, field) == getattr(b, field), field


@pytest.mark.parametrize("n", [1, 4, 12, 24])
def test_build_buckets_matches_reference(n):
    rng = np.random.default_rng(n)
    for tol in (0.0, 0.1, 0.3):
        est = np.round(rng.uniform(1.0, 10.0, n)) * 1e6
        assert sch.build_buckets(est, tol) == ref.build_buckets(est, tol)
    assert sch.build_buckets([], 0.1) == ref.build_buckets([], 0.1) == []


@pytest.mark.parametrize("seed", range(4))
def test_action_tables_and_candidates_match_reference(pinned, seed):
    rng = np.random.default_rng(seed)
    v = _vectors(rng, 10)
    kw = dict(opt_bytes=v["opt_bytes"], pcie_bytes_per_s=2e10,
              offload_overlap=0.3)
    a = sch.action_tables(v["est_mem"], v["output_bytes"],
                          v["offload_bytes"], v["flops"], **kw)
    b = ref.action_tables(v["est_mem"], v["output_bytes"],
                          v["offload_bytes"], v["flops"], **kw)
    for field in ("est", "out", "off", "fl", "t_re", "t_off", "freed_re",
                  "freed_off", "opt", "t_opt", "freed_opt"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for allow in (True, False):
        assert sch.action_candidates(a, allow) == \
            ref.action_candidates(b, allow)


@pytest.mark.parametrize("opt", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_greedy_plan_with_offload_vectors_matches_reference(pinned, opt,
                                                            seed):
    """The hybrid path (``_hybrid_plan``): same actions, freed bytes,
    FLOPs and host bytes, over budgets from hopeless to roomy."""
    rng = np.random.default_rng(10 * seed + opt)
    for _ in range(40):
        n = int(rng.integers(1, 16))
        v = _vectors(rng, n, opt=opt)
        fixed = float(rng.uniform(0, 1e9))
        budget = fixed + float(v["est_mem"].sum()) * float(
            rng.uniform(0.0, 1.2))
        kw = dict(flops=v["flops"], output_bytes=v["output_bytes"],
                  offload_bytes=v["offload_bytes"],
                  opt_bytes=v.get("opt_bytes"),
                  offload_overlap=float(rng.uniform(0, 1)))
        if rng.random() < 0.5:
            kw["pcie_bytes_per_s"] = float(rng.uniform(1e9, 6e10))
        _same_plan(sch.greedy_plan(v["est_mem"], budget, fixed, **kw),
                   ref.greedy_plan(v["est_mem"], budget, fixed, **kw))


@pytest.mark.parametrize("start", ["none", "remat_mask", "mixed"])
def test_escalate_plan_matches_reference(pinned, start):
    rng = np.random.default_rng(len(start))
    for _ in range(40):
        n = int(rng.integers(1, 14))
        v = _vectors(rng, n)
        fixed = float(rng.uniform(0, 1e9))
        budget = fixed + float(v["est_mem"].sum()) * float(
            rng.uniform(0.0, 1.0))
        acts = {"none": None,
                "remat_mask": [bool(b) for b in rng.integers(0, 2, n)],
                "mixed": [int(c) for c in rng.integers(0, 4, n)]}[start]
        kw = dict(output_bytes=v["output_bytes"],
                  offload_bytes=v["offload_bytes"],
                  opt_bytes=v["opt_bytes"], offload_overlap=0.5)
        _same_plan(sch.escalate_plan(acts, v["est_mem"], v["flops"], budget,
                                     fixed, **kw),
                   ref.escalate_plan(acts, v["est_mem"], v["flops"], budget,
                                     fixed, **kw))


def _vectors_of_k(rng, n, kinds):
    """Per-microbatch vectors at split k (bytes ~1/k plus a constant,
    FLOPs ~1/k, pad overheads), seeded once per instance."""
    base = _vectors(rng, n)
    const = rng.uniform(0.0, 5e6, n)
    pads = {k: float(rng.uniform(0, 3e-4)) if k > 1 else 0.0
            for k in range(1, 9)}

    def vectors_of_k(k):
        d = {"est_mem": base["est_mem"] / k + const,
             "flops": base["flops"] / k, "pad_overhead_s": pads[k]}
        if "offload" in kinds:
            d["output_bytes"] = base["output_bytes"] / k
            d["offload_bytes"] = base["offload_bytes"] / k
        if "byte_only" in kinds:
            d.pop("flops")
            d.pop("pad_overhead_s")
        return d
    return vectors_of_k


@pytest.mark.parametrize("kinds", [(), ("offload",), ("byte_only",)])
@pytest.mark.parametrize("max_k", [1, 2, 4])
def test_greedy_plan_adaptive_matches_reference(pinned, kinds, max_k):
    rng = np.random.default_rng(max_k + 10 * len(kinds))
    for _ in range(25):
        n = int(rng.integers(1, 14))
        vok = _vectors_of_k(rng, n, kinds)
        fixed = float(rng.uniform(0, 1e9))
        budget = fixed + float(vok(1)["est_mem"].sum()) * float(
            rng.uniform(0.0, 1.2))
        kw = dict(max_microbatches=max_k,
                  accum_overhead_s=float(rng.uniform(0, 2e-3)))
        if rng.random() < 0.5:
            kw = dict(candidate_ks=[1, max_k, max_k + 1])
        _same_plan(sch.greedy_plan_adaptive(vok, budget, fixed, **kw),
                   ref.greedy_plan_adaptive(vok, budget, fixed, **kw))


def test_greedy_plan_adaptive_default_overhead_is_the_roofline_constant(
        pinned):
    """With no ``accum_overhead_s`` both packages charge their own
    ``MICROBATCH_OVERHEAD_S`` — equal once pinned."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        vok = _vectors_of_k(rng, 8, ())
        budget = float(vok(1)["est_mem"].sum()) * float(rng.uniform(0.1, 1))
        _same_plan(sch.greedy_plan_adaptive(vok, budget, max_microbatches=4),
                   ref.greedy_plan_adaptive(vok, budget, max_microbatches=4))


def test_adaptive_splits_when_no_k1_plan_fits(pinned):
    """Below the k = 1 all-remat floor the search picks k > 1
    (tests/test_microbatch.py::test_adaptive_escalates_k_when_k1_infeasible)."""
    def vok(k):
        return {"est_mem": np.full(4, 100.0) / k, "flops": np.full(4, 1e9)}
    plan = sch.greedy_plan_adaptive(vok, 100.0 + 150.0, 100.0,
                                    max_microbatches=4)
    assert plan.microbatch > 1
    assert sch.greedy_plan_adaptive(vok, 1e9, 100.0,
                                    max_microbatches=4).microbatch == 1


@pytest.mark.parametrize("seed", range(4))
def test_greedy_plan_reference_matches_reference_and_fast_path(seed):
    """The seed's list-based Algorithm 1 equals the reference's copy and
    the vectorised byte-only path, tie-breaks included."""
    rng = np.random.default_rng(seed)
    for trial in range(50):
        n = int(rng.integers(1, 24))
        est = rng.uniform(1.0, 1e9, n)
        if trial % 2:
            est = np.round(est / 1e8) * 1e8 + 1.0
        fixed = float(rng.uniform(0, 1e9))
        budget = fixed + float(est.sum()) * float(rng.uniform(0.0, 1.1))
        a = sch.greedy_plan_reference(est, budget, fixed)
        _same_plan(a, ref.greedy_plan_reference(est, budget, fixed))
        fast = sch.greedy_plan(est, budget, fixed, byte_only=True)
        assert a.as_actions() == fast.as_actions()
        assert a.covered_bytes == fast.covered_bytes


def test_plan_carries_microbatch_source_and_host_counts():
    p = sch.Plan([], 0.0, 0.0, 0.0,
                 actions=(Action.KEEP, Action.REMAT, Action.OFFLOAD,
                          Action.OFFLOAD_OPT))
    assert (p.n_remat, p.n_offload, p.n_opt) == (1, 1, 1)
    assert p.remat == [False, True, False, False]
    assert p.as_tuple() == (False, True, False, False)
    assert (p.microbatch, p.source) == (1, "greedy")
    q = sch.Plan([True, False], 1.0, 1.0, 2.0, microbatch=3, source="dp")
    assert q.as_actions() == (Action.REMAT, Action.KEEP)
    assert (q.microbatch, q.source) == (3, "dp")
