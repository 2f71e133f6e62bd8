"""The port's optimal-plan solver (``repro_torch/core/solver.py``)
against the reference's ``repro.core.solver`` and the brute-force
``tests/oracle.py``, and its background tier on the port's trainer.

With the roofline constants pinned to the reference's (``torch_pins``)
``solve`` gives the reference's plan, k and score exactly on seeded
instances, and for n <= 8 the oracle's optimum (score to rel 1e-9, the
oracle's own tolerance in ``tests/test_solver.py``: it sums the same
terms through the scalar replay while ``solve`` may reach the optimum
through another candidate).  The swap tests are
``tests/test_solver.py:253-389`` on the port's ``Trainer``: a swap
builds a new step function for the replaced bucket only, a stale solve
is dropped, a timeout is counted, and the solver is off by default.
"""
import dataclasses
import math
import threading
import time

import numpy as np
import pytest
import torch

from oracle import oracle
from repro.core import solver as ref
from repro_torch.actions import Action
from repro_torch.core import solver as sol
from repro_torch.core.planner import MimosePlanner
from repro_torch.core.scheduler import Plan, greedy_plan_adaptive
from repro_torch.core.simulator import simulate
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer
from torch_pins import pin_reference_constants


@pytest.fixture
def pinned(monkeypatch):
    return pin_reference_constants(monkeypatch)


def _instance(rng, n_min, n_max):
    """One seeded planning instance (``tests/test_solver.py::_instance``):
    byte vectors, flops, link pricing, budget, per-k pad overheads."""
    n = int(rng.integers(n_min, n_max + 1))
    f = lambda: float(rng.uniform(0.0, 1.0))          # noqa: E731
    act = [1.0 + 99.0 * f() for _ in range(n)]
    out = [30.0 * f() for _ in range(n)]
    off = [120.0 * f() for _ in range(n)]
    fl = [1e12 * f() for _ in range(n)]
    fixed = 50.0 * f()
    budget = fixed + (0.05 + 1.2 * f()) * (sum(act) + sum(out) + 1.0)
    pcie, overlap, accum = 1e9 + 31e9 * f(), f(), 1e-3 * f()
    pads = {1: 0.0, 2: 2e-5 * f(), 3: 3e-5 * f(), 4: 4e-5 * f()}

    def vectors_of_k(k):
        sc = 1.0 / k
        return {"est_mem": np.array(act) * sc,
                "output_bytes": np.array(out) * sc,
                "offload_bytes": np.array(off) * sc,
                "flops": np.array(fl) * sc, "pad_overhead_s": pads[k]}

    return {"vok": vectors_of_k, "budget": budget, "fixed": fixed,
            "pcie": pcie, "overlap": overlap, "accum": accum, "n": n}


def _solve(mod, inst, **kw):
    kw.setdefault("candidate_ks", [1, 2, 3])
    return mod.solve(inst["vok"], inst["budget"], inst["fixed"],
                     pcie_bytes_per_s=inst["pcie"],
                     offload_overlap=inst["overlap"],
                     accum_overhead_s=inst["accum"], **kw)


def _same_result(a, b):
    assert (a.feasible, a.score, a.overhead_s, a.peak_bytes, a.method,
            a.timed_out) == (b.feasible, b.score, b.overhead_s,
                             b.peak_bytes, b.method, b.timed_out)
    if a.plan is None or b.plan is None:
        assert a.plan is None and b.plan is None
        return
    assert tuple(int(x) for x in a.plan.actions) == \
        tuple(int(x) for x in b.plan.actions)
    assert (a.plan.microbatch, a.plan.recompute_flops,
            a.plan.offload_bytes) == (b.plan.microbatch,
                                      b.plan.recompute_flops,
                                      b.plan.offload_bytes)


@pytest.mark.parametrize("method", ["exhaustive", "dp", "auto"])
@pytest.mark.parametrize("seed", range(3))
def test_solve_matches_reference(pinned, method, seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        inst = _instance(rng, 0, 6 if method == "exhaustive" else 12)
        _same_result(_solve(sol, inst, method=method),
                     _solve(ref, inst, method=method))


@pytest.mark.parametrize("seed", range(2))
def test_solve_matches_reference_on_long_chains(pinned, seed):
    """n = 10..24: only the DP runs, with its Pareto frontier and, past
    ``max_states``, its byte grid."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        inst = _instance(rng, 10, 24)
        for kw in ({}, {"max_states": 64}, {"grid_bytes": 4.0}):
            _same_result(_solve(sol, inst, candidate_ks=[1, 2], method="dp",
                                **kw),
                         _solve(ref, inst, candidate_ks=[1, 2], method="dp",
                                **kw))


@pytest.mark.parametrize("seed", range(4))
def test_solve_matches_oracle_small_n(pinned, seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(4):
        inst = _instance(rng, 0, 5)
        truth = oracle(inst["vok"], inst["budget"], inst["fixed"],
                       candidate_ks=[1, 2, 3], pcie_bytes_per_s=inst["pcie"],
                       offload_overlap=inst["overlap"],
                       accum_overhead_s=inst["accum"])
        for method in ("exhaustive", "dp"):
            res = _solve(sol, inst, method=method)
            assert res.feasible == truth.feasible, (method, inst["n"])
            if truth.feasible:
                assert math.isclose(res.score, truth.score, rel_tol=1e-9,
                                    abs_tol=1e-12), (method, inst["n"])


@pytest.mark.parametrize("seed", range(3))
def test_solve_never_worse_than_greedy(pinned, seed):
    rng = np.random.default_rng(2000 + seed)
    for _ in range(6):
        inst = _instance(rng, 0, 16)
        greedy = greedy_plan_adaptive(inst["vok"], inst["budget"],
                                      inst["fixed"], candidate_ks=[1, 2, 3],
                                      pcie_bytes_per_s=inst["pcie"],
                                      offload_overlap=inst["overlap"],
                                      accum_overhead_s=inst["accum"])
        v = inst["vok"](greedy.microbatch)
        g = simulate(v["est_mem"], greedy.actions, inst["fixed"],
                     v["output_bytes"], v["flops"],
                     offload_bytes=v["offload_bytes"],
                     pcie_bytes_per_s=inst["pcie"], overlap=inst["overlap"],
                     microbatch=greedy.microbatch,
                     accum_overhead_s=inst["accum"])
        res = _solve(sol, inst)
        if g.peak_bytes <= inst["budget"] + 1e-6:
            assert res.feasible
            assert res.score <= g.step_overhead_s + v["pad_overhead_s"] \
                + 1e-12


@pytest.mark.parametrize("n,base", [(0, 3), (3, 3), (5, 3), (4, 4), (8, 4)])
def test_enumerate_plans_matches_reference(n, base):
    np.testing.assert_array_equal(sol.enumerate_plans(n, base),
                                  ref.enumerate_plans(n, base))


def test_enumerate_plans_refuses_too_many():
    with pytest.raises(ValueError):
        sol.enumerate_plans(13)
    with pytest.raises(ValueError):
        sol.enumerate_plans(9, base=4)


@pytest.mark.parametrize("seed", range(3))
def test_dp_and_exhaustive_actions_match_reference(pinned, seed):
    """The two exact tiers on OFFLOAD_OPT-enabled tables."""
    from repro.core.scheduler import action_tables as ref_tables
    from repro_torch.core.scheduler import action_tables
    rng = np.random.default_rng(3000 + seed)
    for _ in range(6):
        n = int(rng.integers(1, 8))
        v = [rng.uniform(1.0, 100.0, n), rng.uniform(0.0, 30.0, n),
             rng.uniform(0.0, 120.0, n), rng.uniform(0.0, 1e12, n)]
        kw = dict(opt_bytes=rng.uniform(0.0, 60.0, n),
                  pcie_bytes_per_s=2e10, offload_overlap=0.4)
        a, b = action_tables(*v, **kw), ref_tables(*v, **kw)
        fixed = 20.0
        budget = fixed + float(v[0].sum()) * float(rng.uniform(0.1, 1.2))
        assert sol._dp_actions(a, budget - fixed) == \
            ref._dp_actions(b, budget - fixed)
        for k in (1, 3):
            assert sol._exhaustive_actions(a, budget, fixed, k, 2e10, 0.4,
                                           1e-3) == \
                ref._exhaustive_actions(b, budget, fixed, k, 2e10, 0.4, 1e-3)


def test_solve_timeout_returns_best_so_far(pinned):
    inst = {"vok": lambda k: {"est_mem": np.full(6, 10.0) / k},
            "budget": 100.0, "fixed": 0.0, "pcie": 16e9,
            "overlap": 0.5, "accum": 0.0}
    res = _solve(sol, inst, deadline_s=1e-9)
    assert res.timed_out
    assert res.plan is not None and res.feasible


def test_solve_reports_infeasible_min_peak():
    res = sol.solve(lambda k: {"est_mem": np.full(4, 100.0) / k}, 1.0, 50.0,
                    candidate_ks=[1])
    assert not res.feasible and res.plan is not None
    assert res.peak_bytes > 1.0


# ---------------------------------------------------------------------------
# BackgroundSolver: the swap protocol on the port's planner and trainer
# ---------------------------------------------------------------------------
HBM = 1e12


@pytest.fixture(scope="module")
def tiny_lm():
    cfg = get_config("bert_base_paper").reduced(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256,
        dtype="float32")
    return LM(cfg, device="cpu")


def _batch(S, B=4, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _forced_win(baseline):
    """A fake solve() outcome: a feasible plan with the opposite action
    mask and a strictly better score."""
    actions = tuple(Action.REMAT if a == Action.KEEP else Action.KEEP
                    for a in baseline.actions)
    plan = Plan([], 0.0, 0.0, 0.0, actions=actions,
                microbatch=baseline.microbatch)
    return sol.SolveResult(plan, True, -1.0, -1.0, 0.0, "dp")


def _trainer(lm, planner):
    tr = Trainer(lm, planner, AdamW(lr=1e-3))
    return tr, tr.optimizer.init(tr.params)


def test_swap_rebuilds_only_replaced_buckets(tiny_lm, monkeypatch):
    """After the solver swaps K bucket plans, the next pass over the
    buckets builds exactly K new step functions — the swapped plans' —
    and the pass after that none."""
    planner = MimosePlanner(tiny_lm, HBM, quantum=32, warmup_samples=1,
                            solver="dp", solver_budget_ms=1e4)
    monkeypatch.setattr(sol, "solve",
                        lambda *a, **kw: _forced_win(kw["seed_plans"][0]))
    tr, opt_state = _trainer(tiny_lm, planner)
    sizes = (32, 64)
    for S in sizes:
        opt_state, _ = tr.step(opt_state, _batch(S))
    bs = planner.background_solver
    assert bs.drain(timeout=30.0) and bs.errors == 0
    assert planner.stats["solver_wins"] == len(sizes)
    assert planner.stats["solver_swaps"] == len(sizes)
    assert all(planner.cache[key].source == "dp"
               for key in list(planner.cache.keys()))
    c0 = tr.cache_stats["compiles"]
    for S in sizes:
        opt_state, _ = tr.step(opt_state, _batch(S, seed=1))
    assert tr.cache_stats["compiles"] - c0 == len(sizes)
    c1 = tr.cache_stats["compiles"]
    for S in sizes:
        opt_state, _ = tr.step(opt_state, _batch(S, seed=2))
    assert tr.cache_stats["compiles"] == c1
    # a solved plan is terminal: it is never submitted again
    assert planner.stats["solves"] == len(sizes)


def test_swap_is_atomic_under_the_training_loop(tiny_lm, monkeypatch):
    """A swap landing mid-training never gives a torn plan: every step
    runs the greedy plan or the whole solved one."""
    planner = MimosePlanner(tiny_lm, HBM, quantum=32, warmup_samples=1,
                            solver="dp")

    def slow_win(*a, **kw):
        time.sleep(0.05)
        return _forced_win(kw["seed_plans"][0])

    monkeypatch.setattr(sol, "solve", slow_win)
    tr, opt_state = _trainer(tiny_lm, planner)
    seen = set()
    for i in range(8):
        opt_state, loss = tr.step(opt_state, _batch(32, seed=i))
        assert np.isfinite(loss)
        assert tr.history[-1].remat_units in (0, tiny_lm.num_plan_units())
        key = planner.plan_key(tr._prepare(_batch(32)))
        with planner._cache_lock:
            cached = planner.cache.get(key)
        assert cached is not None
        seen.add(cached.source)
        time.sleep(0.02)
    assert planner.background_solver.drain(timeout=30.0)
    assert planner.background_solver.errors == 0
    assert "dp" in seen


def test_stale_solve_dropped_after_invalidation(tiny_lm, monkeypatch):
    """A solve that started from a cache entry since replaced (as the
    drift-audit refit replaces entries) is dropped, not swapped in."""
    planner = MimosePlanner(tiny_lm, HBM, quantum=32, warmup_samples=1,
                            solver="dp")
    started, release = threading.Event(), threading.Event()

    def blocked_win(*a, **kw):
        started.set()
        release.wait(timeout=30.0)
        return _forced_win(kw["seed_plans"][0])

    monkeypatch.setattr(sol, "solve", blocked_win)
    tr, opt_state = _trainer(tiny_lm, planner)
    opt_state, _ = tr.step(opt_state, _batch(32))
    assert started.wait(timeout=30.0)
    key = planner.plan_key(tr._prepare(_batch(32)))
    with planner._cache_lock:
        replacement = dataclasses.replace(planner.cache[key])
        planner.cache[key] = replacement
    release.set()
    assert planner.background_solver.drain(timeout=30.0)
    assert planner.stats["solver_swaps"] == 0
    with planner._cache_lock:
        assert planner.cache[key] is replacement


def test_background_timeout_counted(tiny_lm):
    """A real solve under an impossible deadline times out, is counted,
    and leaves the greedy plan in place."""
    planner = MimosePlanner(tiny_lm, HBM, quantum=32, warmup_samples=1,
                            solver="dp", solver_budget_ms=1e-6)
    tr, opt_state = _trainer(tiny_lm, planner)
    opt_state, _ = tr.step(opt_state, _batch(32))
    assert planner.background_solver.drain(timeout=30.0)
    assert planner.background_solver.errors == 0
    assert planner.stats["solver_timeouts"] >= 1
    assert planner.stats["solver_swaps"] == 0
    key = planner.plan_key(tr._prepare(_batch(32)))
    assert planner.cache[key].source == "greedy"
    assert tr.summary()["solver_timeouts"] >= 1


def test_close_lets_queued_solves_land_then_ends_the_thread(tiny_lm,
                                                            monkeypatch):
    """``close()`` waits for the queued solves, ends the daemon thread
    (which holds the planner and its model), and a later submission
    starts a new one."""
    planner = MimosePlanner(tiny_lm, HBM, quantum=32, warmup_samples=1,
                            solver="dp")

    def slow_win(*a, **kw):
        time.sleep(0.05)
        return _forced_win(kw["seed_plans"][0])

    monkeypatch.setattr(sol, "solve", slow_win)
    tr, opt_state = _trainer(tiny_lm, planner)
    for S in (32, 64):
        opt_state, _ = tr.step(opt_state, _batch(S))
    bs = planner.background_solver
    thread = bs._thread
    bs.close()
    assert not thread.is_alive() and bs._thread is None
    assert planner.stats["solver_swaps"] == 2 and bs.errors == 0
    bs.close()                                  # idempotent
    opt_state, _ = tr.step(opt_state, _batch(96))
    again = bs._thread
    assert again is not None and again is not thread
    assert bs.drain(timeout=30.0) and planner.stats["solver_swaps"] == 3
    bs.close()
    assert not again.is_alive() and bs._thread is None


def test_solver_off_by_default(tiny_lm):
    planner = MimosePlanner(tiny_lm, HBM, quantum=32, warmup_samples=1)
    assert planner.background_solver is None
    with pytest.raises(ValueError):
        MimosePlanner(tiny_lm, HBM, solver="milp")


def test_real_solve_improves_a_microbatched_plan(tiny_lm):
    """Un-mocked: under a budget where greedy over-splits, the exact
    solve finds a cheaper plan and swaps it in; the next step runs it."""
    from repro_torch.core.collector import ShuttlingCollector
    from repro_torch.core.planner import fixed_train_bytes
    act = ShuttlingCollector(tiny_lm).collect(
        {"tokens": torch.zeros((4, 64), dtype=torch.long)}
    ).activation_vector()
    fixed = fixed_train_bytes(tiny_lm.parameters())
    budget = fixed + 1.6 * float(act.max())
    planner = MimosePlanner(tiny_lm, budget, quantum=32, warmup_samples=1,
                            solver="dp", max_microbatches=4,
                            solver_budget_ms=1e4)
    tr, opt_state = _trainer(tiny_lm, planner)
    opt_state, _ = tr.step(opt_state, _batch(64))
    assert planner.background_solver.drain(timeout=30.0)
    st = planner.stats
    assert st["solves"] == 1 and planner.background_solver.errors == 0
    delta = st["solver_delta_by_bucket"][planner.bucket_key(
        tr._prepare(_batch(64)))]
    assert delta["solved_s"] <= delta["greedy_s"]
    opt_state, loss = tr.step(opt_state, _batch(64, seed=1))
    assert np.isfinite(loss)
    key = planner.plan_key(tr._prepare(_batch(64)))
    plan = planner.cache[key]
    assert tr.history[-1].microbatches == plan.microbatch
    assert tr.history[-1].remat_units == plan.n_remat
