"""Host offload in the port: the hybrid planners against the reference's,
OFFLOAD execution in the model, and the OFFLOAD_OPT split step.

* Planning: the same byte vectors (a stub collector in each package,
  the roofline constants pinned by ``torch_pins``) through both
  packages' ``greedy_plan``, ``solve``, ``MimosePlanner(offload=True,
  opt_offload=True)`` and ``SublinearPlanner(offload=True)`` give equal
  plans, step by step: the same actions (OFFLOAD and OFFLOAD_OPT
  included), k, cache hits and pinned moment vector.  Counterparts of
  ``tests/test_offload_exec.py`` (OFFLOAD_OPT selection and wiring) and
  ``tests/test_hybrid.py`` (the hybrid scheduler).
* Execution: the reference cannot run OFFLOAD on jax 0.9.0
  (``models/lm.py:72``), so an OFFLOAD plan's loss and gradients are
  held against the JAX ``LM`` with ``offload_exec=False`` at
  ``tests/test_torch_model.py``'s tolerances (loss rtol 1e-5; gradients
  rtol 1e-3, atol 1e-5 relative to each leaf's largest entry), and
  against the port's own REMAT execution of the same plan exactly
  (bitwise: the input comes back unchanged and the recompute runs the
  same ops), in unrolled and scan mode.
* The OFFLOAD_OPT split step leaves the parameters bitwise equal to
  the fused step's at k = 1 and k = 2; the port's trainer under an
  OFFLOAD + OFFLOAD_OPT plan against the JAX trainer under the same
  plan run as REMAT + KEEP at ``tests/test_torch_train.py``'s rtol of
  2e-5.

The bitwise comparisons run on one CPU thread (fixture ``one_thread``):
with several, the CPU's embedding backward accumulates in a varying
order, and two runs of the same plan already differ in the last bits.
"""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actions import Action as RefAction
from repro.core import greedy_plan as ref_greedy_plan
from repro.core.baselines import SublinearPlanner as RefSublinear
from repro.core.planner import MimosePlanner as RefMimose
from repro.core.planner import PlanInfo as RefPlanInfo
from repro.core.planner import PlannerBase as RefPlannerBase
from repro.core.scheduler import Plan as RefPlan
from repro.core.solver import solve as ref_solve
from repro.data.pipeline import make_batches as jax_make_batches
from repro.launch.roofline import plan_unit_flops as ref_flops
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch import bridge
from repro_torch.actions import Action
from repro_torch.core.baselines import SublinearPlanner
from repro_torch.core.collector import ShuttlingCollector, unit_moment_bytes
from repro_torch.core.planner import (MimosePlanner, PlanInfo, PlannerBase,
                                      fixed_train_bytes)
from repro_torch.core.scheduler import Plan, greedy_plan
from repro_torch.core.simulator import simulate
from repro_torch.core.solver import solve
from repro_torch.data.pipeline import make_batches
from repro_torch.launch import train as launch_train
from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.models.lm import LM, configure_offload
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW
from repro_torch.train.trainer import Trainer
from torch_pins import pin_reference_constants

PCIE = 16e9
N_UNITS = 6
FIXED = 4e6
SIZES = [64, 96, 128, 64, 160, 96, 192, 128, 224, 160]
B = 8
REDUCED = dict(num_layers=6, d_model=64, d_ff=128, vocab_size=256,
               dtype="float32")
SMALL = dict(num_layers=4, d_model=64, d_ff=128, vocab_size=256,
             dtype="float32")


# ---------------------------------------------------------------------------
# the scheduler and solver on the same vectors
# ---------------------------------------------------------------------------

def _vectors(seed, n=None):
    rng = np.random.default_rng(seed)
    n = n or int(rng.integers(3, 12))
    act = rng.uniform(1e5, 1e7, n)
    return dict(est_mem=act, output_bytes=act * rng.uniform(0.01, 0.3, n),
                offload_bytes=act * rng.uniform(0.5, 1.0, n),
                flops=rng.uniform(1e8, 1e12, n),
                opt_bytes=rng.uniform(1e5, 3e7, n))


def _acts(p):
    return tuple(int(a) for a in p.actions)


def _both(fn_ref, fn_port):
    a, b = fn_ref(), fn_port()
    assert _acts(a) == _acts(b)
    assert (a.n_remat, a.n_offload, a.n_opt) == (b.n_remat, b.n_offload,
                                                  b.n_opt)
    return b


@pytest.mark.parametrize("seed", range(6))
def test_greedy_hybrid_plan_matches_reference(monkeypatch, seed):
    """tests/test_hybrid.py's hybrid selection: the same vectors give
    the same (unit, action) plan in both packages, with and without
    moment vectors, across budgets from infeasible to ample."""
    pin_reference_constants(monkeypatch)
    v = _vectors(seed)
    fixed = float(np.random.default_rng(seed).uniform(0, 1e7))
    kinds = set()
    for frac, opt in itertools.product((0.0, 0.2, 0.5, 0.9, 1.5),
                                       (False, True)):
        budget = fixed + frac * v["est_mem"].sum() + v["est_mem"].max()
        kw = dict(flops=v["flops"], output_bytes=v["output_bytes"],
                  offload_bytes=v["offload_bytes"], pcie_bytes_per_s=PCIE,
                  offload_overlap=0.5)
        if opt:
            kw["opt_bytes"] = v["opt_bytes"]
        p = _both(lambda: ref_greedy_plan(v["est_mem"], budget, fixed, **kw),
                  lambda: greedy_plan(v["est_mem"], budget, fixed, **kw))
        kinds.update(int(a) for a in p.actions)
    assert int(Action.OFFLOAD) in kinds


def test_greedy_parks_moments_when_remat_alone_cannot_fit(monkeypatch):
    """tests/test_offload_exec.py: the fixed bytes alone exceed the
    budget, so only parking moments fits — in both packages alike."""
    pin_reference_constants(monkeypatch)
    kw = dict(flops=[1e9] * 4, output_bytes=[1.0] * 4,
              offload_bytes=[9.0] * 4, opt_bytes=[30.0] * 4,
              pcie_bytes_per_s=PCIE, offload_overlap=0.5)
    p = _both(lambda: ref_greedy_plan([10.0] * 4, 95.0, 100.0, **kw),
              lambda: greedy_plan([10.0] * 4, 95.0, 100.0, **kw))
    assert p.n_opt >= 1
    sim = simulate([10.0] * 4, p.actions, 100.0, [1.0] * 4, [1e9] * 4,
                   offload_bytes=[9.0] * 4, opt_bytes=[30.0] * 4,
                   pcie_bytes_per_s=PCIE, overlap=0.5)
    assert sim.fits(95.0)


def test_greedy_opt_bytes_is_a_pure_extension_under_slack(monkeypatch):
    pin_reference_constants(monkeypatch)
    kw = dict(flops=[1e9] * 4, output_bytes=[1.0] * 4,
              offload_bytes=[9.0] * 4, pcie_bytes_per_s=PCIE)
    base = greedy_plan([10.0] * 4, 500.0, 50.0, **kw)
    w = _both(lambda: ref_greedy_plan([10.0] * 4, 500.0, 50.0,
                                      opt_bytes=[5.0] * 4, **kw),
              lambda: greedy_plan([10.0] * 4, 500.0, 50.0,
                                  opt_bytes=[5.0] * 4, **kw))
    assert w.n_opt == 0 and w.as_actions() == base.as_actions()


def test_solver_exhaustive_finds_offload_opt_when_required(monkeypatch):
    pin_reference_constants(monkeypatch)
    vec = dict(est_mem=[10.0, 10.0, 10.0], flops=[1e9] * 3,
               output_bytes=[1.0] * 3, offload_bytes=[9.0] * 3,
               opt_bytes=[60.0, 0.0, 0.0])
    kw = dict(budget_bytes=95.0, fixed_bytes=100.0, method="exhaustive",
              pcie_bytes_per_s=PCIE)
    ref = ref_solve(lambda k: vec, **kw)
    ours = solve(lambda k: vec, **kw)
    assert ours.feasible == ref.feasible is True
    assert _acts(ours.plan) == _acts(ref.plan)
    assert ours.plan.actions[0] is Action.OFFLOAD_OPT
    assert ours.score == ref.score


def test_hybrid_fits_a_budget_no_bool_plan_fits(monkeypatch):
    """tests/test_hybrid.py: on the port's collected vectors, a budget
    no remat mask fits that OFFLOAD still fits."""
    pin_reference_constants(monkeypatch)
    lm = LM(get_config("bert_base_paper").reduced(**SMALL), device="cpu")
    res = ShuttlingCollector(lm).collect(
        {"tokens": torch.ones((2, 64), dtype=torch.long)})
    act, out = res.activation_vector(), res.output_vector()
    off, fl = res.offloadable_vector(), res.flops_vector()
    fixed = fixed_train_bytes(lm.parameters())
    floor = min(simulate(act, m, fixed, out, fl).peak_bytes
                for m in itertools.product([False, True], repeat=len(act)))
    all_off = simulate(act, [Action.OFFLOAD] * len(act), fixed, out, fl,
                       offload_bytes=off, pcie_bytes_per_s=PCIE)
    assert all_off.peak_bytes < floor
    budget = 0.5 * (all_off.peak_bytes + floor)
    kw = dict(flops=fl, output_bytes=out, offload_bytes=off,
              pcie_bytes_per_s=PCIE)
    p = _both(lambda: ref_greedy_plan(act, budget, fixed, **kw),
              lambda: greedy_plan(act, budget, fixed, **kw))
    assert p.n_offload > 0
    assert simulate(act, p.actions, fixed, out, fl, offload_bytes=off,
                    pcie_bytes_per_s=PCIE).fits(budget)


def test_hybrid_floor_property_randomized(monkeypatch):
    """tests/test_hybrid.py: at equal budget the hybrid plan is never
    worse than the remat-only plan, and both packages pick the same."""
    pin_reference_constants(monkeypatch)
    rng = np.random.default_rng(7)
    feasible = 0
    for _ in range(40):
        n = int(rng.integers(2, 16))
        act = rng.uniform(1e5, 1e7, n)
        out = act * rng.uniform(0.01, 0.3, n)
        fl = rng.uniform(1e8, 1e12, n)
        off = act * rng.uniform(0.5, 1.0, n)
        fixed = float(rng.uniform(0, 1e7))
        budget = (fixed + float(rng.uniform(0.3, 1.2)) * act.sum()
                  + 2 * act.max() + out.max())
        kw = dict(flops=fl, output_bytes=out, offload_bytes=off,
                  pcie_bytes_per_s=PCIE)
        hyb = _both(lambda: ref_greedy_plan(act, budget, fixed, **kw),
                    lambda: greedy_plan(act, budget, fixed, **kw))
        ro = greedy_plan(act, budget, fixed, flops=fl)
        sim_h = simulate(act, hyb.actions, fixed, out, fl,
                         offload_bytes=off, pcie_bytes_per_s=PCIE)
        sim_r = simulate(act, ro.remat, fixed, out, fl, offload_bytes=off,
                         pcie_bytes_per_s=PCIE)
        if sim_r.fits(budget):
            feasible += 1
            assert sim_h.fits(budget)
            assert sim_h.step_overhead_s <= sim_r.step_overhead_s + 1e-12
    assert feasible >= 5


# ---------------------------------------------------------------------------
# the planners on the same vectors
# ---------------------------------------------------------------------------

class StubResult:
    """A collection from seeded per-unit coefficients, the same in both
    packages; moment bytes are input-size independent."""

    def __init__(self, coef, batch, flops_fn, lm):
        b, s = (int(x) for x in batch["tokens"].shape)
        self.input_size = b * s
        self.collect_time_s = 0.0
        lin, quad, out, opt = coef
        self._act = b * s * lin + b * s * s * quad
        self._out = np.full(N_UNITS, b * s * out)
        self._opt = opt
        self._flops = flops_fn(lm, batch)

    def activation_vector(self):
        return self._act.copy()

    def flops_vector(self):
        return self._flops.copy()

    def output_vector(self):
        return self._out.copy()

    def offloadable_vector(self):
        # units 1, 3, 5 hold no matrix-shaped residual: parking their
        # moments is their only host action
        return 0.8 * self._act * (np.arange(N_UNITS) % 2 == 0)

    def opt_vector(self):
        return self._opt.copy()


class StubCollector:
    def __init__(self, lm, flops_fn, seed=0):
        rng = np.random.default_rng(seed)
        self.coef = (rng.uniform(2e3, 4e3, N_UNITS),
                     rng.uniform(2.0, 12.0, N_UNITS), 256.0,
                     rng.uniform(2e5, 3e6, N_UNITS))
        self.lm, self.flops_fn = lm, flops_fn
        self.calls = 0

    def collect(self, *args):
        self.calls += 1
        return StubResult(self.coef, args[-1], self.flops_fn, self.lm)


@pytest.fixture(scope="module")
def lms():
    jlm = build_model(jax_get_config("bert_base_paper").reduced(**REDUCED))
    lm = LM(get_config("bert_base_paper").reduced(**REDUCED), device="cpu")
    return jlm, lm


def _batches(S):
    tokens = np.ones((B, S), np.int32)
    return ({"tokens": tokens, "labels": tokens},
            {"tokens": torch.ones((B, S), dtype=torch.long),
             "labels": torch.ones((B, S), dtype=torch.long)})


def _budget(lm, frac):
    act = StubCollector(lm, plan_unit_flops).collect(
        _batches(max(SIZES))[1]).activation_vector()
    return FIXED + frac * float(act.sum())


def _run(ref, ours):
    plans = []
    for S in SIZES:
        jb, tb = _batches(S)
        ra, ri = ref.plan(None, jb)
        a, i = ours.plan(tb)
        assert tuple(int(x) for x in ra) == tuple(int(x) for x in a)
        assert ri.plan.microbatch == i.plan.microbatch
        assert (ri.cache_hit, ri.collected) == (i.cache_hit, i.collected)
        plans.append(i.plan)
    return plans


@pytest.mark.parametrize("max_mb", [1, 4])
@pytest.mark.parametrize("opt", [False, True])
def test_mimose_hybrid_plans_match_reference(lms, monkeypatch, opt,
                                             max_mb):
    """MimosePlanner(offload=True[, opt_offload=True]) step by step
    against the reference's over a budget sweep and two link rates
    (the measured-like one, and one fast enough that host actions beat
    the reduced model's cheap recompute); the pinned moment vector is
    equal, and the sweep reaches OFFLOAD (and OFFLOAD_OPT)."""
    pin_reference_constants(monkeypatch)
    jlm, lm = lms
    seen = set()
    for frac, gbps in itertools.product((-0.3, 0.0, 0.05, 0.2, 0.5, 2.0),
                                        (16.0, 1e5)):
        budget = _budget(lm, frac)
        ref = RefMimose(jlm, budget, fixed_bytes=FIXED, quantum=32,
                        warmup_samples=3, offload=True, opt_offload=opt,
                        pcie_gbps=gbps, max_microbatches=max_mb)
        ours = MimosePlanner(lm, budget, quantum=32, warmup_samples=3,
                             offload=True, opt_offload=opt, pcie_gbps=gbps,
                             max_microbatches=max_mb)
        ours.fixed_bytes = FIXED
        ref.collector = StubCollector(jlm, ref_flops)
        ours.collector = StubCollector(lm, plan_unit_flops)
        for p in _run(ref, ours):
            seen.update(int(a) for a in p.actions)
        np.testing.assert_array_equal(ref._opt_vector, ours._opt_vector)
        assert ref.stats["collections"] == ours.stats["collections"]
    assert int(Action.OFFLOAD) in seen
    if opt:
        assert int(Action.OFFLOAD_OPT) in seen


@pytest.mark.parametrize("gbps", [16.0, 1e5])
@pytest.mark.parametrize("frac", [0.0, 0.2, 0.4])
def test_sublinear_hybrid_plan_matches_reference(lms, monkeypatch, frac,
                                                 gbps):
    pin_reference_constants(monkeypatch)
    jlm, lm = lms
    budget = _budget(lm, frac)
    kw = dict(max_input_size=B * max(SIZES), fixed_bytes=FIXED,
              warmup_samples=3, offload=True, pcie_gbps=gbps)
    ref = RefSublinear(jlm, budget, **kw)
    ours = SublinearPlanner(lm, budget, **kw)
    ref.collector = StubCollector(jlm, ref_flops)
    ours.collector = StubCollector(lm, plan_unit_flops)
    plans = _run(ref, ours)
    assert all(p is plans[0] for p in plans)
    if frac > 0.0:
        assert plans[0].n_offload > 0


def test_offload_knobs_are_checked(lms):
    lm = lms[1]
    with pytest.raises(ValueError, match="cost_aware"):
        MimosePlanner(lm, 1e9, offload=True, cost_aware=False)
    with pytest.raises(ValueError, match="cost_aware"):
        SublinearPlanner(lm, 1e9, max_input_size=128, offload=True,
                         cost_aware=False)
    with pytest.raises(ValueError, match="needs offload=True"):
        MimosePlanner(lm, 1e9, opt_offload=True)


def test_planner_pins_opt_vector_once(lms, monkeypatch):
    lm = lms[1]
    pl = MimosePlanner(lm, 1e12, quantum=64, warmup_samples=1,
                       offload=True, opt_offload=True)
    pl.plan(_batches(64)[1])
    v = pl._opt_vector
    want = [unit_moment_bytes(u.params) for u in lm.plan_units(
        _batches(64)[1])]
    np.testing.assert_array_equal(v, want)
    assert want[0] == 8 * sum(p.numel() for p in lm.blocks[0].parameters())
    np.testing.assert_array_equal(pl._opt_bytes_planning(), v)
    assert "opt_bytes" in pl._hybrid_kwargs(64 * B)
    pl.plan(_batches(128)[1])
    assert pl._opt_vector is v
    # scan-mode moments: the action is not offered
    monkeypatch.setattr(pl, "lm", types.SimpleNamespace(
        cfg=types.SimpleNamespace(remat_mode="scan")))
    assert pl._opt_bytes_planning() is None


def test_pcie_none_reads_the_link_constant_when_planning(lms, monkeypatch):
    from repro_torch.core import planner as planner_mod
    lm = lms[1]
    pl = MimosePlanner(lm, 1e12, offload=True)
    monkeypatch.setattr(planner_mod, "PCIE_BW", 3e9)
    assert pl._hybrid_kwargs(0, ShuttlingCollector(lm).collect(
        _batches(64)[1]))["pcie_bytes_per_s"] == 3e9
    assert MimosePlanner(lm, 1e12, offload=True,
                         pcie_gbps=7.0).link_bytes_per_s() == 7e9


# ---------------------------------------------------------------------------
# OFFLOAD execution in the model
# ---------------------------------------------------------------------------

def _ragged(S=48, B=2, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(S // 2, S + 1, B)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    weights = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    tokens = tokens * weights.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels, "weights": weights,
            "lengths": lens.astype(np.int32)}


def _to_torch(batch):
    dt = {"tokens": torch.long, "labels": torch.long, "lengths": torch.int32}
    return {k: torch.as_tensor(np.asarray(v), dtype=dt.get(k, torch.float32))
            for k, v in batch.items()}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PLANS = {"unrolled": (Action.OFFLOAD, Action.KEEP, Action.REMAT,
                      Action.OFFLOAD),
         "scan": (Action.OFFLOAD, Action.REMAT)}


def _cfgs(mode):
    if mode == "scan":
        kw = dict(num_layers=4, d_model=64, d_ff=0, vocab_size=256,
                  dtype="float32", remat_mode="scan", scan_chunks=2)
        return (jax_get_config("mamba2_1p3b").reduced(**kw),
                get_config("mamba2_1p3b").reduced(**kw))
    return (jax_get_config("bert_base_paper").reduced(**SMALL),
            get_config("bert_base_paper").reduced(**SMALL))


def _loss_and_grads(lm, batch, actions):
    loss, _ = lm.loss(batch, actions)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in lm.named_parameters()}
    for p in lm.parameters():
        p.grad = None
    return loss.detach(), grads


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_offload_execution_equals_remat_exactly(mode, impl, one_thread):
    """OFFLOAD changes where the input checkpoint waits, never a value:
    loss and every gradient bitwise equal to the same plan run as
    REMAT; the lane moved each OFFLOAD layer's input out and back."""
    _, tcfg = _cfgs(mode)
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    batch = _to_torch(_ragged())
    acts = PLANS[mode]
    got = _loss_and_grads(lm, batch, acts)
    lane = lm.transfer_lane
    st = lane.reset_stats()
    n_layers = sum(e - s for a, (s, e) in zip(acts, lm.unit_bounds())
                   if a is Action.OFFLOAD)
    unit_in = 2 * 48 * tcfg.d_model * 4
    assert st["bytes_out"] == st["bytes_in"] == n_layers * unit_in
    assert st["transfers"] == 2 * n_layers
    lm.offload_exec = False
    want = _loss_and_grads(lm, batch, acts)
    assert lane.reset_stats()["bytes_out"] == 0
    assert torch.equal(got[0], want[0])
    for n in want[1]:
        assert torch.equal(got[1][n], want[1][n]), n


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_offload_loss_and_grads_match_reference(mode, impl):
    """The port's OFFLOAD plan against the JAX LM's with
    ``offload_exec=False`` (OFFLOAD as remat), at the reference
    tolerances."""
    jcfg, tcfg = _cfgs(mode)
    jlm = build_model(jcfg, attn_impl="xla")
    jlm.offload_exec = False
    params = jlm.init(jax.random.PRNGKey(0))
    raw = _ragged()
    acts = PLANS[mode]
    ref_acts = tuple(RefAction(int(a)) for a in acts)

    def loss_fn(p):
        return jlm.loss(p, {k: jnp.asarray(v) for k, v in raw.items()},
                        remat_mask=ref_acts)[0]
    want_loss, want = jax.value_and_grad(loss_fn)(params)
    want = bridge.state_dict_from_tree(want)
    lm = LM(tcfg, attn_impl=impl, device="cpu")
    bridge.load_tree(lm, params)
    loss, grads = _loss_and_grads(lm, _to_torch(raw), acts)
    assert lm.transfer_lane.reset_stats()["bytes_out"] > 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for n, g in grads.items():
        w = want[n].float().numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.float().numpy() / scale, w / scale,
                                   rtol=1e-3, atol=1e-5, err_msg=n)


def test_offload_without_grad_runs_plainly():
    _, tcfg = _cfgs("unrolled")
    lm = LM(tcfg, device="cpu")
    batch = _to_torch(_ragged())
    with torch.no_grad():
        a, _ = lm.loss(batch, PLANS["unrolled"])
        b, _ = lm.loss(batch)
    assert torch.equal(a, b)
    assert lm.transfer_lane is None        # nothing was moved
    assert configure_offload(lm) is False and lm.offload_exec


# ---------------------------------------------------------------------------
# the trainer: OFFLOAD_OPT split step, offload stats
# ---------------------------------------------------------------------------

class FixedPlanner(PlannerBase):
    """Serves one action plan for every batch."""

    def __init__(self, lm, actions, quantum=32):
        self.lm = lm
        self.quantum = quantum
        self.actions = tuple(Action(int(a)) for a in actions)

    def plan(self, batch):
        p = Plan([], 0.0, 0.0, 0.0, actions=self.actions)
        return p.as_actions(), PlanInfo(0, self.bucket_key(batch), True,
                                        False, p)


def _params_after(lm0, actions, k, steps=3):
    lm = LM(lm0.cfg, device="cpu")
    lm.load_state_dict(lm0.state_dict())
    planner = FixedPlanner(lm, actions)
    if k > 1:
        planner.plan = _with_k(planner.plan, k)
    tr = Trainer(lm, planner, AdamW(lr=1e-3))
    opt_state = tr.run(make_batches("swag", batch_size=4, vocab_size=256,
                                    num_batches=steps, quantum=32, seed=0))
    return tr, opt_state, {n: p.detach().clone()
                           for n, p in lm.named_parameters()}


def _with_k(plan_fn, k):
    def plan(batch):
        a, info = plan_fn(batch)
        info.plan.microbatch = k
        return a, info
    return plan


@pytest.mark.parametrize("k", [1, 2])
def test_opt_offload_split_step_equals_fused_step(k, one_thread):
    """Three steps with units 0 and 2's moments parked on the host
    between steps, against the same plan with those units KEEP (the
    fused step): parameters and moments bitwise equal."""
    _, tcfg = _cfgs("unrolled")
    lm0 = LM(tcfg, device="cpu")
    split = (Action.OFFLOAD_OPT, Action.OFFLOAD, Action.OFFLOAD_OPT,
             Action.REMAT)
    fused = tuple(Action.KEEP if a is Action.OFFLOAD_OPT else a
                  for a in split)
    tr, st_s, p_split = _params_after(lm0, split, k)
    _, st_f, p_fused = _params_after(lm0, fused, k)
    for n in p_fused:
        assert torch.equal(p_split[n], p_fused[n]), n
    assert tr._parked == {0, 2}
    parked = [n for u in (0, 2) for n in tr._unit_names[u]]
    assert parked and all(n.startswith(("blocks.0.", "blocks.2."))
                          for n in parked)
    for n in st_f.m:
        assert torch.equal(st_s.m[n], st_f.m[n]), n
        assert torch.equal(st_s.v[n], st_f.v[n]), n
    s = tr.summary()
    assert s["mean_opt_offload_units"] == 2 and s["mean_offload_units"] == 1
    assert s["offload_degraded_steps"] == 0
    assert all(h.sim_transfer_s > 0 for h in tr.history)
    assert all(h.microbatches == k for h in tr.history)


def test_offload_plan_losses_match_the_reference_trainer():
    """The port's trainer under an OFFLOAD + OFFLOAD_OPT plan against
    the JAX trainer under the same plan with OFFLOAD run as remat and
    OFFLOAD_OPT as KEEP, four seeded steps, rtol 2e-5."""
    jcfg, tcfg = _cfgs("unrolled")
    jlm = build_model(jcfg)
    jlm.offload_exec = False
    params = jlm.init(jax.random.PRNGKey(0))
    acts = (Action.OFFLOAD, Action.OFFLOAD_OPT, Action.KEEP, Action.OFFLOAD)
    ref_acts = tuple(RefAction(int(a) if a is not Action.OFFLOAD_OPT
                               else 0) for a in acts)

    class RefFixed(RefPlannerBase):
        quantum = 32
        stats = {}

        def plan(self, p, batch):
            plan = RefPlan([], 0.0, 0.0, 0.0, actions=ref_acts)
            return plan.as_actions(), RefPlanInfo(0, 0, True, False, plan)

    jtr = JaxTrainer(jlm, RefFixed(), JaxAdamW(lr=1e-3))
    jp = jax.tree_util.tree_map(jnp.copy, params)
    jstate = jtr.optimizer.init(jp)
    want = []
    for b in jax_make_batches("swag", batch_size=4, vocab_size=256,
                              num_batches=4, quantum=32, seed=0):
        jp, jstate, loss = jtr.step(jp, jstate, b)
        want.append(loss)
    lm = LM(tcfg, device="cpu")
    bridge.load_tree(lm, params)
    tr = Trainer(lm, FixedPlanner(lm, acts), AdamW(lr=1e-3))
    tr.run(make_batches("swag", batch_size=4, vocab_size=256,
                        num_batches=4, quantum=32, seed=0))
    np.testing.assert_allclose([s.loss for s in tr.history], want,
                               rtol=2e-5)
    assert all(s.offload_units == 2 and s.opt_offload_units == 1
               for s in tr.history)


def test_offload_degraded_is_counted_when_execution_is_off():
    """OFFLOAD steps run as REMAT (``offload_exec`` off) are counted,
    every step, in the stats and the registry."""
    _, tcfg = _cfgs("unrolled")
    lm = LM(tcfg, device="cpu")
    tr = Trainer(lm, FixedPlanner(lm, PLANS["unrolled"]), AdamW(lr=1e-3))
    tr.run(make_batches("swag", batch_size=2, vocab_size=256,
                        num_batches=1, quantum=32, seed=0))
    assert tr.summary()["offload_degraded_steps"] == 0
    lm.offload_exec = False
    tr.run(make_batches("swag", batch_size=2, vocab_size=256,
                        num_batches=2, quantum=32, seed=1))
    assert tr.summary()["offload_degraded_steps"] == 2
    assert [s.offload_degraded for s in tr.history] == [False, True, True]
    assert tr.telemetry.metrics.get(
        "train_offload_degraded_steps").total() == 2


def test_prewarm_makes_the_first_batch_a_plan_cache_hit():
    _, tcfg = _cfgs("unrolled")
    lm = LM(tcfg, device="cpu")
    planner = MimosePlanner(lm, 1e12, quantum=32, warmup_samples=2,
                            offload=True)
    tr = Trainer(lm, planner, AdamW(lr=1e-3))
    batches = list(make_batches("swag", batch_size=2, vocab_size=256,
                                num_batches=3, quantum=32, seed=0))
    Ss = sorted({b["tokens"].shape[1] for b in batches})
    assert tr.prewarm(Ss, 2) == len(Ss)
    assert tr.prewarm(Ss, 2) == 0            # already built
    tr.run(batches)
    assert all(s.cache_hit and not s.compile for s in tr.history)
    assert tr.summary()["prewarm_compiles"] == len(Ss)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--offload"], ["--offload", "--opt-offload"],
    ["--offload", "--planner", "sublinear"],
    ["--offload", "--max-microbatches", "2", "--prewarm", "2"],
])
def test_launcher_runs_offload_on_cpu(extra, capsys):
    tr = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                            "--budget-mb", "26", "--batch-size", "4"]
                           + extra)
    assert len(tr.history) == 3
    assert all(np.isfinite(s.loss) for s in tr.history)
    out = capsys.readouterr().out
    assert "engine report" in out and " offload=" in out
    if "--max-microbatches" not in extra:
        assert any(s.offload_units for s in tr.history)
        assert "offload: exposed transfer" in out


@pytest.mark.parametrize("bad", [
    ["--opt-offload"],
    ["--offload", "--byte-only-remat"],
    ["--offload", "--opt-offload", "--planner", "sublinear"],
])
def test_launcher_rejects_inconsistent_offload_arguments(bad):
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--reduced", "--steps", "1"]
                          + bad)
