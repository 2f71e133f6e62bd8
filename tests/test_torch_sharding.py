"""Sharding-aware planning in the port against the reference's: the
sharding specs, ``MeshBudget`` and its divisors, the per-device fixed
and moment bytes, the mesh-aware collector, ``simulate_sharded`` and
``greedy_plan_sharded``, the planners' ``mesh_budget=``, the trainer's
key, ``launch/mesh.py`` on a ``DeviceMesh`` and the launcher's
``--mesh-shape / --hbm-gb / --zero1``.

CPU, reduced widths.  ``MeshBudget`` is axis-size arithmetic, so a (4, 2)
budget is planned here on one device; the one mesh built is a (1, 1)
``gloo`` mesh over a one-rank process group (module fixture ``group``).
Specs, divisors and byte counts are held to the reference exactly (the
fixed and moment bytes to rel 1e-12: the two packages sum their leaves
in other orders).  The port's meta collector saves other tensors than
the reference's ``jax.vjp`` closure, so the collected vectors are held
to the divisor algebra, and the planners to the reference on the same
per-device vectors, fed through a stub collector as in
``tests/test_torch_baselines.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.baselines import DTRSimPlanner as RefDTR
from repro.core.baselines import SublinearPlanner as RefSublinear
from repro.core.planner import MimosePlanner as RefMimose
from repro.core.scheduler import greedy_plan_sharded as ref_greedy_sharded
from repro.core.simulator import simulate_sharded as ref_simulate_sharded
from repro.launch.roofline import plan_unit_flops as ref_flops
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro.sharding import budget as RB
from repro.sharding import specs as RSP
from repro_torch.core.baselines import DTRSimPlanner, SublinearPlanner
from repro_torch.core.collector import (ShuttlingCollector, _meta_tree,
                                        _saved_storages,
                                        unit_residual_bytes)
from repro_torch.core.planner import MimosePlanner, fixed_train_bytes
from repro_torch.core.scheduler import greedy_plan_sharded
from repro_torch.core.simulator import simulate_sharded
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train
from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.models.lm import LM, PlanUnit
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import specs as SP
from repro_torch.sharding.budget import (MeshBudget,
                                         fixed_train_bytes_per_device,
                                         unit_moment_bytes)
from repro_torch.train.trainer import Trainer
from test_torch_baselines import N_UNITS, SIZES, StubCollector, StubResult
from test_torch_baselines import REDUCED as STUB_REDUCED
from torch_pins import pin_reference_constants

HBM = 1e9
MESHES = [(1,), (4,), (2, 2), (4, 2)]


class FakeMesh:
    """What the reference's spec rules read of a mesh."""

    def __init__(self, axes: dict):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _ref_key(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                    for p in path)


# the reduced configurations: (reference, port) with the same cuts; the
# ssm and hybrid families also in scan mode (4 layers in 2 chunks)
MODELS = {
    "qwen3": ("qwen3_1p7b", {}),
    "granite": ("granite_moe_1b_a400m", {}),
    "mamba2_scan": ("mamba2_1p3b", dict(num_layers=4, remat_mode="scan",
                                        scan_chunks=2)),
    "hymba_scan": ("hymba_1p5b", dict(num_layers=4, remat_mode="scan",
                                      scan_chunks=2)),
    "hymba": ("hymba_1p5b", {}),
    "seamless": ("seamless_m4t_large_v2", {}),
    "qwen2vl": ("qwen2_vl_7b", {}),
}
_MODEL_CACHE = {}


def _models(name):
    """(reference LM, reference parameter shapes, port LM on meta)."""
    if name not in _MODEL_CACHE:
        arch, over = MODELS[name]
        jlm = build_model(jax_get_config(arch).reduced(**over))
        struct = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
        lm = LM(get_config(arch).reduced(**over), device="meta")
        _MODEL_CACHE[name] = (jlm, struct, lm)
    return _MODEL_CACHE[name]


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's bitwise comparisons need a fixed
    summation order (as tests/test_torch_offload.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo process group for the module, destroyed after."""
    own = M.ensure_process_group("cpu")
    yield
    if own:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_dim", [2, 4, 16])
@pytest.mark.parametrize("name", ["qwen3", "granite", "mamba2_scan",
                                  "hymba_scan", "seamless", "qwen2vl"])
def test_param_spec_matches_reference_for_every_leaf(name, model_dim):
    """Every leaf of the reference's tree (scan mode: the stacked
    leaves, regrouped from the port's per-layer tensors) gets the
    reference's spec, with the policies off and on."""
    jlm, struct, lm = _models(name)
    scanned = lm.cfg.remat_mode == "scan"
    ref = {_ref_key(p): leaf for p, leaf in
           jax.tree_util.tree_flatten_with_path(struct)[0]}
    ours = {key: shape for key, shape, _, _ in
            SP.reference_leaves(lm, scanned=scanned)}
    assert set(ours) == set(ref)
    for key, leaf in jax.tree_util.tree_flatten_with_path(struct)[0]:
        k = _ref_key(key)
        assert ours[k] == tuple(leaf.shape), k
        for attn_rep in (False, True):
            for e2d in (False, True):
                want = RSP.param_spec(key, leaf, scanned=scanned, mesh=None,
                                      model_dim=model_dim,
                                      attn_replicated=attn_rep,
                                      expert_2d=e2d, data_dim=4)
                got = SP.param_spec(k, ours[k], scanned=scanned,
                                    model_dim=model_dim,
                                    attn_replicated=attn_rep,
                                    expert_2d=e2d, data_dim=4)
                assert got == tuple(want), (k, attn_rep, e2d)


def test_column_row_rules():
    """The reference's full-size cases (tests/test_sharding.py)."""
    assert SP.param_spec("blocks.attn.wq", (8, 2048, 2048), scanned=True,
                         model_dim=16) == (None, None, "model")
    assert SP.param_spec("blocks.attn.wo", (8, 2048, 2048), scanned=True,
                         model_dim=16) == (None, "model", None)
    # expert weights: expert-parallel on the leading E axis
    assert SP.param_spec("blocks.moe.wi", (32, 1024, 512), scanned=False,
                         model_dim=16) == ("model", None, None)
    # non-divisible dims stay replicated
    assert SP.param_spec("embed", (50277, 512), scanned=False,
                         model_dim=16) == (None, None)


# ---------------------------------------------------------------------------
# fixed and moment bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["qwen3", "granite", "mamba2_scan",
                                  "hymba_scan"])
def test_fixed_and_moment_bytes_match_reference(name, shape, zero1):
    jlm, struct, lm = _models(name)
    scanned = lm.cfg.remat_mode == "scan"
    rb = RB.MeshBudget.from_shape(shape, HBM, zero1=zero1)
    pb = MeshBudget.from_shape(shape, HBM, zero1=zero1)
    assert pb.sig() == rb.sig()
    want = RB.fixed_train_bytes_per_device(struct, rb, scanned=scanned)
    got = fixed_train_bytes_per_device(lm, pb, scanned=scanned)
    assert got == pytest.approx(want, rel=1e-12)
    batch = {"tokens": jnp.ones((4, 64), jnp.int32)}
    ref_units = jlm.plan_units(struct, batch)
    units = lm.plan_units({"tokens": torch.ones((4, 64), dtype=torch.long)})
    assert [u.name for u in units] == [u.name for u in ref_units]
    for ru, u in zip(ref_units, units):
        sc = u.name.startswith("chunk")
        want = RB.unit_moment_bytes(ru.params, rb, scanned=sc)
        got = unit_moment_bytes(u.params, pb, scanned=sc)
        assert got == pytest.approx(want, rel=1e-12), u.name
        assert unit_moment_bytes(u.params, scanned=sc) == \
            RB.unit_moment_bytes(ru.params, None, scanned=sc)


def test_zero1_reads_stacked_leaves_in_scan_mode():
    """Why scan-mode leaves are regrouped: ZeRO-1 shards a stacked
    leaf's layer axis where a per-layer 0-d scale has no axis to shard
    (hymba's attn_scale / ssm_scale), so a per-layer sum differs from
    the reference's and the stacked one does not."""
    jlm, struct, lm = _models("hymba_scan")
    rb = RB.MeshBudget.from_shape((4,), HBM, zero1=True)
    pb = MeshBudget.from_shape((4,), HBM, zero1=True)
    want = RB.fixed_train_bytes_per_device(struct, rb, scanned=True)
    assert fixed_train_bytes_per_device(lm, pb, scanned=True) == \
        pytest.approx(want, rel=1e-12)
    per_layer = fixed_train_bytes_per_device(lm, pb, scanned=False)
    assert per_layer > want * (1 + 1e-9)


def test_one_device_fixed_bytes_are_the_global_ones():
    _, _, lm = _models("qwen3")
    assert fixed_train_bytes_per_device(
        lm, MeshBudget.from_shape((1,), HBM)) == \
        fixed_train_bytes(lm.parameters())


def test_policy_flags_change_bytes_and_signature():
    _, struct, lm = _models("qwen3")
    tp = MeshBudget.from_shape((4, 2), HBM)
    rep = MeshBudget.from_shape((4, 2), HBM, attn_replicated=True)
    assert (fixed_train_bytes_per_device(lm, rep)
            > fixed_train_bytes_per_device(lm, tp))
    assert rep.sig() != tp.sig()
    z1 = MeshBudget.from_shape((4, 2), HBM, zero1=True)
    plain = fixed_train_bytes_per_device(lm, tp)
    assert plain * 0.5 <= fixed_train_bytes_per_device(lm, z1) < plain


# ---------------------------------------------------------------------------
# divisors and specs on shapes
# ---------------------------------------------------------------------------

@st.composite
def _cases(draw):
    shape = draw(st.sampled_from(MESHES + [(3,), (2, 4, 2), (1, 8)]))
    seq_parallel = draw(st.sampled_from([False, True]))
    dims = st.sampled_from([1, 2, 3, 4, 6, 8, 16, 24, 64])
    shapes = [tuple(draw(st.lists(dims, min_size=0, max_size=5)))
              for _ in range(24)]
    return shape, seq_parallel, shapes, draw(dims), draw(dims)


@settings(max_examples=15, deadline=None)
@given(_cases())
def test_divisors_and_specs_match_reference(case):
    shape, seq_parallel, shapes, B, d = case
    rb = RB.MeshBudget.from_shape(shape, HBM, seq_parallel=seq_parallel)
    pb = MeshBudget.from_shape(shape, HBM, seq_parallel=seq_parallel)
    assert (pb.n_devices, pb.data_ways, pb.model_ways) == \
        (rb.n_devices, rb.data_ways, rb.model_ways)
    axes = dict(pb.axis_sizes)
    fake = FakeMesh(axes)
    for s in shapes:
        s = (B,) + s if s and s[0] % 2 else s
        assert pb.activation_divisor(s, batch=B, d_model=d) == \
            rb.activation_divisor(s, batch=B, d_model=d), s
        for name in ("lengths", "tokens", "labels", "positions",
                     "frames", "vision_embeds", "other"):
            if name in ("frames", "vision_embeds") and len(s) != 3:
                continue
            for seq in (False, True):
                assert SP.batch_spec(name, s, pb, seq) == \
                    tuple(RSP.batch_spec(name, s, fake, seq)), (name, s)
        if "model" not in axes:
            continue
        for name, rank in (("k", 4), ("v", 4), ("ck", 4), ("ssm", 4),
                           ("conv", 3), ("other", len(s))):
            if len(s) < rank:
                continue
            for seq in (False, True):
                assert SP.cache_spec(name, s, pb, seq) == \
                    tuple(RSP.cache_spec(name, s, fake, seq)), (name, s)


# ---------------------------------------------------------------------------
# the collector's per-device bytes
# ---------------------------------------------------------------------------

def _toy_unit(folded: bool):
    """relu(x @ w1) @ w2 + x * x.  Autograd saves x (the boundary tensor,
    for x * x) and h = relu(x @ w1); ``folded`` computes the product on
    the (B*S, d) view, so h is saved as (B*S, f)."""
    B, S, d, f = 8, 16, 32, 64

    def apply(p, x):
        if folded:
            h = torch.relu(x.reshape(-1, d) @ p["w1"])
            return (h @ p["w2"]).reshape(x.shape) + x * x
        return torch.relu(x @ p["w1"]) @ p["w2"] + x * x
    unit = PlanUnit("toy", 0, {"w1": torch.ones(d, f),
                               "w2": torch.ones(f, d)}, apply)
    return unit, (B, S, d), B * S * d * 4, B * S * f * 4


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("shape,kw,want", [
    ((4,), {}, lambda x, h: (x + h) // 4),
    # the boundary tensor stays replicated over model
    ((4, 2), {}, lambda x, h: x // 4 + h // 8),
    # seq_parallel shards its sequence axis over model too
    ((4, 2), {"seq_parallel": True}, lambda x, h: (x + h) // 8),
    # a batch of 8 over 3 ways does not shard
    ((3,), {}, lambda x, h: x + h),
])
def test_unit_divisors_exact_on_handmade_unit(folded, shape, kw, want):
    """The port saves no bool relu mask, so its total is x + h where the
    reference's is x + h + mask; the divisor algebra is the same, and
    the folded (B*S, f) h divides as (B, S, f)."""
    unit, x_shape, x_bytes, h_bytes = _toy_unit(folded)
    info = unit_residual_bytes(unit, x_shape, torch.float32)
    assert info["activation_bytes"] == x_bytes + h_bytes
    assert info["device_activation_bytes"] == info["activation_bytes"]
    mb = MeshBudget.from_shape(shape, HBM, **kw)
    info = unit_residual_bytes(unit, x_shape, torch.float32, mb)
    assert info["device_activation_bytes"] == want(x_bytes, h_bytes)
    assert info["device_offloadable_bytes"] == want(x_bytes, h_bytes)
    out_div = mb.activation_divisor(x_shape, batch=8, d_model=32)
    assert info["device_output_bytes"] == x_bytes // out_div


def _toy_bert(attn_impl="xla"):
    cfg = get_config("bert_base_paper").reduced(
        num_layers=4, d_model=128, d_ff=256, vocab_size=512,
        dtype="float32")
    return LM(cfg, attn_impl=attn_impl, device="cpu")


_TOY_BATCH = {"tokens": torch.ones((4, 64), dtype=torch.long),
              "labels": torch.ones((4, 64), dtype=torch.long)}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_model_level_divisors_bounded_and_consistent(attn_impl):
    lm = _toy_bert(attn_impl)

    def vec(shape=None):
        mb = None if shape is None else MeshBudget.from_shape(shape, HBM)
        res = ShuttlingCollector(lm, mesh_budget=mb).collect(_TOY_BATCH)
        return res
    g = vec()
    d1 = vec((1,))
    for f in ("activation", "output", "offloadable", "opt"):
        got = getattr(d1, f"device_{f}_vector")()
        np.testing.assert_array_equal(got, getattr(g, f"device_{f}_vector")())
        np.testing.assert_array_equal(got, getattr(g, f"{f}_vector")())
    g, d1 = g.activation_vector(), d1.device_activation_vector()
    d4 = vec((4,)).device_activation_vector()
    d22 = vec((2, 2)).device_activation_vector()
    # batch 4 over data 4: every batch-led storage divides by 4
    assert (d4 >= d1 / 4 * 0.99).all() and (d4 < d1).all()
    assert (d4 <= d1 / 4 * 1.01).all()
    # (2, 2): data 2 always, model 2 only on the intermediates
    assert (d22 >= d1 / 4 * 0.99).all() and (d22 <= d1 / 2).all()


@pytest.mark.parametrize("B,shape", [(2, (2,)), (2, (2, 2)),
                                     (4, (4,)), (4, (4, 2))])
def test_moe_expert_led_storages_stay_replicated(B, shape):
    """Reduced granite with E = 12 experts, a multiple of B: the MoE
    block saves buffers that lead with E (``(E, G*C, d)``), which are
    not batch-led and stay replicated, as the reference keeps a leaf
    that does not lead with B.  Each storage the unit saves is held
    against the reference's divisor, with its folded batch axis (B*S,
    B*heads, B*kv heads) unfolded."""
    cfg = get_config("granite_moe_1b_a400m").reduced(num_experts=12,
                                                     dtype="float32")
    lm = LM(cfg, device="meta")
    S, E, d = 32, cfg.num_experts, cfg.d_model
    batch = {"tokens": torch.ones((B, S), dtype=torch.long),
             "labels": torch.ones((B, S), dtype=torch.long)}
    unit = lm.plan_units(batch)[0]
    x_shape = lm.unit_input_shape(unit, batch)
    folds = {B * S: S, B * cfg.num_heads: cfg.num_heads,
             B * cfg.num_kv_heads: cfg.num_kv_heads}
    assert E % B == 0 and E != B and E not in folds
    saved, _ = _saved_storages(unit, _meta_tree(unit.params), x_shape,
                               lm.dtype)
    rb = RB.MeshBudget.from_shape(shape, HBM)
    want = 0.0
    expert_bytes = 0
    for nb, _, s in saved:
        if s[0] in folds:
            s = (B, folds[s[0]]) + s[1:]
        expert_bytes += nb if s[0] == E else 0
        want += nb / rb.activation_divisor(s, batch=B, d_model=d)
    assert expert_bytes > 0
    info = unit_residual_bytes(unit, x_shape, lm.dtype,
                               MeshBudget.from_shape(shape, HBM))
    assert info["device_activation_bytes"] == int(want)
    assert info["device_activation_bytes"] > expert_bytes


# ---------------------------------------------------------------------------
# the planners on the reference's per-device vectors
# ---------------------------------------------------------------------------

class MeshStubResult(StubResult):
    """The stub's vectors with per-device ones: each unit's bytes over
    seeded ways in 2..8, the boundary over the data ways."""

    def __init__(self, coef, batch, flops_fn, lm, ways):
        super().__init__(coef, batch, flops_fn, lm)
        self._ways = ways

    def device_activation_vector(self):
        return np.floor(self._act / self._ways)

    def device_output_vector(self):
        return self._out / 4

    def device_offloadable_vector(self):
        return np.floor(0.8 * self._act / self._ways)

    def device_opt_vector(self):
        return np.zeros(N_UNITS)


class MeshStubCollector(StubCollector):
    def __init__(self, lm, flops_fn, seed=0):
        super().__init__(lm, flops_fn, seed)
        self.ways = np.random.default_rng(seed + 1).integers(2, 9, N_UNITS)

    def collect(self, *args):
        self.calls += 1
        return MeshStubResult(self.coef, args[-1], self.flops_fn, self.lm,
                              self.ways)


@pytest.fixture(scope="module")
def stub_lms():
    jlm = build_model(jax_get_config("bert_base_paper").reduced(
        **STUB_REDUCED))
    lm = LM(get_config("bert_base_paper").reduced(**STUB_REDUCED),
            device="cpu")
    return jlm, lm


def _stub_batches(S, B=8):
    tokens = np.ones((B, S), np.int32)
    return ({"tokens": tokens, "labels": tokens},
            {"tokens": torch.ones((B, S), dtype=torch.int32),
             "labels": torch.ones((B, S), dtype=torch.int32)})


def _per_device_budget(lm, frac):
    res = MeshStubCollector(lm, plan_unit_flops).collect(
        _stub_batches(max(SIZES))[1])
    return 1e6 + frac * float(res.device_activation_vector().sum())


def _same_plans(ref, ours, params=None):
    for S in SIZES:
        jb, tb = _stub_batches(S)
        (ra, ri), (a, i) = ref.plan(params, jb), ours.plan(tb)
        assert tuple(int(x) for x in ra) == tuple(int(x) for x in a), S
        assert ri.plan.microbatch == i.plan.microbatch
        assert (ri.cache_hit, ri.collected) == (i.cache_hit, i.collected)
        assert ri.quantized_size == i.quantized_size


@pytest.mark.parametrize("offload", [False, True])
@pytest.mark.parametrize("max_mb", [1, 4])
@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_mimose_chooses_as_the_reference_per_device(stub_lms, monkeypatch,
                                                    frac, max_mb, offload):
    pin_reference_constants(monkeypatch)
    jlm, lm = stub_lms
    budget = _per_device_budget(lm, frac)
    kw = dict(quantum=32, warmup_samples=3, max_microbatches=max_mb,
              offload=offload, fixed_bytes=1e6)
    rmb = RB.MeshBudget.from_shape((4, 2), HBM, zero1=True)
    pmb = MeshBudget.from_shape((4, 2), HBM, zero1=True)
    ref = RefMimose(jlm, budget, mesh_budget=rmb, **kw)
    ours = MimosePlanner(lm, budget, mesh_budget=pmb, **kw)
    ref.collector = MeshStubCollector(jlm, ref_flops)
    ours.collector = MeshStubCollector(lm, plan_unit_flops)
    _same_plans(ref, ours)
    assert ours.plan_key(_stub_batches(64)[1])[1] == pmb.sig()
    assert any(k[1] == pmb.sig() for k in ours.cache.keys())


@pytest.mark.parametrize("max_mb", [1, 4])
def test_baselines_choose_as_the_reference_per_device(stub_lms, monkeypatch,
                                                      max_mb):
    pin_reference_constants(monkeypatch)
    jlm, lm = stub_lms
    budget = _per_device_budget(lm, 0.3)
    rmb = RB.MeshBudget.from_shape((2, 2), HBM)
    pmb = MeshBudget.from_shape((2, 2), HBM)
    mx = 8 * max(SIZES)
    pairs = [
        (RefSublinear(jlm, budget, max_input_size=mx, mesh_budget=rmb,
                      fixed_bytes=1e6, max_microbatches=max_mb),
         SublinearPlanner(lm, budget, max_input_size=mx, mesh_budget=pmb,
                          fixed_bytes=1e6, max_microbatches=max_mb)),
        (RefDTR(jlm, budget, mesh_budget=rmb, fixed_bytes=1e6,
                max_microbatches=max_mb),
         DTRSimPlanner(lm, budget, mesh_budget=pmb, fixed_bytes=1e6,
                       max_microbatches=max_mb)),
    ]
    for ref, ours in pairs:
        ref.collector = MeshStubCollector(jlm, ref_flops)
        ours.collector = MeshStubCollector(lm, plan_unit_flops)
        _same_plans(ref, ours)


def test_budget_bytes_or_mesh_budget_is_required(stub_lms):
    _, lm = stub_lms
    for cls, kw in ((MimosePlanner, {}), (DTRSimPlanner, {}),
                    (SublinearPlanner, {"max_input_size": 1024})):
        with pytest.raises(ValueError, match="pass budget_bytes or "
                                             "mesh_budget"):
            cls(lm, **kw)
    p = MimosePlanner(lm, mesh_budget=MeshBudget.from_shape((4,), 3e9))
    assert p.budget_bytes == 3e9
    assert MimosePlanner(lm, 2e9, mesh_budget=MeshBudget.from_shape(
        (4,), 3e9)).budget_bytes == 2e9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_and_simulate_sharded_match_reference(monkeypatch, seed):
    pin_reference_constants(monkeypatch)
    rng = np.random.default_rng(seed)
    act = rng.uniform(1e6, 8e6, 12)
    out = rng.uniform(1e4, 1e5, 12)
    off = 0.7 * act
    flops = rng.uniform(1e9, 4e9, 12)
    fixed = 5e6
    for frac in (0.2, 0.6, 1.1):
        rmb = RB.MeshBudget.from_shape((4, 2), fixed + frac * act.sum())
        pmb = MeshBudget.from_shape((4, 2), fixed + frac * act.sum())
        for kw in ({}, {"flops": flops},
                   {"flops": flops, "output_bytes": out,
                    "offload_bytes": off}):
            want = ref_greedy_sharded(act, rmb, fixed, **kw)
            got = greedy_plan_sharded(act, pmb, fixed, **kw)
            assert tuple(int(a) for a in got.actions) == \
                tuple(int(a) for a in want.actions)
            rs = ref_simulate_sharded(act, want.actions, fixed, 8, out,
                                      flops / 8, offload_bytes=off)
            ps = simulate_sharded(act, got.actions, fixed, 8, out,
                                  flops / 8, offload_bytes=off)
            assert ps.peak_bytes_per_device == rs.peak_bytes_per_device
            assert ps.global_peak_bytes == rs.global_peak_bytes
            assert ps.step_overhead_s == pytest.approx(rs.step_overhead_s,
                                                       rel=1e-12)
            assert ps.fits(pmb.hbm_per_device_bytes) == \
                rs.fits(rmb.hbm_per_device_bytes)


# ---------------------------------------------------------------------------
# feasibility and keys on the port's own vectors
# ---------------------------------------------------------------------------

def test_sharded_feasible_where_single_device_is_not():
    """A per-device HBM below the global fixed bytes: infeasible on one
    device, plannable on a (4, 2) ZeRO-1 mesh."""
    lm = _toy_bert()
    hbm = 0.75 * fixed_train_bytes(lm.parameters())
    one = MeshBudget.from_shape((1,), hbm)
    p1 = MimosePlanner(lm, mesh_budget=one, warmup_samples=1, quantum=32)
    acts1, _ = p1.plan(_TOY_BATCH)
    col1 = p1.collector.collect(_TOY_BATCH)
    sim1 = simulate_sharded(col1.device_activation_vector(), acts1,
                            p1.resolve_fixed_bytes(), 1)
    assert not sim1.fits(hbm)

    mesh = MeshBudget.from_shape((4, 2), hbm, zero1=True)
    col = ShuttlingCollector(lm, mesh_budget=mesh).collect(_TOY_BATCH)
    margin = 2 * float(col.device_activation_vector().max())
    pm = MimosePlanner(lm, max(hbm - margin, 0.0), mesh_budget=mesh,
                       warmup_samples=1, quantum=32)
    acts, _ = pm.plan(_TOY_BATCH)
    sim = simulate_sharded(col.device_activation_vector(), acts,
                           pm.resolve_fixed_bytes(), mesh.n_devices)
    assert sim.fits(hbm)
    assert sim.n_devices == 8
    assert sim.global_peak_bytes == pytest.approx(
        8 * sim.peak_bytes_per_device)


def test_greedy_plan_respects_per_device_budget():
    """(4,) and (2, 2) ZeRO-1 meshes get their own per-device vectors
    and fixed bytes; each plan keeps the modelled footprint within its
    per-device budget, and ``greedy_plan_sharded`` on the same vectors
    gives the planner's plan."""
    lm = _toy_bert()
    for shape in ((4,), (2, 2)):
        budget = MeshBudget.from_shape(
            shape, 0.9 * fixed_train_bytes(lm.parameters()), zero1=True)
        planner = MimosePlanner(lm, mesh_budget=budget, warmup_samples=1,
                                quantum=32)
        acts, _ = planner.plan(_TOY_BATCH)
        col = planner.collector.collect(_TOY_BATCH)
        act = col.device_activation_vector()
        fixed = planner.resolve_fixed_bytes()
        saved = float(act[np.asarray(acts, dtype=int) == 0].sum())
        assert fixed + saved <= budget.hbm_per_device_bytes, shape
        p2 = greedy_plan_sharded(
            act, budget, fixed,
            flops=planner.planning_flops(col.flops_vector()))
        assert tuple(p2.as_actions()) == tuple(acts)


def test_cache_key_distinguishes_mesh_shapes():
    lm = _toy_bert()
    a = MimosePlanner(lm, 1e9, mesh_budget=MeshBudget.from_shape((4,), 1e9),
                      warmup_samples=1, quantum=32)
    b = MimosePlanner(lm, 1e9, mesh_budget=MeshBudget.from_shape(
        (2, 2), 1e9), warmup_samples=1, quantum=32)
    c = MimosePlanner(lm, 1e9, warmup_samples=1, quantum=32)
    keys = {a.plan_key(_TOY_BATCH), b.plan_key(_TOY_BATCH),
            c.plan_key(_TOY_BATCH)}
    assert len(keys) == 3
    assert len({k[0] for k in keys}) == 1
    z = MeshBudget.from_shape((4,), 1e9, zero1=True)
    assert z.sig() != MeshBudget.from_shape((4,), 1e9).sig()
    a.plan(_TOY_BATCH)
    assert list(a.cache) == [a.plan_key(_TOY_BATCH)]


def test_one_device_mesh_plans_and_trains_as_no_mesh(one_thread):
    """A (1,) mesh budget: the same vectors, fixed bytes, FLOPs, plans
    and losses as no mesh; only the keys' mesh element differs."""
    from repro_torch.data.pipeline import make_batches
    batches = list(make_batches("swag", batch_size=4, vocab_size=512,
                                num_batches=6, quantum=32, seed=0))
    runs = []
    for mb in (None, MeshBudget.from_shape((1, 1), 1e12)):
        lm = _toy_bert()
        fixed = fixed_train_bytes(lm.parameters())
        planner = MimosePlanner(lm, fixed + 2e6, mesh_budget=mb,
                                quantum=32, warmup_samples=2)
        tr = Trainer(lm, planner, AdamW(lr=1e-3))
        tr.run(batches)
        runs.append((tr, planner))
    (t0, p0), (t1, p1) = runs
    assert p0.resolve_fixed_bytes() == p1.resolve_fixed_bytes()
    assert [s.loss for s in t0.history] == [s.loss for s in t1.history]
    assert [s.remat_units for s in t0.history] == \
        [s.remat_units for s in t1.history]
    assert any(s.remat_units for s in t0.history)
    assert [k[:1] + k[2:] for k in p0.cache.keys()] == \
        [k[:1] + k[2:] for k in p1.cache.keys()]
    assert {k[1] for k in p1.cache.keys()} == {p1.mesh_budget.sig()}
    assert all(k[-1] == p1.mesh_sig() for k in t1._step_cache.keys())
    flops = np.array([3e9, 5e9])
    assert p1.planning_flops(flops).tolist() == flops.tolist()


def test_gemma3_full_depth_fits_a_mesh_not_one_device():
    """Full-depth gemma3_12b (48 layers, on meta): about 141.2 GB fixed on
    one device, 70.6 GB per device on (4, 2), 35.3 GB with ZeRO-1; at
    80 GiB a device, bucket 448 at B = 8 plans on (4, 2) with ZeRO-1 and
    not on one device."""
    lm = LM(get_config("gemma3_12b"), device="meta")
    hbm = 80 * 2**30
    batch = {"tokens": torch.zeros((8, 448), dtype=torch.long)}
    want = {(1,): (141.2e9, False), (4, 2): (70.6e9, None),
            ((4, 2), "zero1"): (35.3e9, True)}
    for key, (fixed_want, fits) in want.items():
        shape, zero1 = (key[0], True) if key[1:] == ("zero1",) else (key,
                                                                      False)
        mb = MeshBudget.from_shape(shape, hbm, zero1=zero1)
        planner = MimosePlanner(lm, mesh_budget=mb, warmup_samples=1,
                                quantum=64)
        fixed = planner.resolve_fixed_bytes()
        assert fixed == pytest.approx(fixed_want, rel=0.01), key
        acts, info = planner.plan(batch)
        res = planner.collector.collect(batch)
        sim = simulate_sharded(res.device_activation_vector(), acts, fixed,
                               mb.n_devices,
                               res.device_output_vector())
        if fits is not None:
            assert sim.fits(hbm) is fits, key


# ---------------------------------------------------------------------------
# mesh construction, placements, the launcher
# ---------------------------------------------------------------------------

def _launch(extra, capsys):
    argv = ["--device", "cpu", "--reduced", "--steps", "4",
            "--budget-mb", "30", "--quantum", "64"]
    tr = launch_train.main(argv + extra)
    return tr, capsys.readouterr().out


def test_launcher_mesh_flags(capsys, one_thread):
    """``--mesh-shape 1x1`` builds the mesh and trains as no mesh, its
    keys carrying the (1, 1) signature, and destroys the group it made;
    ``4x2 --zero1`` plans per device and executes on one device."""
    had_group = dist.is_initialized()
    base, _ = _launch([], capsys)
    one, out = _launch(["--mesh-shape", "1x1", "--hbm-gb", "80"], capsys)
    assert "the step runs under the 1-device mesh" in out
    assert one.mesh is not None and one.mesh.mesh_dim_names == \
        ("data", "model")
    assert dist.is_initialized() == had_group
    assert [s.loss for s in one.history] == [s.loss for s in base.history]
    assert [s.remat_units for s in one.history] == \
        [s.remat_units for s in base.history]
    sig = one.planner.mesh_sig()
    assert sig[0] == (("data", 1), ("model", 1))
    assert {k[1] for k in one.planner.cache.keys()} == {sig}
    wide, out = _launch(["--mesh-shape", "4x2", "--zero1"], capsys)
    assert "8 devices unavailable (1 present) -- planning per device" in out
    assert wide.mesh is None
    assert wide.planner.mesh_budget.zero1
    # --budget-mb (30 MiB) wins over --hbm-gb
    assert wide.planner.budget_bytes == 30 * 2**20
    assert wide.planner.resolve_fixed_bytes() < \
        base.planner.resolve_fixed_bytes() / 2
    assert sum(s.remat_units for s in wide.history) <= \
        sum(s.remat_units for s in base.history)


def test_make_production_mesh_explicit_shape(group):
    m = M.make_production_mesh(shape=(1, 1), device_type="cpu")
    assert m.mesh_dim_names == ("data", "model")
    assert tuple(m.mesh.shape) == (1, 1)
    m = M.make_production_mesh(shape=(1,), device_type="cpu")
    assert m.mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match="positive"):
        M.make_production_mesh(shape=(0, 2))
    with pytest.raises(ValueError, match="axis_names"):
        M.make_production_mesh(shape=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="does not match"):
        M.make_production_mesh(shape=(1,), axis_names=("data", "model"))
    with pytest.raises(RuntimeError, match="needs 8 devices but only 1"):
        M.make_production_mesh(shape=(4, 2))
    with pytest.raises(M.MeshUnavailable,
                       match="needs 2 devices but only 1"):
        M.make_debug_mesh(2, 1)
    assert dict(M.make_debug_mesh(device_type="cpu").mesh_dim_names and
                SP.axis_sizes(M.make_debug_mesh(device_type="cpu"))) == \
        {"data": 1, "model": 1}
    mb = M.budget_from_mesh(m, 1e9, zero1=True)
    assert mb.sig() == MeshBudget.from_shape((1,), 1e9, zero1=True).sig()


def test_parse_mesh_shape():
    assert M.parse_mesh_shape("4x2") == (4, 2)
    assert M.parse_mesh_shape("2x16x16") == (2, 16, 16)
    for bad in ("4x", "0x2", "x"):
        with pytest.raises(ValueError, match="bad mesh shape"):
            M.parse_mesh_shape(bad)


def test_mesh_budget_validation():
    with pytest.raises(ValueError, match="positive"):
        MeshBudget.from_shape((), 1e9)
    with pytest.raises(ValueError, match="axis_names"):
        MeshBudget.from_shape((2, 2, 2, 2), 1e9)
    b = MeshBudget.from_shape((2, 4, 8), 1e9)
    assert b.n_devices == 64 and b.data_ways == 8 and b.model_ways == 8


@pytest.mark.parametrize("name", ["qwen3", "granite", "hymba_scan"])
def test_shardings_become_placements(group, name):
    """Every parameter, moment, batch entry and cache leaf gets a spec
    and placements on a (1, 1) mesh, and a distributed tensor's local
    shard is the tensor."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.mesh import make_production_mesh
    arch, over = MODELS[name]
    lm = LM(get_config(arch).reduced(**over), device="cpu")
    mesh = make_production_mesh(shape=(1, 1), device_type="cpu")
    scanned = lm.cfg.remat_mode == "scan"
    p_sh = SP.params_shardings(lm, mesh, scanned=scanned)
    params = dict(lm.named_parameters())
    assert set(p_sh) == set(params)
    # a stacked leaf's per-layer tensors: its spec without the layer axis
    for key, shape, _, members in SP.reference_leaves(lm, scanned=scanned):
        spec = SP.param_spec(key, shape, scanned=scanned, model_dim=1,
                             data_dim=1)
        for n in members:
            assert p_sh[n][0] == (spec[1:] if key != n else spec)
    sharded = 0
    for n, (spec, pl) in p_sh.items():
        assert len(pl) == 2 and len(spec) == params[n].dim()
        sharded += any(isinstance(p, Shard) for p in pl)
        d = distribute_tensor(params[n].detach(), mesh, pl)
        assert torch.equal(d.to_local(), params[n].detach())
    assert sharded > 0
    o_sh = SP.opt_state_shardings(p_sh, lm, mesh, zero1=True)
    assert set(o_sh["m"]) == set(params) and o_sh["step"][0] == ()
    # ZeRO-1 adds data on each moment's first unsharded axis (all divide 1)
    for n, (spec, _) in o_sh["m"].items():
        if params[n].dim():
            assert "data" in spec, n
    batch = {"tokens": torch.ones((2, 16), dtype=torch.long),
             "labels": torch.ones((2, 16), dtype=torch.long),
             "lengths": torch.full((2,), 16)}
    b_sh = SP.batch_shardings(batch, mesh)
    assert b_sh["tokens"][0] == ("data", None)
    cache = lm.init_cache(4, 64, device="meta")
    c_sh = SP.cache_shardings(cache, mesh)
    assert len(c_sh) == len(cache)
    assert all(set(a) == set(b) for a, b in zip(c_sh, cache))


@pytest.mark.parametrize("qk_norm,impl", [(True, "xla"), (False, "xla"),
                                          (False, "flash")])
def test_train_step_on_a_one_device_mesh_is_the_plain_step(group,
                                                           one_thread,
                                                           qk_norm, impl):
    """``launch/steps.build_setup``'s train step on a built (1, 1) gloo
    mesh (reduced qwen3, fp32, real tensors, every unit REMAT): its loss
    is the LM's bit for bit.  Without qk-norm, two steps also update the
    parameters and moments bit for bit as the plain step (``lm.loss``,
    the backward, ``AdamW.update``), the flash route (its plain version
    here, through ``local_map`` on the mesh) included.  With qk-norm the
    second loss may differ in the last bits: the k-norm's backward here
    reduces a contiguous gradient (DTensor requires it) where the plain
    path's is strided."""
    from torch.distributed.tensor import DTensor
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_setup, place
    cfg = get_config("qwen3_1p7b").reduced(dtype="float32", qk_norm=qk_norm)
    mesh = make_production_mesh(shape=(1, 1), device_type="cpu")
    setup = build_setup(cfg, ShapeConfig("t", 32, 2, "train"), mesh,
                        remat="all", device="cpu", seed=0, attn_impl=impl,
                        optimizer=AdamW(lr=1e-3))
    params, opt_state = setup.args[0], setup.args[1]
    assert all(isinstance(p, DTensor) for p in params.values())
    lm = LM(cfg, device="cpu", seed=0, attn_impl=impl)
    ref = dict(lm.named_parameters())
    opt = AdamW(lr=1e-3)
    ref_state = opt.init(ref)
    g = torch.Generator().manual_seed(3)
    for step in range(1 if qk_norm else 2):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                         generator=g),
                 "labels": torch.randint(0, cfg.vocab_size, (2, 32),
                                         generator=g),
                 "lengths": torch.tensor([32, 17], dtype=torch.int32)}
        b = place(batch, SP.batch_shardings(batch, mesh), mesh)
        params, opt_state, loss = setup.fn(params, opt_state, b)
        want, _ = lm.loss(batch, setup.remat_mask)
        grads = dict(zip(ref, torch.autograd.grad(want, list(ref.values()))))
        ref_state = opt.update(grads, ref_state, ref)
        assert loss.to_local().item() == want.item(), step
    if not qk_norm:
        for n, p in ref.items():
            assert torch.equal(params[n].to_local(), p.detach()), n
            assert torch.equal(opt_state.m[n].to_local(), ref_state.m[n]), n
