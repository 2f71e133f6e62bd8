"""The port's serving path against the reference's: decode on the LM
(KV / SSM caches, ``decode_step``, the cache-slot operations), greedy
``generate``, the open-loop trace generator, the continuous-batching
``ServeEngine`` and its report, and the serve launcher.

Models mirror ``tests/test_serve.py``: each family's config reduced to
2 layers, d 64, d_ff 128, vocab 256, fp32 (qwen3 in scan mode; gemma3
and hymba keep ``reduced()``'s window 64 and global interval 2, and get
an 80-token prompt so the window is reached), parameters from the
reference's ``LM.init`` through ``repro_torch.bridge``, inputs from
numpy with a seed.

Tolerances:
* decode logits and caches against the reference's ``decode_step``:
  rtol 1e-4 / atol 1e-5 (fp32; the same formulas summed in another
  order, the SSD recurrence carried over several chunks);
* greedy tokens across packages are equal, except that a request may
  differ at its first differing token where the two candidates' logits
  (the port's prefill and decode over the common prefix) lie within
  ``TIE_ATOL`` of each other, i.e. tie; such requests are counted and
  printed (0 expected);
* within the port, the engine's tokens equal sequential ``generate``'s
  exactly (bar the MoE, whose expert capacity is set per group of a
  call's tokens, so its routing depends on the prefill chunk and the
  batch in both packages);
* the engine's predicted slot bytes equal the reference's within 1e-9
  relative (the same estimator on the same exact byte counts).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import trace as JT
from repro.launch.report import serve_report as ref_serve_report
from repro.models.lm import build_model
from repro.models.registry import get_config as jax_get_config
from repro.train import engine as JE
from repro.train.serve import cached_serve_step as ref_serve_step
from repro.train.serve import generate as ref_generate
from repro_torch import bridge
from repro_torch.data import trace as TT
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.report import serve_report
from repro_torch.models.lm import LM
from repro_torch.models.registry import get_config
from repro_torch.train import engine as TE
from repro_torch.train.serve import generate, prefill_into_cache

pytestmark = pytest.mark.serve

RED = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
           dtype="float32")
# family -> (arch, reduced() keywords beyond RED, prompt length)
FAMILIES = {
    "dense": ("qwen3_1p7b", dict(remat_mode="scan"), 40),
    "moe": ("granite_moe_1b_a400m", {}, 40),
    "ssm": ("mamba2_1p3b", {}, 40),
    "hybrid": ("hymba_1p5b", {}, 80),
    "vlm": ("qwen2_vl_7b", {}, 40),
    "gemma3": ("gemma3_12b", {}, 80),
}
RTOL, ATOL = 1e-4, 1e-5
TIE_ATOL = 1e-4
SMAX = 96
# (index, C): the prompt in chunks of 32 (and 16 to reach 80 tokens),
# two token steps, then a chunk of 32 at 80, whose start the cache of 96
# clamps to 64
DECODE_STEPS = [(0, 32), (32, 32), (64, 16), (80, 1), (81, 1), (80, 32)]


@pytest.fixture(scope="module")
def models():
    """family -> (reference LM, its params, the port's LM), built once."""
    built = {}

    def get(family, seed=0):
        if family not in built:
            arch, over, _ = FAMILIES[family]
            kw = {**RED, **over}
            jlm = build_model(jax_get_config(arch).reduced(**kw))
            params = jlm.init(jax.random.PRNGKey(seed))
            tlm = LM(get_config(arch).reduced(**kw), device="cpu")
            bridge.load_tree(tlm, params)
            built[family] = (jlm, params, tlm)
        return built[family]
    return get


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cache(tlm, ref_cache):
    return bridge.cache_from_tree(_np_tree(ref_cache))


def _assert_caches_close(tlm, port_cache, ref_cache, msg=""):
    stacked = tlm.cfg.remat_mode == "scan"
    got = bridge.cache_to_tree(port_cache, stacked=stacked)
    want = _np_tree(ref_cache)
    gl, gt = jax.tree_util.tree_flatten(got)
    wl, wt = jax.tree_util.tree_flatten(want)
    assert gt == wt, (gt, wt)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=msg)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# decode on the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_matches_reference(family, models):
    """Logits and the new cache after each step of DECODE_STEPS: chunked
    prefill (C = 32, 16), token decode (C = 1), and a chunk at the
    clamped edge, where the reference's dynamic_update_slice writes at
    Smax - C while the positions stay index + arange(C)."""
    jlm, params, tlm = models(family)
    B = 2
    jcache = jlm.init_cache(B, SMAX)
    tcache = tlm.init_cache(B, SMAX)
    step = ref_serve_step(jlm)
    for n, (index, C) in enumerate(DECODE_STEPS):
        tok = _tokens(tlm.cfg.vocab_size, (B, C), seed=n)
        want, jcache = step(params, jnp.asarray(tok), jcache, index)
        got, tcache = tlm.decode_step(torch.as_tensor(tok, dtype=torch.long),
                                      tcache, index)
        msg = f"{family} step {n} (index {index}, C {C})"
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=msg)
        _assert_caches_close(tlm, tcache, jcache, msg)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "gemma3"])
@pytest.mark.parametrize("C", [1, 4])
def test_vector_index_decode_matches_reference(family, C, models):
    """A (B,) index: every row at its own position, one row parked at
    index == Smax and, for C = 4, one that crosses the end; the
    reference drops the out-of-range writes (scatter mode "drop"), and
    so does the port: the parked row's keys and values stay as they
    were."""
    jlm, params, tlm = models(family)
    B = 4
    jcache = jlm.init_cache(B, SMAX)
    step = ref_serve_step(jlm)
    # fill the cache with a prefill, so the parked row holds data
    tok = _tokens(tlm.cfg.vocab_size, (B, 80), seed=7)
    _, jcache = step(params, jnp.asarray(tok), jcache, 0)
    tcache = _port_cache(tlm, jcache)
    before = [{k: v.clone() for k, v in layer.items()} for layer in tcache]
    index = np.array([5, 79, SMAX, SMAX - 2], np.int32)
    tok = _tokens(tlm.cfg.vocab_size, (B, C), seed=8)
    want, jcache = step(params, jnp.asarray(tok), jcache, jnp.asarray(index))
    got, tcache = tlm.decode_step(torch.as_tensor(tok, dtype=torch.long),
                                  tcache, torch.as_tensor(index))
    live = [0, 1, 3]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=RTOL, atol=ATOL)
    _assert_caches_close(tlm, tcache, jcache, family)
    for layer, old in zip(tcache, before):
        for key in ("k", "v"):
            if key in layer:
                assert torch.equal(layer[key][2], old[key][2])
                assert torch.equal(layer[key][3, :SMAX - 2],
                                   old[key][3, :SMAX - 2])


def test_vector_index_of_equal_entries_is_the_scalar_step(models):
    """The per-row scatter path is the slice path for equal positions
    (the reference's ``test_vector_index_decode_matches_scalar``)."""
    _, _, tlm = models("dense")
    tok = torch.as_tensor(_tokens(256, (2, 1), seed=5), dtype=torch.long)
    cache_s = tlm.init_cache(2, 32)
    cache_v = tlm.init_cache(2, 32)
    lg_s, cache_s = tlm.decode_step(tok, cache_s, 11)
    lg_v, cache_v = tlm.decode_step(tok, cache_v, torch.full((2,), 11))
    assert torch.equal(lg_s, lg_v)
    for a, b in zip(cache_s, cache_v):
        for key in a:
            assert torch.equal(a[key], b[key])


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_cache_slot_operations_match_reference(family, models):
    """``cache_insert`` / ``cache_extract`` / ``cache_evict`` on the same
    pool and rows as the reference's, slots in range and at the clamped
    edge (a start past B - n clamps as dynamic_update_slice does)."""
    jlm, params, tlm = models(family)
    rng = np.random.default_rng(3)

    def filled(B):
        return jax.tree_util.tree_map(
            lambda l: jnp.asarray(rng.standard_normal(l.shape)
                                  .astype(l.dtype)), jlm.init_cache(B, 16))
    jpool, jrows = filled(4), filled(2)
    tpool = _port_cache(tlm, jpool)
    trows = _port_cache(tlm, jrows)
    for slot in (1, 3):
        jpool = jlm.cache_insert(jpool, jrows, slot)
        tpool = tlm.cache_insert(tpool, trows, slot)
        _assert_caches_close(tlm, tpool, jpool, f"insert at {slot}")
    for slot in (0, 2, 5):
        _assert_caches_close(tlm, tlm.cache_extract(tpool, slot),
                             jlm.cache_extract(jpool, slot),
                             f"extract {slot}")
    jpool = jlm.cache_evict(jpool, 2)
    tpool = tlm.cache_evict(tpool, 2)
    _assert_caches_close(tlm, tpool, jpool, "evict")
    assert all(float(l.abs().max()) == 0.0
               for l in tlm.cache_extract(tpool, 2)[0].values())
    assert tlm.cache_batch_axis() == 0


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_cache_grow_matches_insert_into_a_new_pool(family, models):
    """``cache_grow`` equals the reference's growth (a new, larger pool
    with the old one inserted at row 0), and replaces the leaves in the
    same layer dicts."""
    jlm, _, tlm = models(family)
    rng = np.random.default_rng(5)
    jpool = jax.tree_util.tree_map(
        lambda l: jnp.asarray(rng.standard_normal(l.shape).astype(l.dtype)),
        jlm.init_cache(2, 16))
    tpool = _port_cache(tlm, jpool)
    layers = list(tpool)
    grown = tlm.cache_grow(tpool, 4)
    assert grown is tpool and all(a is b for a, b in zip(grown, layers))
    _assert_caches_close(tlm, grown,
                         jlm.cache_insert(jlm.init_cache(4, 16), jpool, 0),
                         "grow 2 -> 4")


def test_cache_layout_and_dtypes():
    """One dict per layer in both modes: k, v in the model's dtype, ssm
    fp32, conv in the model's dtype; the encoder-decoder family has no
    cache; a meta cache allocates nothing."""
    cfg = get_config("hymba_1p5b").reduced(**{**RED, "dtype": "bfloat16",
                                              "remat_mode": "scan"})
    lm = LM(cfg, device="meta")
    cache = lm.init_cache(3, 64)
    assert len(cache) == cfg.num_layers
    layer = cache[0]
    assert layer["k"].shape == (3, 64, cfg.num_kv_heads, 32)
    assert layer["k"].dtype == layer["v"].dtype == torch.bfloat16
    assert layer["ssm"].dtype == torch.float32
    assert layer["conv"].dtype == torch.bfloat16
    assert layer["conv"].shape[1] == cfg.conv_kernel - 1
    assert layer["k"].device.type == "meta"
    enc = get_config("seamless_m4t_large_v2").reduced(
        **RED, encoder_layers=1)
    with pytest.raises(ValueError, match="decoder-only"):
        LM(enc, device="meta").init_cache(1, 8)


def test_cache_tree_round_trip(models):
    """``bridge.cache_from_tree`` / ``cache_to_tree`` invert each other,
    for the scan mode's stacked layout too."""
    jlm, _, tlm = models("dense")
    tree = _np_tree(jax.tree_util.tree_map(
        lambda l: l + 1.5, jlm.init_cache(2, 8)))
    back = bridge.cache_to_tree(bridge.cache_from_tree(tree), stacked=True)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def _logits_after(tlm, prompt, prefix, chunk, cache_len):
    """The port's last logits after prefilling ``prompt`` in chunks of
    ``chunk`` and decoding ``prefix`` token by token: the logits that
    chose the token after the prefix."""
    cache = tlm.init_cache(1, cache_len)
    lg, cache = prefill_into_cache(
        tlm, torch.as_tensor(np.asarray(prompt)[None], dtype=torch.long),
        cache, chunk)
    for i, t in enumerate(prefix):
        lg, cache = tlm.decode_step(torch.tensor([[int(t)]]), cache,
                                    len(prompt) + i)
    return lg[0, -1]


def _first_tie(tlm, prompt, got, want, chunk=32, cache_len=None):
    """None when ``got == want``; else True when, at the first position
    they differ, the two candidates' logits tie within TIE_ATOL.  Raises
    where they differ and do not tie."""
    got, want = list(got), list(want)
    if got == want:
        return None
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    lg = _logits_after(tlm, prompt, want[:j], chunk,
                       cache_len or len(prompt) + len(want))
    gap = abs(float(lg[got[j]]) - float(lg[want[j]]))
    assert gap <= TIE_ATOL, (
        f"token {j} differs ({got[j]} vs {want[j]}) and the logits do not "
        f"tie: gap {gap:.3e} > {TIE_ATOL}")
    return True


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_generate_matches_reference(family, models):
    """Greedy tokens token for token against the reference's
    ``generate`` at the same prefill chunk (tie rule above), chunks of
    32 and of 1.  Within the port the two chunkings agree, bar the MoE:
    its expert capacity is set per group of a call's tokens, so its
    routing, in both packages, depends on the chunk."""
    jlm, params, tlm = models(family)
    S = FAMILIES[family][2]
    prompt = _tokens(tlm.cfg.vocab_size, (2, S), seed=11)
    ties = 0
    outs = {}
    for chunk in (32, 1):
        want = np.asarray(ref_generate(jlm, params, jnp.asarray(prompt), 8,
                                       prefill_chunk=chunk))
        outs[chunk] = generate(tlm, torch.as_tensor(prompt, dtype=torch.long),
                               8, prefill_chunk=chunk).numpy()
        for b in range(2):
            ties += bool(_first_tie(tlm, prompt[b], outs[chunk][b], want[b],
                                    chunk))
    print(f"{family}: {ties} tie-divergent request(s)")
    if family != "moe":
        np.testing.assert_array_equal(outs[1], outs[32])


def test_prefill_into_cache_runs_full_chunks_then_the_remainder(
        models, monkeypatch):
    """Chunk 32 over a 40-token prompt: calls of 32 and 8, whose last
    logits are the prompt's last 8 positions."""
    _, _, tlm = models("dense")
    prompt = torch.as_tensor(_tokens(256, (1, 40), seed=2), dtype=torch.long)
    widths = []
    step = tlm.decode_step

    def spy(tokens, cache, index):
        widths.append((index, tokens.shape[1]))
        return step(tokens, cache, index)
    monkeypatch.setattr(tlm, "decode_step", spy)
    logits, _ = prefill_into_cache(tlm, prompt, tlm.init_cache(1, 48))
    assert widths == [(0, 32), (32, 8)]
    assert logits.shape == (1, 8, 256)


def test_sampled_generate_is_seeded():
    """``temperature > 0`` draws from a torch.Generator seeded with
    ``seed`` (its stream is not jax.random's): the same seed gives the
    same tokens, another seed others."""
    cfg = get_config("qwen3_1p7b").reduced(**RED)
    lm = LM(cfg, device="cpu", seed=3)
    prompt = torch.as_tensor(_tokens(256, (2, 12), seed=1), dtype=torch.long)
    a = generate(lm, prompt, 16, temperature=1.0, seed=0)
    b = generate(lm, prompt, 16, temperature=1.0, seed=0)
    c = generate(lm, prompt, 16, temperature=1.0, seed=1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="cache_len"):
        generate(lm, prompt, 16, cache_len=20)


# ---------------------------------------------------------------------------
# the trace generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_requests=10, vocab_size=128, rate_rps=4.0, max_new_tokens=8,
         seed=5),
    dict(num_requests=6, vocab_size=256, rate_rps=0.0, max_new_tokens=8,
         min_new_tokens=4, prompt_scale=0.2, seed=3),
    dict(num_requests=32, vocab_size=151936, dataset="squad", rate_rps=0.0,
         max_new_tokens=64, seed=0),
    dict(num_requests=12, vocab_size=512, dataset="qqp", rate_rps=8.0,
         seed=9)])
def test_gen_trace_is_the_references_bit_for_bit(kw):
    """Same arguments, same requests: rid, arrival time, prompt (values
    and dtype) and decode length; ``to_json`` equal, and each package's
    ``from_json`` reads the other's records back."""
    want = JT.gen_trace(**kw)
    got = TT.gen_trace(**kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.arrival_s, g.max_new_tokens) == \
            (w.rid, w.arrival_s, w.max_new_tokens)
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.to_json() == w.to_json()
        for back in (TT.TraceRequest.from_json(w.to_json()),
                     JT.TraceRequest.from_json(g.to_json())):
            np.testing.assert_array_equal(back.prompt, w.prompt)
            assert back.arrival_s == round(w.arrival_s, 6)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _mixed_trace(cfg, n=6, new=8, seed=3):
    return TT.gen_trace(num_requests=n, vocab_size=cfg.vocab_size,
                        rate_rps=0.0, max_new_tokens=new, min_new_tokens=4,
                        prompt_scale=0.2, seed=seed)


ENGINE_KW = dict(hbm_bytes=2e9, quantum=32, max_slots=4, prefill_chunk=8,
                 decode_steps=2)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "moe", "vlm",
                                    "gemma3"])
def test_engine_matches_generate_and_the_reference_engine(family, models):
    """A mixed-length burst: every request's tokens equal the reference
    engine's on the same trace (tie rule) and, bar the MoE (whose routing
    depends on a call's chunk), a one-request ``generate`` at the
    engine's bucketed cache length exactly; the geometry set and the
    counters equal the reference's."""
    jlm, params, tlm = models(family)
    trace = _mixed_trace(tlm.cfg)
    assert len({len(r.prompt) for r in trace}) > 1
    eng = TE.ServeEngine(tlm, **ENGINE_KW)
    res = eng.run(trace)
    ref = JE.ServeEngine(jlm, params, **ENGINE_KW)
    ref_res = ref.run(JT.gen_trace(num_requests=6,
                                   vocab_size=tlm.cfg.vocab_size,
                                   rate_rps=0.0, max_new_tokens=8,
                                   min_new_tokens=4, prompt_scale=0.2,
                                   seed=3))
    assert res.completed == ref_res.completed == len(trace)
    ties = 0
    for r in trace:
        if family != "moe":
            want = generate(tlm, torch.as_tensor(r.prompt[None],
                                                 dtype=torch.long),
                            r.max_new_tokens,
                            cache_len=eng.bucket_of(r))[0].tolist()
            assert res.outputs[r.rid] == want, f"rid {r.rid}"
        ties += bool(_first_tie(tlm, r.prompt, res.outputs[r.rid],
                                ref_res.outputs[r.rid], 8,
                                eng.bucket_of(r)))
    print(f"{family}: {ties} tie-divergent request(s)")
    assert eng.compile_keys == ref.compile_keys
    assert res.compile_counts == ref_res.compile_counts
    assert res.stats == {k: v for k, v in ref_res.stats.items()}


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_slot_bytes_match_reference(family, models):
    """The admission estimator's per-slot prediction, fitted on meta
    counts, equals the reference's (fitted on eval_shape counts) within
    1e-9 relative, on sampled and unsampled buckets; both are within 5 %
    of the exact count (the reference's own test)."""
    jlm, params, tlm = models(family)
    eng = TE.ServeEngine(tlm, hbm_bytes=1e9, quantum=32)
    ref = JE.ServeEngine(jlm, params, hbm_bytes=1e9, quantum=32)
    assert eng.param_bytes == ref.param_bytes
    assert eng._token_ws == ref._token_ws
    for bucket in (32, 64, 96, 128, 320, 576):
        want = ref.slot_bytes(bucket)
        assert abs(eng.slot_bytes(bucket) - want) <= 1e-9 * want, bucket
        truth = float(TE.cache_leaf_bytes(tlm, bucket).sum())
        assert truth == float(JE.cache_leaf_bytes(jlm, bucket).sum())
        assert abs(eng.slot_bytes(bucket) - truth) <= 0.05 * truth


def _tight(eng, bucket, slots):
    return (eng.param_bytes + eng.slot_bytes(bucket) * slots
            + eng.prefill_chunk * eng._token_ws * 2)


def test_admission_never_exceeds_budget(models):
    """A budget that forces deferrals: every request completes, and the
    tensor-byte peak stays within the predicted peak, within the
    budget."""
    _, _, tlm = models("dense")
    trace = _mixed_trace(tlm.cfg, n=8, seed=11)
    probe = TE.ServeEngine(tlm, hbm_bytes=1e9, quantum=32, max_slots=2,
                           prefill_chunk=8)
    tight = _tight(probe, 64, 3)
    eng = TE.ServeEngine(tlm, hbm_bytes=tight, quantum=32, max_slots=2,
                         prefill_chunk=8)
    res = eng.run(trace)
    assert res.stats["deferrals"] > 0, "budget was not tight"
    assert res.completed == len(trace)
    assert (res.stats["peak_actual_bytes"]
            <= res.stats["peak_predicted_bytes"] <= tight)
    assert res.peak_allocated_bytes is None       # no CUDA allocator here


def test_workspace_charges_enter_the_ledger(models):
    """Off CUDA the charges are the reference's per-token formula; the
    larger charges a CUDA run measures (prefill per token, decode per
    slot, bytes beside the parameters) raise the predicted ledger and
    the admission cost, and the run still fits its budget."""
    _, _, tlm = models("dense")
    trace = _mixed_trace(tlm.cfg, n=8, seed=11)
    kw = dict(quantum=32, max_slots=2, prefill_chunk=8)
    probe = TE.ServeEngine(tlm, hbm_bytes=1e9, **kw)
    budget = _tight(probe, 64, 4)
    base = TE.ServeEngine(tlm, hbm_bytes=budget, **kw)
    base_res = base.run(trace)
    assert base.prefill_ws == base.slot_ws == base._token_ws
    assert base.fixed_bytes == 0
    eng = TE.ServeEngine(tlm, hbm_bytes=budget, **kw)
    eng.prefill_ws = 2.0 * eng._token_ws
    eng.slot_ws = 3.0 * eng._token_ws
    eng.fixed_bytes = 1000
    bucket = eng.bucket_of(trace[0])
    assert eng._admit_cost(bucket) == (
        2 * eng.slot_bytes(bucket) + eng.prefill_chunk * eng.prefill_ws
        + eng.slot_ws)
    assert eng.predicted_bytes() == eng.param_bytes + 1000
    res = eng.run(trace)
    assert res.completed == len(trace)
    assert res.stats["deferrals"] >= base_res.stats["deferrals"] > 0
    assert (res.stats["peak_actual_bytes"] + eng.fixed_bytes
            <= res.stats["peak_predicted_bytes"] <= budget)
    assert res.outputs == base_res.outputs


def test_deferred_requests_are_eventually_served(models):
    _, _, tlm = models("dense")
    trace = _mixed_trace(tlm.cfg, n=5, seed=13)
    probe = TE.ServeEngine(tlm, hbm_bytes=1e9, quantum=32)
    eng = TE.ServeEngine(tlm, hbm_bytes=_tight(probe, 64, 3), quantum=32,
                         max_slots=4, prefill_chunk=8)
    res = eng.run(trace)
    assert res.stats["deferrals"] > 0
    assert res.rejected == 0
    assert res.completed == len(trace)
    assert sorted(res.outputs) == sorted(r.rid for r in trace)


def test_request_that_never_fits_is_rejected(models):
    _, _, tlm = models("dense")
    probe = TE.ServeEngine(tlm, hbm_bytes=1e9, quantum=32)
    small = TT.TraceRequest(rid=0, arrival_s=0.0,
                            prompt=np.arange(1, 9, dtype=np.int32),
                            max_new_tokens=4)
    huge = TT.TraceRequest(rid=1, arrival_s=0.0,
                           prompt=np.ones(4096, np.int32), max_new_tokens=64)
    tight = _tight(probe, 32, 4)
    eng = TE.ServeEngine(tlm, hbm_bytes=tight, quantum=32, max_slots=2,
                         prefill_chunk=8)
    res = eng.run([small, huge])
    assert res.completed == 1 and 0 in res.outputs
    assert res.rejected == 1
    assert res.stats["peak_actual_bytes"] <= tight


def test_idle_pools_are_released_before_a_rejection(models):
    """A budget of the parameters, two slots of the largest bucket and
    two chunks of workspace: every request fits alone, and the port
    serves them all.  The reference's engine rejects half of them: once
    nothing is in flight it rejects the head before admitting again,
    and it keeps idle pools for waiting requests of their buckets,
    which then fit beside neither pool (a fault of the reference, not
    ported)."""
    jlm, params, tlm = models("ssm")
    kw = dict(quantum=32, max_slots=4, prefill_chunk=8, decode_steps=2)
    gen = dict(num_requests=10, vocab_size=tlm.cfg.vocab_size,
               rate_rps=0.0, max_new_tokens=8, min_new_tokens=4,
               prompt_scale=0.4, seed=5)
    trace = TT.gen_trace(**gen)
    probe = TE.ServeEngine(tlm, hbm_bytes=1e12, **kw)
    big = max(probe.bucket_of(r) for r in trace)
    budget = (probe.param_bytes + 2 * probe.slot_bytes(big)
              + 2 * probe.prefill_chunk * probe._token_ws)
    assert all(probe.param_bytes + probe._admit_cost(probe.bucket_of(r))
               <= budget for r in trace)
    eng = TE.ServeEngine(tlm, hbm_bytes=budget, **kw)
    res = eng.run(trace)
    assert res.completed == len(trace) and res.rejected == 0
    assert res.stats["deferrals"] > 0
    assert res.stats["peak_predicted_bytes"] <= budget
    ref = JE.ServeEngine(jlm, params, hbm_bytes=budget, **kw)
    assert ref.run(JT.gen_trace(**gen)).rejected > 0


def test_budget_below_params_raises(models):
    _, _, tlm = models("dense")
    with pytest.raises(ValueError, match="parameter bytes"):
        TE.ServeEngine(tlm, hbm_bytes=1.0)


def test_encdec_family_rejected():
    cfg = get_config("seamless_m4t_large_v2").reduced(
        **{**RED, "encoder_layers": 1, "num_layers": 1})
    lm = LM(cfg, device="cpu", seed=4)
    assert lm.kind == "dec"
    with pytest.raises(ValueError, match="decoder-only"):
        TE.ServeEngine(lm, hbm_bytes=1e9)


def test_prefill_chunks_are_powers_of_two(models):
    _, _, tlm = models("dense")
    trace = _mixed_trace(tlm.cfg, n=6, seed=19)
    eng = TE.ServeEngine(tlm, hbm_bytes=2e9, quantum=32, prefill_chunk=16)
    res = eng.run(trace)
    widths = {k[2] for k in eng.compile_keys if k[0] == "prefill"}
    assert widths <= {1, 2, 4, 8, 16}, widths
    n_buckets = len({eng.bucket_of(r) for r in trace})
    assert res.compile_counts["decode"] <= n_buckets * len(eng.tiers)


def test_serve_report_has_the_reference_rows(models):
    """The port's report renders the reference's rows, in order, for the
    same trace; the allocator row only on CUDA."""
    jlm, params, tlm = models("dense")
    trace = _mixed_trace(tlm.cfg, n=3, seed=23)
    eng = TE.ServeEngine(tlm, hbm_bytes=2e9, quantum=32)
    res = eng.run(trace)
    ref = JE.ServeEngine(jlm, params, hbm_bytes=2e9, quantum=32)
    ref_res = ref.run(trace)
    text = serve_report(eng, res)
    want = ref_serve_report(ref, ref_res)

    def labels(t):
        return [line.split("|")[1].strip() for line in t.splitlines()]
    assert labels(text) == labels(want)
    assert "admission" in text and "compiled geometries" in text
    assert f"{res.completed} /" in text
    res.peak_allocated_bytes = 123_000_000
    assert "| peak allocated (CUDA allocator) | 123.00 MB |" in \
        serve_report(eng, res)
    assert "peak_allocated_mb" in res.summary()


def test_launcher_serves_reduced_on_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.serve --device cpu --reduced`` runs
    to its report, and reads a trace in tools/gen_trace.py's JSON."""
    eng, res = launch_serve.main(["--device", "cpu", "--reduced",
                                  "--arch", "qwen3_1p7b", "--num-requests",
                                  "8", "--hbm-gb", "0.5", "--rate-rps", "0",
                                  "--max-new-tokens", "4",
                                  "--save", str(tmp_path / "s.json")])
    out = capsys.readouterr().out
    assert "| metric | value |" in out and "compiled geometries" in out
    assert res.completed == 8 and eng.lm.device.type == "cpu"
    trace = JT.gen_trace(num_requests=3, vocab_size=512, rate_rps=0.0,
                         max_new_tokens=4, seed=1)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps([r.to_json() for r in trace]))
    _, res = launch_serve.main(["--device", "cpu", "--reduced",
                                "--arch", "mamba2-1.3b", "--trace",
                                str(path)])
    assert sorted(res.outputs) == [0, 1, 2]
    assert all(len(res.outputs[r.rid]) == 4 for r in trace)


def test_decode_builds_no_graph(models):
    """Serving runs under inference mode: the parameters require grad,
    the logits and the cache do not."""
    _, _, tlm = models("hybrid")
    assert tlm.embed.requires_grad
    cache = tlm.init_cache(1, 16)
    logits, cache = tlm.decode_step(torch.ones((1, 4), dtype=torch.long),
                                    cache, 0)
    assert not logits.requires_grad
    assert not any(t.requires_grad for layer in cache for t in layer.values())
