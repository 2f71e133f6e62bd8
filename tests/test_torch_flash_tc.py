"""The tensor-core flash-attention kernels' arithmetic, emulated on the
CPU, and the dispatch between them and the FMA kernels they replaced.
The tensor-core kernels take head dims 16, 32, 64, 80, 128 and 256
(``fa.HEAD_DIMS``), the FMA kernels 16, 32, 64 and 128
(``fa.FMA_HEAD_DIMS``).  In fp32 at 256 the forward, dq and dk/dv split
each tile's output columns over several CTAs that each recompute the
scores.  In bf16 at 256 all three run on ``wgmma`` and TMA with one CTA
of two warpgroups (``fa.WGMMA_THREADS``) per tile, which owns the
tile's 256 output columns and computes its scores once: the forward
(``flash_fwd_wgmma_kernel``) gives each warpgroup one query head of the
GQA group, both reading the same k and v tiles, each running s = q k^T,
the online softmax over the 64-key tiles in ascending order (row max and
sum in fp32 from the unrounded p) and o += p v with p rounded to bf16
once; in dq and dk/dv (``flash_bwd_dq_wgmma_kernel``,
``flash_bwd_dkv_wgmma_kernel``) p passes between the warpgroups in fp32,
and ds as the bf16 operand it is rounded to once.  No design changes
which values are rounded where or what each tile sums, so the emulation
below stands for every head dim; ``WGMMA_CASES`` hold the wgmma
kernels' arithmetic on ``chip_smoke.py``'s hd-256 shapes and on the
forward's edges (GQA groups 1 to 4, q tiles wholly past ``kv_len`` and
a row of length 0, the window biting).

``csrc/flash_attention.cu``'s forward (``flash_fwd_tc_kernel``), dq
kernel (``flash_bwd_dq_tc_kernel``) and dk/dv kernel
(``flash_bwd_dkv_tc_kernel``) multiply on the tensor cores (``mma.sync``
m16n8k16, bf16 operands, fp32 accumulators).  For fp32 inputs every
operand -- q, k, v, do and the score tiles p and ds built in fp32 -- is
split into bf16 hi + lo = hi + bf16(x - hi), and each product is issued
as hi.hi + hi.lo + lo.hi; for bf16 inputs the operands are exact and p,
ds are rounded to bf16 once.  The forward walks 64-key tiles with an
online softmax (row max and row sum in fp32 from the unrounded p); the
dq kernel walks 64-key tiles with no softmax state; the dk/dv kernel
walks 64-query tiles and sums the GQA group in its accumulators.

``flash_fwd_tc_emulated``, ``flash_dq_tc_emulated`` and
``flash_dkv_tc_emulated`` repeat that arithmetic tile by tile.  They are
held against the JAX reference
(``repro.kernels.ref.flash_attention_reference`` and its ``jax.vjp``)
from the same numpy inputs at ``chip_smoke.py``'s ``TOL``: forward rtol
2e-4 / atol 2e-5 (lse 2e-5 / 2e-5), backward rtol 2e-3 / atol 2e-4,
bf16 3e-2.  Without the lo halves (one bf16 rounding of each fp32
operand) each of the three kernels leaves its tolerance at the main
width.
"""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_reference as jax_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_mask

torch.backends.cuda.matmul.allow_tf32 = False

BQ = BK = 64
NEG_BIG = float(torch.finfo(torch.float32).min)

# (B, S, H, Hkv, hd, causal, window, dtype, lens): tests/test_kernels.py
# FLASH_CASES, tests/test_ragged.py RAGGED_FLASH_CASES (their lengths
# drawn as there), and one main-width bert head (S = 416, hd 64, L = 338)
FLASH_CASES = [
    (1, 64, 2, 2, 32, True, 0, "float32", None),
    (2, 128, 4, 2, 64, True, 0, "float32", None),
    (1, 256, 8, 1, 32, True, 0, "float32", None),
    (1, 96, 4, 4, 32, True, 32, "float32", None),
    (2, 128, 4, 2, 64, True, 64, "float32", None),
    (1, 128, 2, 2, 32, False, 0, "float32", None),
    (1, 128, 4, 2, 64, True, 0, "bfloat16", None),
    (1, 80, 2, 2, 16, True, 0, "float32", None),
]
RAGGED_CASES = [
    (2, 96, 4, 2, 32, True, 0, "float32", "drawn"),
    (2, 96, 4, 4, 32, True, 32, "float32", "drawn"),
    (2, 128, 8, 1, 16, True, 0, "float32", "drawn"),
    (2, 96, 2, 2, 32, False, 0, "float32", "drawn"),
    (2, 160, 4, 2, 128, True, 0, "float32", [97, 160]),
]
MAIN_HEAD = (1, 416, 1, 1, 64, True, 0, "float32", [338])
# head dims 80 (stablelm) and 256 (gemma3), which no reference test
# takes: GQA, ragged and windowed, fp32 (hi/lo) and bf16
WIDE_CASES = [
    (2, 160, 4, 2, 80, True, 0, "float32", "drawn"),
    (2, 96, 4, 4, 80, True, 32, "float32", "drawn"),
    (2, 128, 4, 1, 80, True, 64, "bfloat16", "drawn"),
    (2, 160, 4, 2, 256, True, 0, "float32", "drawn"),
    (2, 128, 4, 1, 256, True, 64, "float32", "drawn"),
    (2, 160, 4, 2, 256, True, 64, "bfloat16", [100, 160]),
]
# bf16 at head dim 256 (the wgmma kernels) on the four shapes
# chip_smoke.py checks there: GQA groups 2, 1, 1 and 4, windows 32 and 64,
# non-causal, ragged; then the forward's edges: an odd group (its last
# pair of query heads has one), gemma3's group 2 with two of a row's q
# tiles wholly past kv_len, and group 2 and 1 with the window biting
# over several key tiles
WGMMA_CASES = [
    (2, 160, 4, 2, 256, True, 0, "bfloat16", "drawn"),
    (2, 96, 4, 4, 256, True, 32, "bfloat16", "drawn"),
    (1, 128, 2, 2, 256, False, 0, "bfloat16", None),
    (2, 200, 4, 1, 256, True, 64, "bfloat16", "drawn"),
    (2, 160, 6, 2, 256, True, 0, "bfloat16", "drawn"),
    (3, 192, 4, 2, 256, True, 0, "bfloat16", [192, 40, 1]),
    (2, 320, 4, 2, 256, True, 128, "bfloat16", [320, 257]),
    (1, 256, 2, 2, 256, True, 64, "bfloat16", None),
]
TC_CASES = FLASH_CASES + RAGGED_CASES + [MAIN_HEAD] + WIDE_CASES + WGMMA_CASES
# the wgmma forward on a batch with a row of length 0 (the pad row of a
# non-divisor split), every q tile of which does no work; the forward
# only, since the reference's gradients of a row with no visible key are
# not finite
WGMMA_EMPTY_ROW = (3, 192, 4, 2, 256, True, 0, "bfloat16", [192, 40, 0])

# chip_smoke.py's TOL: (rtol, atol)
TOL = {"float32": {"fwd": (2e-4, 2e-5), "bwd": (2e-3, 2e-4)},
       "bfloat16": {"fwd": (3e-2, 3e-2), "bwd": (3e-2, 3e-2)}}
LSE_TOL = (2e-5, 2e-5)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _mm(a, b, split):
    """a @ b as the kernel's tensor-core products: with ``split`` each
    fp32 operand is hi + lo and the sum is hi.hi + hi.lo + lo.hi;
    without, each operand is rounded to bf16 once (exact for bf16
    inputs)."""
    ah, bh = _bf16(a), _bf16(b)
    out = ah @ bh
    if split:
        out = out + ah @ _bf16(b - bh) + _bf16(a - ah) @ bh
    return out


def _expand(t, group):
    return t.float().repeat_interleave(group, dim=1)


def _idle_rows(kv_len, B, S):
    """(B, 1, S) rows of the q-tiles that start at or past kv_len: those
    tiles do no work."""
    lens = torch.full((B,), S) if kv_len is None else kv_len.long()
    return (torch.arange(S)[None] // BQ * BQ >= lens[:, None])[:, None]


def flash_fwd_tc_emulated(q, k, v, kv_len=None, causal=True, window=0,
                          split=None):
    """(o, lse) of the tensor-core forward.  ``split`` defaults to the
    kernel's choice (fp32 inputs split, bf16 not); ``split=False`` on fp32
    inputs drops the lo halves."""
    if split is None:
        split = q.dtype == torch.float32
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), _expand(k, group), _expand(v, group)
    mask = attention_mask(S, S, kv_len, causal=causal, window=window,
                          device=q.device)[:, None]
    m = torch.full((B, H, S), NEG_BIG)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    # every row walks every key tile: the tiles the kernel's trip count
    # skips are wholly masked for that row and change nothing here
    for k0 in range(0, S, BK):
        ks = slice(k0, k0 + BK)
        s = _mm(qf, kf[..., ks, :].transpose(-1, -2), split) * scale
        s = s.masked_fill(~mask[..., ks], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm(p, vf[..., ks, :], split)
        m = m_new
    lc = l.clamp_min(1e-30)
    o, lse = acc / lc[..., None], m + torch.log(lc)
    # q-tiles starting at or past kv_len do no work
    idle = _idle_rows(kv_len, B, S)
    o = o.masked_fill(idle[..., None], 0.0)
    lse = lse.masked_fill(idle, NEG_BIG + math.log(1e-30))
    return o.to(q.dtype), lse


def flash_dq_tc_emulated(q, k, v, do, lse, delta, kv_len=None, causal=True,
                         window=0, split=None):
    """dq of the tensor-core dq kernel: per 64-key tile, s = q k^T and
    dp = do v^T, p = exp(s scale - lse) and ds = p (dp - delta) scale
    under the forward's masks, dq += ds k; q-tiles starting at or past
    kv_len give 0."""
    if split is None:
        split = q.dtype == torch.float32
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf, dof = q.float(), do.float()
    kf, vf = _expand(k, group), _expand(v, group)
    mask = attention_mask(S, S, kv_len, causal=causal, window=window,
                          device=q.device)[:, None]
    dq = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, BK):
        ks = slice(k0, k0 + BK)
        s = _mm(qf, kf[..., ks, :].transpose(-1, -2), split) * scale
        p = torch.where(mask[..., ks], torch.exp(s - lse[..., None]), 0.0)
        dp = _mm(dof, vf[..., ks, :].transpose(-1, -2), split)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + _mm(ds, kf[..., ks, :], split)
    dq = dq.masked_fill(_idle_rows(kv_len, B, S)[..., None], 0.0)
    return dq.to(q.dtype)


def flash_dkv_tc_emulated(q, k, v, do, lse, delta, kv_len=None, causal=True,
                          window=0, split=None):
    """(dk, dv) per kv head of the tensor-core dk/dv kernel: per 64-query
    tile, p = exp(s - lse) and ds = p (dp - delta) scale under the
    forward's masks and q < kv_len, dv += p^T do, dk += ds^T q; the GQA
    group summed at the end."""
    if split is None:
        split = q.dtype == torch.float32
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    kf, vf = _expand(k, group), _expand(v, group)
    qf, dof = q.float(), do.float()
    mask = attention_mask(S, S, kv_len, causal=causal, window=window,
                          device=q.device)
    if kv_len is not None:
        mask = mask & (torch.arange(S)[None, :, None] < kv_len[:, None, None])
    mask_t = mask.transpose(-1, -2)[:, None]          # [key][query]
    dk = torch.zeros((B, H, S, hd))
    dv = torch.zeros((B, H, S, hd))
    for q0 in range(0, S, BQ):
        qs = slice(q0, q0 + BQ)
        s_t = _mm(kf, qf[..., qs, :].transpose(-1, -2), split) * scale
        p = torch.where(mask_t[..., qs], torch.exp(s_t - lse[:, :, None, qs]),
                        0.0)
        dp_t = _mm(vf, dof[..., qs, :].transpose(-1, -2), split)
        ds = p * (dp_t - delta[:, :, None, qs]) * scale
        dv = dv + _mm(p, dof[..., qs, :], split)
        dk = dk + _mm(ds, qf[..., qs, :], split)
    dk = dk.reshape(B, Hkv, group, S, hd).sum(2)
    dv = dv.reshape(B, Hkv, group, S, hd).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# held against the JAX reference
# ---------------------------------------------------------------------------

def _case_inputs(case, seed=0):
    """numpy q, k, v, do (do zero on padded rows) and lengths, as (jax,
    torch) pairs with the same values."""
    B, S, H, Hkv, hd, causal, window, dtype, lens = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd),
                      (B, H, S, hd))]
    if lens == "drawn":
        lens = [int(x) for x in np.random.default_rng(0).integers(
            S // 3, S + 1, B)]
    valid = (np.arange(S)[None, :] < np.asarray(lens or [S] * B)[:, None])
    arrs[3] = arrs[3] * valid[:, None, :, None]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs], lens)


def _rows(x, lens, S):
    """Rows below each sequence's length, stacked, as fp32 numpy."""
    x = np.asarray(torch.as_tensor(np.asarray(x, np.float32)))
    return np.concatenate([x[b, :, :L].reshape(-1, x.shape[-1]) for b, L in
                           enumerate(lens or [S] * x.shape[0])])


def _excess(got, want, rtol, atol):
    """max over elements of |got - want| / (atol + rtol |want|): at most
    1 inside the tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def _lse_reference(q, k, kv_len, causal, window):
    B, H, S, hd = q.shape
    kf = _expand(k, H // k.shape[1]).double()
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kf) / math.sqrt(hd)
    mask = attention_mask(S, S, kv_len, causal=causal, window=window,
                          device=q.device)[:, None]
    return torch.logsumexp(s.masked_fill(~mask, -math.inf), -1)


def _fwd_excess(case, split=None):
    B, S, H, Hkv, hd, causal, window, dtype, _ = case
    (jq, jk, jv, _), (q, k, v, _), lens = _case_inputs(case)
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    want = jax_reference(jq, jk, jv, causal=causal, window=window,
                         kv_len=None if lens is None else jnp.asarray(lens))
    o, lse = flash_fwd_tc_emulated(q, k, v, kvl, causal, window, split)
    lse_want = _lse_reference(q, k, kvl, causal, window)
    return (_excess(_rows(o.float(), lens, S), _rows(want, lens, S),
                    *TOL[dtype]["fwd"]),
            _excess(_rows(lse[..., None], lens, S),
                    _rows(lse_want[..., None].float(), lens, S), *LSE_TOL))


@pytest.mark.parametrize("case", TC_CASES)
def test_flash_fwd_tc_arithmetic_matches_reference(case):
    o_x, lse_x = _fwd_excess(case)
    assert o_x <= 1.0 and lse_x <= 1.0, (o_x, lse_x)


def test_flash_fwd_wgmma_row_of_length_0():
    """Beside a row of length 0 the other rows hold the forward's
    tolerance, and that row's o is exactly 0 with a finite lse, as
    ``check_case`` requires of the kernel on the card."""
    o_x, lse_x = _fwd_excess(WGMMA_EMPTY_ROW)
    assert o_x <= 1.0 and lse_x <= 1.0, (o_x, lse_x)
    _, (q, k, v, _), lens = _case_inputs(WGMMA_EMPTY_ROW)
    o, lse = flash_fwd_tc_emulated(q, k, v, torch.tensor(lens), True, 0)
    assert not o[2].any() and torch.isfinite(lse[2]).all()


def _bwd_case(case):
    """The backward's inputs as the kernels get them (o, lse from the
    emulated forward, delta = rowsum(do o)), the lengths, and ``jax.vjp``
    of the reference with the same cotangent: (dq, dk, dv)."""
    B, S, H, Hkv, hd, causal, window, dtype, _ = case
    (jq, jk, jv, jdo), (q, k, v, do), lens = _case_inputs(case)
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    jlens = None if lens is None else jnp.asarray(lens)
    _, vjp = jax.vjp(lambda a, b, c: jax_reference(
        a, b, c, causal=causal, window=window, kv_len=jlens), jq, jk, jv)
    want = [np.asarray(w, np.float32) for w in vjp(jdo)]
    o, lse = flash_fwd_tc_emulated(q, k, v, kvl, causal, window)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, do, lse, delta, kvl, causal, window), lens, want


def _dq_excess(case, split=None):
    """dq of the emulated kernel against ``jax.vjp`` of the reference, on
    the rows below each length, as ``_excess``."""
    args, lens, (want_dq, _, _) = _bwd_case(case)
    dq = flash_dq_tc_emulated(*args, split)
    S, dtype = case[1], case[7]
    return _excess(_rows(dq.float(), lens, S), _rows(want_dq, lens, S),
                   *TOL[dtype]["bwd"])


def _dkv_excess(case, split=None):
    """dk, dv of the emulated kernel, from the emulated forward's o and
    lse, against ``jax.vjp`` of the reference with the same cotangent,
    as ``_excess``; and whether dk and dv are exactly 0 past each
    length."""
    args, lens, (_, want_dk, want_dv) = _bwd_case(case)
    dk, dv = flash_dkv_tc_emulated(*args, split)
    rtol, atol = TOL[case[7]]["bwd"]
    excess = [_excess(got.float().numpy(), want, rtol, atol)
              for got, want in ((dk, want_dk), (dv, want_dv))]
    zero_past = all(not dk[b, :, L:].any() and not dv[b, :, L:].any()
                    for b, L in enumerate(lens or []))
    return excess, zero_past


@pytest.mark.parametrize("case", TC_CASES)
def test_flash_dq_tc_arithmetic_matches_reference(case):
    """dq within the backward tolerance on the rows below each length."""
    dq_x = _dq_excess(case)
    assert dq_x <= 1.0, dq_x


@pytest.mark.parametrize("case", TC_CASES)
def test_flash_dkv_tc_arithmetic_matches_reference(case):
    """dk, dv within the backward tolerance, exactly 0 past each
    length."""
    (dk_x, dv_x), zero_past = _dkv_excess(case)
    assert dk_x <= 1.0 and dv_x <= 1.0, (dk_x, dv_x)
    assert zero_past


def test_flash_tc_hi_lo_split_is_what_keeps_fp32():
    """At the main width (one bert head, S = 416, hd 64, L = 338) the
    forward, the dq and the dk/dv kernel without the lo halves leave the
    fp32 tolerance; with the hi/lo split they stay well inside it.  The
    dq and dk/dv cases take the split forward's o and lse, so only their
    own products lose the lo halves."""
    with_split = _fwd_excess(MAIN_HEAD, split=True)
    without = _fwd_excess(MAIN_HEAD, split=False)
    assert max(with_split) < 0.5 < 1.0 < without[0], (with_split, without)
    (with_split, _), (without, _) = (_dkv_excess(MAIN_HEAD, split=s)
                                     for s in (True, False))
    assert max(with_split) < 0.5 < 1.0 < min(without), (with_split, without)
    with_split, without = (_dq_excess(MAIN_HEAD, split=s)
                           for s in (True, False))
    assert with_split < 0.5 < 1.0 < without, (with_split, without)


# ---------------------------------------------------------------------------
# dispatch on CUDA tensors: each entry point launches its own kernel and
# count, or raises; none hands a call to another (mocked library)
# ---------------------------------------------------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so the wrapper
    takes its kernel route on a machine without a GPU."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


class _FakeLib:
    """Stands in for the ctypes library: records calls, returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return self.err
        return launch


@pytest.fixture
def fake_lib(monkeypatch):
    def install(err):
        lib = _FakeLib(err)
        monkeypatch.setattr(fa, "library", lambda: lib)
        monkeypatch.setattr(fa, "_stream_handle", lambda device: 0)
        monkeypatch.setattr(
            fa, "_alloc",
            lambda shape, dtype, device: torch.full(
                shape, float("nan"), dtype=dtype).as_subclass(_FakeCuda))
        return lib
    return install


def _fake_inputs(dtype="float32", hd=64, H=4, Hkv=2):
    _, (q, k, v, do), _ = _case_inputs((2, 96, H, Hkv, hd, True, 0, dtype,
                                        None))
    B, H, S, _ = q.shape
    lse = torch.zeros((B, H, S))
    delta = torch.zeros((B, H, S))
    lens = torch.tensor([50, 96], dtype=torch.int32)
    return [t.as_subclass(_FakeCuda) for t in (q, k, v, do, lse, delta, lens)]


def _count_changes(before):
    return {k: v - before[k] for k, v in ops.LAUNCHES.items()
            if v != before[k]}


# entry point -> (C function, pointer arguments)
ENTRIES = {"flash_fwd": ("flash_fwd", 6), "flash_fwd_fma": ("flash_fwd_fma", 6),
           "flash_bwd_dq": ("flash_bwd_dq", 8),
           "flash_bwd_dq_fma": ("flash_bwd_dq_fma", 8),
           "flash_bwd_dkv": ("flash_bwd_dkv", 9),
           "flash_bwd_dkv_fma": ("flash_bwd_dkv_fma", 9)}


def _call(name, q, k, v, do, lse, delta, lens, causal=True, window=0):
    fn = getattr(fa, name)
    if name.startswith("flash_fwd"):
        return fn(q, k, v, lens, causal, window)
    return fn(q, k, v, do, lse, delta, lens, causal, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,hd", [
    (name, hd) for name in ENTRIES
    for hd in (fa.FMA_HEAD_DIMS if name.endswith("_fma") else fa.HEAD_DIMS)])
def test_flash_entry_launches_its_kernel_and_count(fake_lib, name, hd, dtype):
    """Every entry point, at every head dim (the tensor-core kernels'
    ``HEAD_DIMS``, the FMA kernels' ``FMA_HEAD_DIMS``) and dtype it
    takes, launches its own C function once with the case's integers,
    adds one to its own count only, and returns the kernel's
    buffers."""
    lib = fake_lib(0)
    q, k, v, do, lse, delta, lens = _fake_inputs(dtype, hd)
    before = dict(ops.LAUNCHES)
    out = _call(name, q, k, v, do, lse, delta, lens, True, 32)
    c_name, n_ptrs = ENTRIES[name]
    assert [c[0] for c in lib.calls] == [c_name]
    args = lib.calls[0][1]
    assert args[n_ptrs:n_ptrs + 7] == (2, 4, 2, 96, hd, 1, 32)
    assert args[n_ptrs + 7] == pytest.approx(1 / math.sqrt(hd))
    assert args[n_ptrs + 8] == {"float32": 0, "bfloat16": 1}[dtype]
    assert _count_changes(before) == {c_name: 1}
    for t in (out if isinstance(out, tuple) else (out,)):
        assert torch.isnan(t.as_subclass(torch.Tensor).float()).all()


@pytest.mark.parametrize("entry,which", [("flash_fwd", 0), ("flash_bwd_dq", 1),
                                         ("flash_bwd_dkv", 2)])
def test_kernel_config_asks_for_the_entry_points_kernel(fake_lib, entry,
                                                         which,
                                                         monkeypatch):
    """``kernel_config`` asks the library for the launch configuration of
    the kernel an entry point runs (its index, the head dim, the dtype
    code), launches nothing, and raises when the library refuses.  In
    bf16 at 256 every entry point, the forward included, runs a wgmma
    kernel of 256 threads; in fp32 at 256 an mma.sync kernel of 128.  A
    library that reports another thread count is refused."""
    lib = fake_lib(0)

    def config(which, hd, dtype, info, threads={1: 256, 0: 128}):
        lib.calls.append(("flash_kernel_config", (which, hd, dtype, info)))
        info[0], info[1], info[2], info[3] = threads[dtype], 197672, 200, 0
        return 0
    monkeypatch.setattr(lib, "flash_kernel_config", config, raising=False)
    before = dict(ops.LAUNCHES)
    got = fa.kernel_config(entry, 256, torch.bfloat16)
    assert [c[0] for c in lib.calls] == ["flash_kernel_config"]
    assert lib.calls[0][1][:3] == (which, 256, 1)
    assert got == {"threads": 256, "smem": 197672, "regs": 200, "local": 0}
    assert got["threads"] == fa.WGMMA_THREADS
    assert fa.kernel_config(entry, 256, torch.float32)["threads"] == 128
    assert ops.LAUNCHES == before
    monkeypatch.setattr(lib, "flash_kernel_config",
                        lambda *a: config(*a, threads={1: 128, 0: 128}))
    with pytest.raises(RuntimeError, match="128 threads, not 256"):
        fa.kernel_config(entry, 256, torch.bfloat16)
    fake_lib(1)
    with pytest.raises(RuntimeError, match="flash_kernel_config"):
        fa.kernel_config(entry, 256, torch.bfloat16)


@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("name", [n for n in ENTRIES if n.endswith("_fma")])
def test_flash_fma_entry_refuses_head_dims_80_and_256(fake_lib, name, hd):
    """The FMA kernels are not built at 80 or 256: their entry points
    raise before any launch, and count nothing."""
    lib = fake_lib(0)
    ins = _fake_inputs("float32", hd)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match=f"head dim {hd}"):
        _call(name, *ins)
    assert lib.calls == [] and ops.LAUNCHES == before


def test_flash_bwd_and_autograd_use_the_tensor_core_dkv_kernel(fake_lib):
    """``flash_bwd`` and the backward of ``FlashAttention`` launch the
    tensor-core dq and dk/dv kernels, never the FMA kernels."""
    lib = fake_lib(0)
    q, k, v, do, lse, delta, lens = _fake_inputs()
    before = dict(ops.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, lens, True, 0)
    fa.flash_bwd(q, k, v, o, lse, do, lens, True, 0)
    assert [c[0] for c in lib.calls] == ["flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv"]
    assert _count_changes(before) == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                      "flash_bwd_dkv": 1}
    lib.calls.clear()
    before = dict(ops.LAUNCHES)
    ctx = SimpleNamespace(saved_tensors=(q, k, v, o, lse, lens),
                          causal=True, window=0)
    fa.FlashAttention.backward(ctx, do)
    assert [c[0] for c in lib.calls] == ["flash_bwd_dq", "flash_bwd_dkv"]
    assert _count_changes(before) == {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_flash_failed_launch_raises_and_never_tries_another(fake_lib, name):
    lib = fake_lib(1)                                # cudaErrorInvalidValue
    q, k, v, do, lse, delta, lens = _fake_inputs()
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match=f"{ENTRIES[name][0]} launch "
                                           f"failed"):
        _call(name, q, k, v, do, lse, delta, lens)
    assert [c[0] for c in lib.calls] == [ENTRIES[name][0]]
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_flash_tensor_core_entry_gets_16_byte_aligned_inputs(fake_lib, name):
    """The tensor-core kernels read 16-byte pieces: a contiguous view off
    16-byte alignment reaches them as an aligned copy of equal values."""
    lib = fake_lib(0)
    q, k, v, do, lse, delta, lens = _fake_inputs()
    flat = torch.zeros(k.numel() + 1).as_subclass(_FakeCuda)
    k_off = flat[1:].view(k.shape)                  # 4 bytes off alignment
    k_off.copy_(k)
    assert k_off.data_ptr() % 16
    _call(name, q, k_off, v, do, lse, delta, lens)
    ptrs = lib.calls[0][1][:ENTRIES[name][1]]
    assert all(p % 16 == 0 for i, p in enumerate(ptrs) if i != 3 or
               name != "flash_fwd")
    assert k_off.data_ptr() not in ptrs


@pytest.mark.parametrize("name", list(ENTRIES))
def test_flash_entry_on_cpu_and_meta_never_launches(fake_lib, name):
    """A CPU tensor takes the plain version (the FMA entry points' too),
    a ``meta`` tensor gets ``meta`` outputs; neither launches."""
    lib = fake_lib(0)
    ins = [t.as_subclass(torch.Tensor) for t in _fake_inputs(hd=32)]
    q, k, v, do, lse, delta, lens = ins
    before = dict(ops.LAUNCHES)
    got = _call(name, *ins)
    plain = {"flash_fwd": fa.flash_fwd_plain, "flash_fwd_fma":
             fa.flash_fwd_plain}.get(name)
    if plain is not None:
        want = plain(q, k, v, lens, True, 0)
    elif name.startswith("flash_bwd_dq"):
        want = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, lens, True, 0)
    else:
        want = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, lens, True, 0)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in ins]
    out = _call(name, *meta)
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.device.type == "meta"
    assert lib.calls == [] and ops.LAUNCHES == before
