"""The port's kernels (flash attention, the SSD chunk scan, the DMA copy)
against the reference's oracles.

The same numpy inputs go through ``repro.kernels.ref.flash_attention_reference``
(and ``jax.grad`` of it) and through the port's plain versions and its
``FlashAttention`` function on CPU tensors.  The reference's Pallas
kernels cannot run on this jax (``pl.load`` is gone), so its pure-jnp
oracle is the reference here.  Comparisons are on rows below
``kv_len``: rows past it are unspecified for the kernels.

Tolerances (the reference suite's own): fp32 forward rtol 2e-4 / atol
2e-5 (fp32 sums in another order); gradients rtol 2e-3 / atol 2e-4
(the backward recombines exp(s - lse) terms); bf16 3e-2 (one bf16
rounding of the output).
"""
import importlib.util
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.offload_dma import dma_copy as jax_dma_copy
from repro.kernels.ref import flash_attention_reference as jax_reference
from repro.kernels.ref import ssd_reference as jax_ssd_reference
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import offload_dma as dma
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import flash_attention_reference, ssd_reference
from repro_torch.models import mamba2 as TM

import jax

torch.backends.cuda.matmul.allow_tf32 = False

# tests/test_kernels.py FLASH_CASES: (B, S, H, Hkv, hd, causal, window, dtype)
FLASH_CASES = [
    (1, 64, 2, 2, 32, True, 0, "float32"),
    (2, 128, 4, 2, 64, True, 0, "float32"),
    (1, 256, 8, 1, 32, True, 0, "float32"),     # extreme GQA
    (1, 96, 4, 4, 32, True, 32, "float32"),     # sliding window
    (2, 128, 4, 2, 64, True, 64, "float32"),
    (1, 128, 2, 2, 32, False, 0, "float32"),    # bidirectional
    (1, 128, 4, 2, 64, True, 0, "bfloat16"),
    (1, 80, 2, 2, 16, True, 0, "float32"),      # non-tile-multiple S
]
# tests/test_ragged.py RAGGED_FLASH_CASES: (B, S, H, Hkv, hd, causal, window)
RAGGED_FLASH_CASES = [
    (2, 96, 4, 2, 32, True, 0),
    (2, 96, 4, 4, 32, True, 32),
    (2, 128, 8, 1, 16, True, 0),
    (2, 96, 2, 2, 32, False, 0),
]
# tests/test_kernels.py GRAD_CASES: (B, S, H, Hkv, hd, causal, window)
GRAD_CASES = [
    (1, 64, 2, 2, 32, True, 0),
    (2, 96, 4, 2, 16, True, 0),
    (1, 128, 2, 2, 32, True, 32),
    (1, 64, 4, 1, 16, False, 0),
]


def _tol(dtype):
    return (dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16"
            else dict(rtol=2e-4, atol=2e-5))


def _inputs(B, S, H, Hkv, hd, dtype="float32", seed=0):
    """q (B,H,S,hd), k, v (B,Hkv,S,hd) as (jax, torch) pairs holding the
    same values (bf16 rounds to nearest-even in both)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _valid_rows(x, lens):
    """Rows below each sequence's length, stacked: (sum(lens) * H, hd)."""
    x = np.asarray(x, np.float32)
    return np.concatenate([x[b, :, :L].reshape(-1, x.shape[-1])
                           for b, L in enumerate(lens)])


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_matches_reference(case):
    B, S, H, Hkv, hd, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, hd, dtype)
    ref = np.asarray(jax_reference(jq, jk, jv, causal=causal, window=window),
                     np.float32)
    plain, lse = fa.flash_fwd_plain(q, k, v, None, causal, window)
    func = ops.FlashAttention.apply(q, k, v, None, causal, window)
    oracle = flash_attention_reference(q, k, v, causal=causal, window=window)
    for out in (plain, func, oracle):
        assert out.dtype == q.dtype
        np.testing.assert_allclose(out.float().numpy(), ref, **_tol(dtype))
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32


@pytest.mark.parametrize("case", RAGGED_FLASH_CASES)
def test_flash_ragged_forward_matches_reference(case):
    B, S, H, Hkv, hd, causal, window = case
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, hd)
    lens = np.random.default_rng(0).integers(S // 3, S + 1, B)
    ref = jax_reference(jq, jk, jv, causal=causal, window=window,
                        kv_len=jnp.asarray(lens, jnp.int32))
    kvl = torch.from_numpy(lens).to(torch.int32)
    plain, _ = fa.flash_fwd_plain(q, k, v, kvl, causal, window)
    func = ops.FlashAttention.apply(q, k, v, kvl, causal, window)
    for out in (plain, func):
        np.testing.assert_allclose(_valid_rows(out.numpy(), lens),
                                   _valid_rows(ref, lens),
                                   rtol=2e-4, atol=2e-5)


def _grads_vs_reference(B, S, H, Hkv, hd, causal, window, lens=None):
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, hd)
    wm = (np.ones((B, S), np.float32) if lens is None else
          (np.arange(S)[None, :] < np.asarray(lens)[:, None]).astype(
              np.float32))
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)

    def f_ref(q_, k_, v_):
        o = jax_reference(q_, k_, v_, causal=causal, window=window,
                          kv_len=jlens)
        return ((o * wm[:, None, :, None]) ** 2).sum()

    ref = jax.grad(f_ref, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    o = ops.FlashAttention.apply(q, k, v, kvl, causal, window)
    ((o * torch.from_numpy(wm)[:, None, :, None]) ** 2).sum().backward()
    for name, a, b in zip("qkv", (q.grad, k.grad, v.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-4, err_msg=f"d{name}")
    return k.grad, v.grad


@pytest.mark.parametrize("case", GRAD_CASES)
def test_flash_backward_matches_reference_grad(case):
    _grads_vs_reference(*case)


def test_flash_ragged_backward_matches_reference_grad():
    """tests/test_ragged.py::test_flash_ragged_backward_matches_reference:
    grads through the masked function == grads of the length-masked
    oracle, and keys/values past the true length get exactly zero."""
    dk, dv = _grads_vs_reference(2, 96, 4, 2, 32, True, 0, lens=[50, 77])
    assert float(dk[0, :, 50:].abs().max()) == 0.0
    assert float(dv[1, :, 77:].abs().max()) == 0.0


def test_flash_residuals_are_linear_in_seq():
    """The function saves (q, k, v, o, lse) — O(S) — and on ``meta``
    tensors returns outputs of the kernel's shapes without computing."""
    def resid_bytes(S):
        q = torch.empty((1, 2, S, 32), device="meta", requires_grad=True)
        k = torch.empty((1, 2, S, 32), device="meta")
        v = torch.empty((1, 2, S, 32), device="meta")
        saved = {}

        def pack(t):
            saved[t.untyped_storage()._cdata] = (t, t.untyped_storage().nbytes())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            o = ops.FlashAttention.apply(q, k, v, None, True, 0)
        assert o.device.type == "meta" and o.shape == q.shape
        shapes = sorted(tuple(t.shape) for t, _ in saved.values())
        assert shapes == sorted([(1, 2, S, 32)] * 4 + [(1, 2, S)])
        return sum(nb for _, nb in saved.values())
    r128, r256 = resid_bytes(128), resid_bytes(256)
    assert r256 <= 2.05 * r128


def test_flash_plain_versions_agree_with_oracle_on_lse():
    """The plain forward's lse is the log-sum-exp of the masked scores,
    the quantity the plain (and CUDA) backward recomputes p from."""
    (_, _, _), (q, k, v) = _inputs(2, 96, 4, 2, 32)
    lens = torch.tensor([40, 96], dtype=torch.int32)
    _, lse = fa.flash_fwd_plain(q, k, v, lens, True, 0)
    kq = k.repeat_interleave(2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kq) / math.sqrt(32)
    qpos = torch.arange(96)[:, None]
    kpos = torch.arange(96)[None, :]
    mask = (qpos >= kpos)[None] & (kpos[None] < lens[:, None, None])
    want = torch.logsumexp(s.masked_fill(~mask[:, None], float("-inf")), -1)
    for b, L in enumerate(lens.tolist()):
        np.testing.assert_allclose(lse[b, :, :L].numpy(),
                                   want[b, :, :L].numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# a CUDA tensor launches the kernel or raises — never the plain version
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
def fake_cuda(monkeypatch):
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


def _fake_qkv():
    (_, _, _), ts = _inputs(1, 64, 2, 2, 16)
    lens = torch.tensor([40], dtype=torch.int32)
    return [t.as_subclass(_FakeCuda) for t in ts + [lens]]


def test_cuda_tensor_launches_kernel_not_plain(fake_cuda):
    lib = fake_cuda(0)
    q, k, v, lens = _fake_qkv()
    before = dict(ops.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, lens, True, 0)
    assert [c[0] for c in lib.calls] == ["flash_fwd"]
    args = lib.calls[0][1]
    assert args[6:11] == (1, 2, 2, 64, 16)          # B, H, Hkv, S, hd
    assert args[6 + 5:6 + 7] == (1, 0)              # causal, window
    assert ops.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    # the outputs are the kernel's buffers (untouched by the fake launch),
    # not the plain version's result
    assert torch.isnan(o.as_subclass(torch.Tensor)).all()
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, q, lens, True, 0)
    assert [c[0] for c in lib.calls[1:]] == ["flash_bwd_dq", "flash_bwd_dkv"]
    assert ops.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert ops.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1


def test_cuda_tensor_failed_launch_raises(fake_cuda):
    fake_cuda(1)                                    # cudaErrorInvalidValue
    q, k, v, lens = _fake_qkv()
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_fwd launch failed"):
        fa.flash_fwd(q, k, v, lens, True, 0)
    assert ops.LAUNCHES == before


def test_cuda_wrapper_rejects_bad_operands(fake_cuda):
    fake_cuda(0)
    q, k, v, lens = _fake_qkv()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                     v, lens, True, 0)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q, k.double(), v, lens, True, 0)


# ---------------------------------------------------------------------------
# the SSD chunk scan (K4): plain version, SSDScan, routing
# ---------------------------------------------------------------------------
#
# The reference's Pallas SSD kernel cannot run on this jax either, so the
# port is held against ``repro.kernels.ref.ssd_reference`` (the
# sequential recurrence) and ``repro.models.mamba2.ssd_chunked``.
# Tolerances are the reference suite's (tests/test_kernels.py): fp32
# 1e-3 (sums in another order), bf16 rtol 2e-2 / atol 2e-1 (one bf16
# rounding of y).

# tests/test_kernels.py SSD_CASES: (B, S, H, P, N, chunk, dtype)
SSD_CASES = [
    (1, 64, 2, 16, 8, 16, "float32"),
    (2, 128, 4, 32, 16, 32, "float32"),
    (1, 100, 2, 16, 8, 32, "float32"),          # padding path
    (1, 128, 1, 64, 32, 64, "float32"),
    (1, 64, 2, 16, 8, 16, "bfloat16"),
]


def _ssd_inputs(B, S, H, P, N, dtype="float32", seed=0):
    """(x, dt, A, Bm, Cm) as (jax, torch) lists with the same values: the
    reference test's distributions, drawn with numpy; dt has x's dtype
    and A is fp32, as there."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    arrs = (x, dt, A, Bm, Cm)
    return ([jnp.asarray(a).astype(jnp.float32 if i == 2 else jdt)
             for i, a in enumerate(arrs)],
            [torch.from_numpy(a).to(torch.float32 if i == 2 else tdt)
             for i, a in enumerate(arrs)])


def _ssd_tol(dtype):
    return (dict(rtol=2e-2, atol=2e-1) if dtype == "bfloat16"
            else dict(rtol=1e-3, atol=1e-3))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_reference(case):
    B, S, H, P, N, chunk, dtype = case
    jin, tin = _ssd_inputs(B, S, H, P, N, dtype)
    want, _ = jax_ssd_reference(*jin)
    want = np.asarray(want, np.float32)
    for got in (ssd.ssd_scan_plain(*tin), ops.ssd_scan(*tin, chunk=chunk),
                ssd_reference(*tin)[0]):
        assert got.dtype == tin[0].dtype and got.shape == tin[0].shape
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **_ssd_tol(dtype))


@pytest.mark.parametrize("chunks_per_block", [1, 2])
def test_ssd_ragged_matches_reference_at_true_lengths(chunks_per_block):
    """tests/test_ragged.py::test_ssd_ragged_matches_reference_at_true_lengths:
    with lengths, each sequence's valid rows equal the reference run on
    the unpadded sequence."""
    B, S, H, P, N, chunk = 2, 96, 2, 16, 8, 16
    jin, tin = _ssd_inputs(B, S, H, P, N)
    lens = [40, 77]
    y = ops.ssd_scan(*tin, torch.tensor(lens, dtype=torch.int32),
                     chunk=chunk, chunks_per_block=chunks_per_block)
    for b, L in enumerate(lens):
        yr, _ = jax_ssd_reference(jin[0][b:b + 1, :L], jin[1][b:b + 1, :L],
                                  jin[2], jin[3][b:b + 1, :L],
                                  jin[4][b:b + 1, :L])
        np.testing.assert_allclose(y[b:b + 1, :L].numpy(), np.asarray(yr),
                                   rtol=1e-3, atol=1e-3)


def test_ssd_ragged_bitwise_matches_unpadded():
    """tests/test_ragged.py::test_ssd_ragged_bitwise_matches_unpadded_kernel,
    on the plain route: a padded batch with lengths gives the unpadded
    result bit for bit on the valid rows."""
    _, (x, dt, A, Bm, Cm) = _ssd_inputs(1, 96, 2, 16, 8)
    L = 32
    padded = ops.ssd_scan(x, dt, A, Bm, Cm, torch.full((1,), L,
                                                       dtype=torch.int32),
                          chunk=16)
    exact = ops.ssd_scan(x[:, :L], dt[:, :L], A, Bm[:, :L], Cm[:, :L],
                         chunk=16)
    assert torch.equal(padded[:, :L], exact)


def test_ssd_scan_grads_match_jax_grad_of_chunked():
    """``SSDScan``'s gradients (plain forward, ``ssd_chunked`` backward)
    against ``jax.grad`` of the reference's ``ssd_chunked`` with dt
    masked past the lengths, the reference's training formulation.  Both
    differentiate the same fp32 algorithm: rtol 1e-4, atol 1e-5."""
    B, S, H, P, N, chunk = 2, 100, 2, 16, 8, 32
    jin, tin = _ssd_inputs(B, S, H, P, N, seed=3)
    lens = np.array([61, 100], np.int32)
    dy = np.random.default_rng(4).standard_normal((B, S, H, P)).astype(
        np.float32)
    valid = np.arange(S)[None, :, None] < lens[:, None, None]

    def f_ref(x, dt, A, Bm, Cm):
        y, _ = jax_ssd_chunked(x, jnp.where(valid, dt, 0.0), A, Bm, Cm, chunk)
        return (y * dy).sum()
    want = jax.grad(f_ref, argnums=(0, 1, 2, 3, 4))(*jin)
    ins = [t.requires_grad_() for t in tin]
    y = ops.ssd_scan(*ins, torch.from_numpy(lens), chunk=chunk)
    (y * torch.from_numpy(dy)).sum().backward()
    for name, t, w in zip(("x", "dt", "A", "B", "C"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_ssd_residuals_are_linear_in_seq():
    """``SSDScan`` saves its inputs only — O(S) — and on ``meta`` tensors
    returns an output of the kernel's shape without computing."""
    def resid_bytes(S):
        H, P, N = 4, 16, 8
        x = torch.empty((1, S, H, P), device="meta", requires_grad=True)
        dt = torch.empty((1, S, H), device="meta", requires_grad=True)
        A = torch.empty((H,), device="meta")
        Bm = torch.empty((1, S, N), device="meta")
        Cm = torch.empty((1, S, N), device="meta")
        saved = {}

        def pack(t):
            saved[t.untyped_storage()._cdata] = (t, t.untyped_storage().nbytes())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
        assert y.device.type == "meta" and y.shape == x.shape
        shapes = sorted(tuple(t.shape) for t, _ in saved.values())
        assert shapes == sorted([(1, S, H, P), (1, S, H), (H,), (1, S, N),
                                 (1, S, N)])
        return sum(nb for _, nb in saved.values())
    r128, r256 = resid_bytes(128), resid_bytes(256)
    assert r256 <= 2.05 * r128


# ---------------------------------------------------------------------------
# K4's tensor-core arithmetic, emulated in plain PyTorch
# ---------------------------------------------------------------------------
#
# ``csrc/ssd_scan.cu``'s tensor-core kernel takes bf16 x, B, C, multiplies
# bf16 operands with fp32 accumulation, computes C B^T once per (b,
# chunk) for its whole head group, and splits each fp32 operand (the
# weights w, the carried state, the decayed x) into bf16 hi + lo, issuing
# two products.  ``_tc_emulated`` repeats that arithmetic chunk by chunk
# in the kernel's order; it is held against the reference at
# ``chip_smoke.py``'s SSD_TOL: fp32 (rtol 1e-3, atol 1e-3) for the
# unrounded y on the same bf16-valued inputs (what the hi/lo split
# loses), bf16 (rtol 2e-2, atol 2e-1) once y is rounded to bf16 (what
# the kernel stores).
SSD_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
           "bfloat16": dict(rtol=2e-2, atol=2e-1)}


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tc_emulated(x, dt, A, Bm, Cm, kv_len, chunk, split=True):
    """y (fp32) of the tensor-core kernel's arithmetic; ``split=False``
    drops the lo halves (one bf16 rounding of each fp32 operand)."""
    def hi_lo(t):
        hi = _bf16(t)
        return (hi, _bf16(t - hi)) if split else (hi, torch.zeros_like(t))
    Bt, S, H, P = x.shape
    pad = (-S) % chunk
    x, Bm, Cm = (F.pad(_bf16(t), (0, 0) * (t.dim() - 2) + (0, pad))
                 for t in (x, Bm, Cm))
    lens = [S] * Bt if kv_len is None else [int(v) for v in kv_len]
    dt = F.pad(TM.mask_dt(dt.float(), torch.tensor(lens)), (0, 0, 0, pad))
    Q = chunk
    y = torch.zeros(x.shape)
    tril = torch.ones(Q, Q, dtype=torch.bool).tril()
    for b, L in enumerate(lens):
        state = torch.zeros(H, P, Bm.shape[-1])
        for c in range(-(-L // Q)):                 # chunks past L skipped
            sl = slice(c * Q, (c + 1) * Q)
            Cc, Bc, xc, d = Cm[b, sl], Bm[b, sl], x[b, sl], dt[b, sl]
            cb = Cc @ Bc.T                          # once for all heads
            la = torch.cumsum(d * A, 0)             # (Q, H)
            Lm = torch.exp(torch.where(tril[:, :, None],
                                       la[:, None] - la[None], -math.inf))
            w_hi, w_lo = hi_lo(cb[:, :, None] * Lm * d[None])
            s_hi, s_lo = hi_lo(state)
            y_off = (torch.einsum("in,hpn->ihp", Cc, s_hi)
                     + torch.einsum("in,hpn->ihp", Cc, s_lo))
            y[b, sl] = (y_off * torch.exp(la)[..., None]
                        + torch.einsum("ijh,jhp->ihp", w_hi, xc)
                        + torch.einsum("ijh,jhp->ihp", w_lo, xc))
            xd_hi, xd_lo = hi_lo(xc * (torch.exp(la[-1] - la) * d)[..., None])
            state = (state * torch.exp(la[-1])[:, None, None]
                     + torch.einsum("jhp,jn->hpn", xd_hi, Bc)
                     + torch.einsum("jhp,jn->hpn", xd_lo, Bc))
    return y[:, :S]


# the reference's SSD cases, hymba's SSD heads (P = 50, N = 16: the
# kernel pads P to 64 in shared memory, which the arithmetic never sees)
# at one head group with a ragged length and at two groups, B 2, and
# last one mamba2 head group of the main path's width with a ragged
# length: (B, S, H, P, N, chunk, lens)
TC_CASES = list(dict.fromkeys(c[:6] + (None,) for c in SSD_CASES)) + [
    (1, 448, 4, 50, 16, 64, [390]), (2, 256, 8, 50, 16, 64, None),
    (1, 448, 4, 64, 128, 64, [390])]


def _tc_case_inputs(case):
    B, S, H, P, N, chunk, lens = case
    (jx, jdt, jA, jB, jC), (x, dt, A, Bm, Cm) = _ssd_inputs(B, S, H, P, N)
    # the kernel's operands are bf16: both sides see the same rounded x, B, C
    jx, jB, jC = (jnp.asarray(_bf16(t).numpy()) for t in (x, Bm, Cm))
    x, Bm, Cm = (_bf16(t) for t in (x, Bm, Cm))
    kvl = None if lens is None else np.asarray(lens, np.int32)
    return (jx, jdt, jA, jB, jC), (x, dt, A, Bm, Cm), kvl


def _valid(y, S, lens):
    y = np.asarray(y, np.float32)
    return np.concatenate([y[b, :L].reshape(-1)
                           for b, L in enumerate(lens or [S] * y.shape[0])])


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_arithmetic_matches_reference(case):
    B, S, H, P, N, chunk, lens = case
    (jx, jdt, jA, jB, jC), tin, kvl = _tc_case_inputs(case)
    valid = (np.arange(S)[None, :, None]
             < (np.full(B, S) if kvl is None else kvl)[:, None, None])
    want_chunked, _ = jax_ssd_chunked(jx, jnp.where(valid, jdt, 0.0), jA, jB,
                                      jC, chunk)
    want_seq, _ = jax_ssd_reference(
        jx, jdt, jA, jB, jC, kv_len=None if kvl is None else jnp.asarray(kvl))
    got = _tc_emulated(*tin, None if kvl is None else torch.from_numpy(kvl),
                       chunk)
    for want in (want_chunked, want_seq):
        np.testing.assert_allclose(_valid(got, S, lens), _valid(want, S, lens),
                                   **SSD_TOL["float32"])
        np.testing.assert_allclose(
            _valid(got.to(torch.bfloat16).float(), S, lens),
            _valid(want, S, lens), **SSD_TOL["bfloat16"])


# hymba's head group at the main width (P = 50, N = 16)
HYMBA_TC_CASE = TC_CASES[-3]


def _split_errors(case):
    """Max abs error on the valid rows against the JAX recurrence, with
    the hi/lo split (True) and without (False)."""
    S, chunk, lens = case[1], case[5], case[6]
    (jx, jdt, jA, jB, jC), tin, kvl = _tc_case_inputs(case)
    want, _ = jax_ssd_reference(jx, jdt, jA, jB, jC, kv_len=jnp.asarray(kvl))
    want = _valid(want, S, lens)
    lens_t = torch.from_numpy(kvl)
    return {split: np.abs(_valid(_tc_emulated(*tin, lens_t, chunk, split),
                                 S, lens) - want).max()
            for split in (True, False)}


def test_tensor_core_hi_lo_split_is_what_keeps_the_state():
    """At the main width, dropping the lo halves (one bf16 rounding of
    w, the carried state and the decayed x) leaves the fp32 tolerance;
    the hi/lo split stays well inside it."""
    err = _split_errors(TC_CASES[-1])
    assert err[True] < 1e-3 < err[False], err
    assert err[False] > 30 * err[True], err


def test_tensor_core_hi_lo_split_keeps_hymbas_state():
    """The same at hymba's SSD heads (P = 50, N = 16), whose C B^T and
    state products are one k-step each."""
    err = _split_errors(HYMBA_TC_CASE)
    assert err[True] < 1e-3 < err[False], err
    assert err[False] > 30 * err[True], err


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _split_check_passes(case, split):
    smoke = _chip_smoke()
    S, chunk, lens = case[1], case[5], case[6]
    (jx, jdt, jA, jB, jC), tin, kvl = _tc_case_inputs(case)
    want, _ = jax_ssd_reference(jx, jdt, jA, jB, jC, kv_len=jnp.asarray(kvl))
    got = _tc_emulated(*tin, torch.from_numpy(kvl), chunk, split)
    share = smoke.split_shares(
        torch.from_numpy(_valid(got, S, lens)).to(torch.bfloat16),
        torch.from_numpy(_valid(want, S, lens)).to(torch.bfloat16))
    return all(share[k] <= limit
               for k, limit in smoke.SPLIT_MAX_SHARE.items()), share


@pytest.mark.parametrize("split", [True, False])
def test_chip_smoke_split_check_tells_split_from_no_split(split):
    """``chip_smoke.py`` holds the tensor-core kernel's bf16 y against the
    FMA kernel's (fp32 throughout) by the share of outputs that differ
    and differ by more than one bf16 ulp.  On the emulated arithmetic at
    a main-width head group, against the fp32 recurrence rounded to bf16,
    the split passes those limits and the arithmetic without the lo
    halves fails them."""
    passes, share = _split_check_passes(TC_CASES[-1], split)
    assert passes == split, share


@pytest.mark.parametrize("split", [True, False])
def test_chip_smoke_split_check_holds_at_hymbas_shape(split):
    """``chip_smoke.py`` runs the same split check on K4 at hymba's
    shape (``check_ssd_hymba``): the emulated arithmetic with the split
    passes its limits there, and without the lo halves fails them."""
    passes, share = _split_check_passes(HYMBA_TC_CASE, split)
    assert passes == split, share


@pytest.mark.parametrize("family,heads,windows", [
    ("HYMBA_ARGS", (25, 5), [0, 1024]), ("GRANITE_ARGS", (16, 8), [0])])
def test_chip_smoke_flash_main_cases_cover_each_bucket(family, heads,
                                                      windows):
    """``chip_smoke.py`` holds K1-K3 at every bucket of the hymba and
    granite main paths, with that bucket's true lengths, at the family's
    heads, bf16, once for each window its layers run."""
    smoke = _chip_smoke()
    args = getattr(smoke, family)
    batches = smoke.main_path_batches(args)
    cases = smoke.flash_main_cases(args, batches)
    by_bucket = smoke.lengths_by_bucket(batches)
    want = {(8, S, *heads, 64, True, w, "bfloat16", True): lens
            for S, lens in by_bucket.items() for w in windows}
    assert cases == want
    assert len(by_bucket) > 1


@pytest.mark.parametrize("family", ["SEAMLESS_ARGS", "QWEN2VL_ARGS"])
def test_chip_smoke_flash_main_cases_cover_the_new_families(family,
                                                           monkeypatch):
    """``chip_smoke.py`` holds K1-K3 at every bucket of the seamless
    (B = 8, 16 / 16 heads x 64) and qwen2-vl (B = 4, 28 / 4 heads x 128)
    paths with that bucket's true lengths, bf16; qwen2-vl's sequence is
    its 1024 vision tokens and the bucket, ``kv_len`` its lengths plus
    1024.  (The stub inputs are left out here: the cases read only the
    tokens' buckets and lengths.)"""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "stub_inputs", lambda cfg, seed=0: {})
    args = getattr(smoke, family)
    batches = smoke.main_path_batches(args)
    cases = smoke.flash_main_cases(args, batches)
    by_bucket = smoke.lengths_by_bucket(batches)
    B, heads, hd, vt = ((8, (16, 16), 64, 0) if family == "SEAMLESS_ARGS"
                        else (4, (28, 4), 128, 1024))
    want = {(B, vt + S, *heads, hd, True, 0, "bfloat16", True):
            [vt + n for n in lens] for S, lens in by_bucket.items()}
    assert cases == want
    assert len(by_bucket) > 2
    if vt:
        assert sorted(c[1] for c in cases) == [1344, 1408, 1440, 1472]


@pytest.mark.parametrize("arch,control,limit", [
    ("seamless_m4t_large_v2", "encoder output zeroed", "SEAMLESS_LOSS_RTOL"),
    ("qwen2_vl_7b", "1-D RoPE for M-RoPE", "BF16_MODEL_RTOL")])
def test_chip_smoke_family_controls_change_the_loss_and_are_undone(
        arch, control, limit):
    """The encoder-decoder's control (the cross attention fed a zero
    encoder output) and the vision-language model's (plain RoPE over
    ``arange(S)`` for M-RoPE), on reduced models through the plain path
    (seeded weights and inputs): each moves the loss past 5 x the path's
    loss limit while it holds, and leaves every parameter and the config
    as they were after."""
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    smoke = _chip_smoke()
    cfg = get_config(arch).reduced(dtype="float32")
    lm = LM(cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in lm.named_parameters()}
    rng = np.random.default_rng(0)
    B, S = 2, 32
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    stub = smoke.stub_inputs(cfg)
    batch.update({k: torch.from_numpy(fn(B, S)) for k, fn in stub.items()})

    def loss():
        with torch.no_grad():
            return float(lm.loss(batch)[0])
    sound = loss()
    controls = smoke._controls(lm, range(cfg.num_layers))
    assert set(controls) == {"kv heads rolled", control}
    with controls[control]:
        assert abs(loss() - sound) > 5 * getattr(smoke, limit) * sound
    assert loss() == sound and lm.cfg == cfg
    for n, p in lm.named_parameters():
        assert torch.equal(p, before[n]), n


def test_chip_smoke_controls_change_the_mixer_and_are_undone():
    """The controls of ``chip_smoke.py``'s mixer check (the wrong kv
    head; hymba's SSD half skipped), on a reduced hymba through the plain
    path: each moves the mixer's output far past ``MIXER_RTOL`` while it
    holds, and leaves every parameter as it was after."""
    from repro_torch.models import hymba as HY
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    smoke = _chip_smoke()
    lm = LM(get_config("hymba_1p5b").reduced(dtype="float32"),
            device="cpu")
    before = {n: p.detach().clone() for n, p in lm.named_parameters()}
    B, S = 2, 32
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, lm.cfg.d_model)).astype(np.float32))
    positions = torch.arange(S).expand(B, S)

    def mixer():
        with torch.no_grad():
            return HY.hymba_apply(lm.blocks[0]["mixer"], lm.cfg, h,
                                  positions=positions)
    sound = mixer()
    controls = smoke._controls(lm, [0])
    assert set(controls) == {"kv heads rolled", "SSD half skipped"}
    for control in controls.values():
        with control:
            assert smoke._rel(mixer(), sound, [S] * B) > 5 * smoke.MIXER_RTOL
        assert torch.equal(mixer(), sound)
    for n, p in lm.named_parameters():
        assert torch.equal(p, before[n]), n


# ---------------------------------------------------------------------------
# the DMA copy (K5)
# ---------------------------------------------------------------------------

# tests/test_offload_exec.py::test_dma_copy_identity_including_padding_tail
DMA_CASES = [((128,), "float32"), ((33,), "float32"), ((7, 5), "bfloat16"),
             ((1,), "int32")]


@pytest.mark.parametrize("case", DMA_CASES)
def test_dma_copy_plain_matches_reference(case):
    """The plain version against the reference's kernel in interpret
    mode, at 16 elements per chunk (a zero-padded tail in all but the
    first case): identical values, shape and dtype."""
    shape, dtype = case
    n = int(np.prod(shape))
    xj = jnp.arange(n, dtype=jnp.float32).astype(dtype).reshape(shape)
    want = np.asarray(jax_dma_copy(xj, chunk_elems=16, interpret=True),
                      np.float32)
    tdt = getattr(torch, dtype)
    x = torch.arange(n, dtype=torch.float32).to(tdt).reshape(shape)
    for got in (dma.dma_copy_plain(x, 16), dma.dma_copy(x, 16),
                ops.residual_dma_copy(x, chunk_elems=16)):
        assert got.shape == x.shape and got.dtype == x.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert torch.equal(got, x)


def test_residual_dma_copy_wrapper():
    """tests/test_offload_exec.py::test_residual_dma_copy_wrapper."""
    x = torch.linspace(0.0, 1.0, 1000).reshape(10, 100)
    y = ops.residual_dma_copy(x)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


# ---------------------------------------------------------------------------
# K4 and K5 on a CUDA tensor launch the kernel or raise
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_cuda_lib(monkeypatch):
    """Install a fake library (launches return ``err``) in ``module``."""
    def install(module, err):
        lib = _FakeLib(err)
        monkeypatch.setattr(module, "library", lambda: lib)
        monkeypatch.setattr(module, "_stream_handle", lambda device: 0)
        monkeypatch.setattr(
            module, "_alloc",
            lambda shape, dtype, device: torch.full(
                shape, 7, dtype=dtype).as_subclass(_FakeCuda))
        return lib
    return install


def _fake_ssd_inputs():
    _, tin = _ssd_inputs(2, 64, 2, 16, 8)
    lens = torch.tensor([40, 64], dtype=torch.int32)
    return [t.as_subclass(_FakeCuda) for t in tin + [lens]]


def test_ssd_cuda_tensor_launches_kernel_not_plain(fake_cuda_lib):
    lib = fake_cuda_lib(ssd, 0)
    x, dt, A, Bm, Cm, lens = _fake_ssd_inputs()
    before = dict(ops.LAUNCHES)
    y = ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, lens, 16)
    assert [c[0] for c in lib.calls] == ["ssd_scan_fma"]   # fp32, P = 16
    assert lib.calls[0][1][7:15] == (2, 64, 2, 16, 8, 16, 0, 0)
    assert ops.LAUNCHES["ssd_scan_fma"] == before["ssd_scan_fma"] + 1
    assert (y.as_subclass(torch.Tensor) == 7).all()   # the kernel's buffer


def test_ssd_cuda_tensor_failed_launch_raises(fake_cuda_lib):
    fake_cuda_lib(ssd, 2)                           # cudaErrorMemoryAllocation
    x, dt, A, Bm, Cm, lens = _fake_ssd_inputs()
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="ssd_scan_fma launch failed"):
        ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, lens, 16)
    assert ops.LAUNCHES == before


def _fake_ssd_case(B, S, H, P, N, dtype, dt_dtype="float32"):
    _, (x, dt, A, Bm, Cm) = _ssd_inputs(B, S, H, P, N)
    tdt = getattr(torch, dtype)
    ins = [x.to(tdt), dt.to(getattr(torch, dt_dtype)), A, Bm.to(tdt),
           Cm.to(tdt), torch.tensor([S // 2 + 3] + [S] * (B - 1),
                                    dtype=torch.int32)]
    return [t.as_subclass(_FakeCuda) for t in ins]


# (B, S, H, P, N, chunk, x dtype, dt dtype) -> the kernel the rule picks
SSD_ROUTES = [
    ((2, 128, 8, 64, 128, 64, "bfloat16", "float32"), "ssd_scan"),
    ((1, 64, 4, 64, 128, 64, "bfloat16", "bfloat16"), "ssd_scan"),
    ((1, 64, 4, 64, 32, 64, "bfloat16", "float32"), "ssd_scan_fma"),
    ((2, 128, 8, 64, 128, 64, "float32", "float32"), "ssd_scan_fma"),
    ((2, 64, 4, 16, 16, 16, "bfloat16", "float32"), "ssd_scan_fma"),
    ((1, 128, 6, 64, 128, 64, "bfloat16", "float32"), "ssd_scan_fma"),
    ((1, 128, 4, 64, 128, 32, "bfloat16", "float32"), "ssd_scan_fma"),
    # hymba's SSD heads: P = 50, N = 16, on the tensor cores in bf16
    ((2, 128, 8, 50, 16, 64, "bfloat16", "float32"), "ssd_scan"),
    ((1, 64, 4, 50, 16, 64, "float32", "float32"), "ssd_scan_fma"),
    # the rule's edges: hymba's (P, N) with H not a multiple of 4, and
    # each half of it paired with the other instance's
    ((1, 64, 6, 50, 16, 64, "bfloat16", "float32"), "ssd_scan_fma"),
    ((1, 64, 4, 64, 16, 64, "bfloat16", "float32"), "ssd_scan_fma"),
    ((1, 64, 4, 50, 128, 64, "bfloat16", "float32"), "ssd_scan_fma"),
]


@pytest.mark.parametrize("case,kernel", SSD_ROUTES)
def test_ssd_dispatch_rule_picks_one_kernel_and_its_count(fake_cuda_lib,
                                                          case, kernel):
    """bf16 x/B/C at (P, N) = (64, 128) or (50, 16), Q = 64, H a
    multiple of 4 reach the tensor-core entry point ``ssd_scan`` and its
    count; every other case the FMA entry point ``ssd_scan_fma`` and its
    count."""
    lib = fake_cuda_lib(ssd, 0)
    B, S, H, P, N, chunk, dtype, dt_dtype = case
    x, dt, A, Bm, Cm, lens = _fake_ssd_case(B, S, H, P, N, dtype, dt_dtype)
    assert ssd.uses_tensor_cores(x, Bm, chunk) == (kernel == "ssd_scan")
    before = dict(ops.LAUNCHES)
    y = ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, lens, chunk)
    assert [c[0] for c in lib.calls] == [kernel]
    codes = {"float32": 0, "bfloat16": 1}
    assert lib.calls[0][1][7:15] == (B, S, H, P, N, chunk, codes[dtype],
                                     codes[dt_dtype])
    assert {k: v - before[k] for k, v in ops.LAUNCHES.items()
            if v != before[k]} == {kernel: 1}
    assert y.dtype == x.dtype and (y.as_subclass(torch.Tensor) == 7).all()


@pytest.mark.parametrize("case,kernel", [SSD_ROUTES[0], SSD_ROUTES[2]])
def test_ssd_failed_launch_raises_and_never_tries_the_other(fake_cuda_lib,
                                                            case, kernel):
    lib = fake_cuda_lib(ssd, 1)                     # cudaErrorInvalidValue
    B, S, H, P, N, chunk, dtype, dt_dtype = case
    x, dt, A, Bm, Cm, lens = _fake_ssd_case(B, S, H, P, N, dtype, dt_dtype)
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match=f"{kernel} launch failed"):
        ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, lens, chunk)
    assert [c[0] for c in lib.calls] == [kernel]
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("case", [c for c, k in SSD_ROUTES
                                  if k == "ssd_scan_fma"])
def test_ssd_tensor_core_entry_rejects_what_it_does_not_take(fake_cuda_lib,
                                                             case):
    lib = fake_cuda_lib(ssd, 0)
    B, S, H, P, N, chunk, dtype, dt_dtype = case
    x, dt, A, Bm, Cm, lens = _fake_ssd_case(B, S, H, P, N, dtype, dt_dtype)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="tensor-core SSD kernel takes"):
        ssd.ssd_scan_tc(x, dt, A, Bm, Cm, lens, chunk)
    assert lib.calls == [] and ops.LAUNCHES == before


def test_ssd_tensor_core_entry_rejects_misaligned_and_cpu(fake_cuda_lib):
    """A view off 16-byte alignment is refused, also through the
    dispatching wrapper (no other kernel takes the call); a CPU tensor
    never reaches the kernel."""
    lib = fake_cuda_lib(ssd, 0)
    x, dt, A, Bm, Cm, lens = _fake_ssd_case(1, 128, 4, 64, 128, "bfloat16")
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype).as_subclass(_FakeCuda)
    x_off = flat[1:].view(x.shape)                  # 2 bytes off alignment
    for fn in (ssd.ssd_scan_tc, ssd.ssd_scan_fwd):
        with pytest.raises(ValueError, match="x is not 16-byte aligned"):
            fn(x_off, dt, A, Bm, Cm, lens, 64)
    assert lib.calls == []
    cpu = [t.as_subclass(torch.Tensor) for t in (x, dt, A, Bm, Cm, lens)]
    with pytest.raises(ValueError, match="cuda"):
        ssd.ssd_scan_tc(*cpu, 64)


def test_ssd_cuda_wrapper_rejects_bad_operands(fake_cuda_lib):
    lib = fake_cuda_lib(ssd, 0)
    x, dt, A, Bm, Cm, lens = _fake_ssd_inputs()
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan_fwd(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, Bm, Cm, lens, 16)
    with pytest.raises(ValueError, match="dtype"):
        ssd.ssd_scan_fwd(x, dt, A, Bm.double(), Cm, lens, 16)
    with pytest.raises(ValueError, match="shape"):
        ssd.ssd_scan_fwd(x, dt, A, Bm, Cm, lens, 48)     # Q not taken
    x40, dt40, B40, C40 = (t[:, :40].contiguous() for t in (x, dt, Bm, Cm))
    with pytest.raises(ValueError, match="multiple"):
        ssd.ssd_scan_fwd(x40, dt40, A, B40, C40, lens, 16)
    assert lib.calls == []


def test_dma_cuda_tensor_launches_kernel_not_plain(fake_cuda_lib):
    lib = fake_cuda_lib(dma, 0)
    x = torch.arange(35, dtype=torch.bfloat16).reshape(7, 5).as_subclass(
        _FakeCuda)
    before = dict(ops.LAUNCHES)
    y = dma.dma_copy(x, 16)
    assert [c[0] for c in lib.calls] == ["dma_copy"]
    assert lib.calls[0][1][2:4] == (70, 32)          # bytes, chunk bytes
    assert ops.LAUNCHES["dma_copy"] == before["dma_copy"] + 1
    assert y.shape == x.shape and (y.as_subclass(torch.Tensor) == 7).all()


def test_dma_cuda_tensor_failed_launch_raises(fake_cuda_lib):
    fake_cuda_lib(dma, 1)
    x = torch.ones(64).as_subclass(_FakeCuda)
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="dma_copy launch failed"):
        dma.dma_copy(x, 16)
    assert ops.LAUNCHES == before


def test_dma_cuda_counts_one_launch_per_call(fake_cuda_lib):
    """Every call is one launch of the whole array (the kernel walks the
    chunks itself), counted once; an empty array launches nothing."""
    lib = fake_cuda_lib(dma, 0)
    before = ops.LAUNCHES["dma_copy"]
    for n, chunk in ((1000, 16), (1 << 16, 1 << 15), (5, 1 << 15)):
        dma.dma_copy(torch.ones(n).as_subclass(_FakeCuda), chunk)
    assert [c[1][2:4] for c in lib.calls] == [(4000, 64), (1 << 18, 1 << 17),
                                              (20, 20)]
    assert ops.LAUNCHES["dma_copy"] == before + 3
    y = dma.dma_copy(torch.ones(0).as_subclass(_FakeCuda), 16)
    assert y.shape == (0,) and len(lib.calls) == 3
    assert ops.LAUNCHES["dma_copy"] == before + 3
    with pytest.raises(ValueError, match="chunk_elems"):
        dma.dma_copy(torch.ones(8).as_subclass(_FakeCuda), -4)
    assert len(lib.calls) == 3


def test_dma_cuda_wrapper_rejects_bad_operands(fake_cuda_lib):
    lib = fake_cuda_lib(dma, 0)
    x = torch.ones(8, 8).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="contiguous"):
        dma.dma_copy(x.t(), 16)
    with pytest.raises(ValueError, match="chunk_elems"):
        dma.dma_copy(x, 0)
    assert lib.calls == []


# ---------------------------------------------------------------------------
# compiling the kernel sources (kernels/build.py)
# ---------------------------------------------------------------------------

def test_build_compiles_each_source_once_and_raises_on_failure(
        tmp_path, monkeypatch):
    """``build.build`` runs one compiler per source not built yet, keys the
    library by the source's hash, reuses it afterwards, and raises with
    the compiler's output when a compile fails.  A stand-in compiler
    (a Python script taking nvcc's ``-o out src``) replaces ``nvcc``."""
    from repro_torch.kernels import build
    fake = tmp_path / "fake_nvcc.py"
    log = tmp_path / "calls.txt"
    fake.write_text(
        "import sys\n"
        "out, src = sys.argv[sys.argv.index('-o') + 1], sys.argv[-1]\n"
        f"open({str(log)!r}, 'a').write(src + '\\n')\n"
        "if 'bad' in src:\n"
        "    print('error: bad source', file=sys.stderr)\n"
        "    sys.exit(2)\n"
        "open(out, 'w').write('lib')\n")
    fake.chmod(0o755)
    wrapper = tmp_path / "nvcc"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {fake} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(wrapper))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    srcs = []
    for name in ("a.cu", "b.cu"):
        srcs.append(tmp_path / name)
        srcs[-1].write_text(f"// {name}\n")
    paths = build.build(*srcs)
    assert [p.read_text() for p in paths] == ["lib", "lib"]
    assert paths[0] != paths[1] and paths == build.build(*srcs)
    assert sorted(log.read_text().split()) == sorted(str(s) for s in srcs)
    bad = tmp_path / "bad.cu"
    bad.write_text("// bad\n")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*bad source"):
        build.build(srcs[0], bad)
    assert not build.library_path(bad).exists()


def test_library_path_follows_the_headers_beside_the_source(tmp_path):
    """A source may include a ``.cuh`` beside it: the library's key
    covers those headers, so a changed header is rebuilt, never loaded
    stale."""
    from repro_torch.kernels import build
    src = tmp_path / "k.cu"
    src.write_text('#include "k_part.cuh"\n')
    header = tmp_path / "k_part.cuh"
    header.write_text("// one\n")
    first = build.library_path(src)
    assert build.library_path(src) == first
    header.write_text("// two\n")
    second = build.library_path(src)
    assert second != first
    header.unlink()
    assert build.library_path(src) not in (first, second)
