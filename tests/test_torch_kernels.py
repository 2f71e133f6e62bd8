"""The port's flash attention against the reference's oracle.

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
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_reference as jax_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_reference

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
