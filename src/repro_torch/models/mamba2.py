"""Mamba2 / SSD (state-space duality) mixer  [arXiv:2405.21060].

Counterpart of the reference's ``models/mamba2.py``: ``ssd_chunked``
(the chunked SSD algorithm in plain PyTorch), the single-token
``ssd_step``, the mixer's init, its no-cache forward (``mamba2_apply``)
and its cached form for serving (``mamba2_decode``).  The forward's
chunk scan runs through ``ssd_chunked`` (``impl="xla"``, the
reference's own formulation) or the hand-written kernel
(``impl="flash"``, ``kernels.ops.ssd_scan``).  Decode carries a state,
which the kernel neither takes nor returns, so it runs the plain
``ssd_step`` and ``ssd_chunked``, as the reference's decode does.

Layout conventions:
    x   : (B, S, H, P)   per-head channels
    dt  : (B, S, H)      softplus-discretised step sizes
    A   : (H,)           negative decay rates
    B,C : (B, S, N)      shared across heads (G = 1 group)
    state: (B, H, P, N)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.dtensor import local_ssd, split_heads


def mask_dt(dt: torch.Tensor, seq_lens: Optional[torch.Tensor]):
    """dt zeroed at positions at or past each sequence's length, so
    padding never enters the state (decay exp(0) = 1, update 0)."""
    if seq_lens is None:
        return dt
    valid = (torch.arange(dt.shape[1], device=dt.device)[None, :, None]
             < seq_lens.to(dt.device)[:, None, None])
    return torch.where(valid, dt, torch.zeros((), dtype=dt.dtype,
                                              device=dt.device))


# ---------------------------------------------------------------------------
# SSD chunked scan (plain PyTorch)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y in x's dtype, final_state fp32).  Shapes as in the
    module docstring."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    Sp = x.shape[1]
    Nc, Q = Sp // chunk, chunk

    xc = x.reshape(Bt, Nc, Q, H, P).float()
    dtc = dt.reshape(Bt, Nc, Q, H).float()
    Bc = B.reshape(Bt, Nc, Q, N).float()
    Cc = C.reshape(Bt, Nc, Q, N).float()

    la = torch.cumsum(dtc * A.float(), dim=2)            # within-chunk cumlog

    # intra-chunk (diagonal) term: L[i,j] = exp(la_i - la_j) for i >= j,
    # masked BEFORE the exp (the future entries would overflow)
    rel = la[:, :, :, None, :] - la[:, :, None, :, :]    # (B,Nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                               float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # (B,Nc,Q,Q)
    w = cb[..., None] * Lm * dtc[:, :, None, :, :]         # (B,Nc,Q,Q,H)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk summary states: state contribution of each chunk
    decay_to_end = torch.exp(la[:, :, -1:, :] - la)        # (B,Nc,Q,H)
    bx = torch.einsum("bcjn,bcjhp->bchpn", Bc,
                      xc * (decay_to_end * dtc)[..., None])
    chunk_decay = torch.exp(la[:, :, -1, :])               # (B,Nc,H)

    state = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []                                  # state *before* each chunk
    for c in range(Nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + bx[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,Nc,H,P,N)

    # inter-chunk (off-diagonal) term
    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, prev_states)
             * torch.exp(la)[..., None])

    y = (y_diag + y_off).reshape(Bt, Sp, H, P)[:, :S]
    return y.to(x.dtype), state


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """One decode step in fp32.  state: (B, H, P, N); x_t: (B, H, P);
    dt_t: (B, H); B_t, C_t: (B, N).  Returns (y in x_t's dtype, the new
    fp32 state)."""
    dt32 = dt_t.float()
    dA = torch.exp(dt32 * A.float())                            # (B, H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt32, x_t.float(), B_t.float())
    new_state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.float())
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# full mixer (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    return d_inner, H, N, conv_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The reference's tree and distributions; ``A_log``, ``dt_bias`` and
    ``D`` stay fp32 whatever the model's dtype."""
    d = cfg.d_model
    d_inner, H, N, conv_dim = mamba2_dims(cfg)
    proj_out = 2 * d_inner + 2 * N + H           # z, x, B, C, dt
    return {
        "in_proj": L.dense_init(gen, d, proj_out, dtype),
        "conv_w": (torch.randn(cfg.conv_kernel, conv_dim, generator=gen)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)),
        "dt_bias": torch.zeros(H),
        "D": torch.ones(H),
        "norm": L.rmsnorm_init(d_inner, dtype),
        "out_proj": L.dense_init(gen, d_inner, d, dtype),
    }


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  seq: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i] for i in range(K)) + b


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) = logaddexp(x, 0) everywhere
    (``F.softplus`` switches to x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_apply(params, cfg: ModelConfig, u: torch.Tensor, *,
                 seq_lens: Optional[torch.Tensor] = None,
                 impl: str = "xla") -> torch.Tensor:
    """u: (B, S, d_model) -> (B, S, d_model), from a zero state.

    ``seq_lens``: optional (B,) int32 true lengths of a bucket-padded
    batch — dt is zeroed past each sequence's length, so padding never
    enters the recurrent state.  ``impl="flash"`` runs the chunk scan
    through the hand-written kernel, ``"xla"`` through ``ssd_chunked``.
    """
    Bt, S, _ = u.shape
    d_inner, H, N, conv_dim = mamba2_dims(cfg)

    zxbcdt = u @ params["in_proj"]
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    x, B_, C_, dt, A = _ssd_inputs(params, cfg, xBC, dt_raw)
    dt = mask_dt(dt, seq_lens)

    if impl == "flash":
        from repro_torch.kernels import ops as kernel_ops

        def scan(x, dt, A, B_, C_, lens):
            return kernel_ops.ssd_scan(x, dt, A, B_, C_, lens,
                                       chunk=cfg.ssm_chunk)
    elif impl == "xla":
        def scan(x, dt, A, B_, C_, lens):
            return ssd_chunked(x, dt, A, B_, C_, cfg.ssm_chunk)[0]
    else:
        raise ValueError(f"ssd impl must be 'xla' or 'flash', not {impl!r}")
    # on DTensors: each device's batch rows and heads
    y = local_ssd(scan, x, dt, A, B_, C_, seq_lens)
    return _mixer_out(params, cfg, y, x, z)


def _ssd_inputs(params, cfg: ModelConfig, xBC, dt_raw):
    """(x (B, S, H, P), B, C (B, S, N), dt (B, S, H) fp32, A (H,)) from
    the convolved ``xBC`` and the raw step sizes."""
    d_inner, H, N, _ = mamba2_dims(cfg)
    x, B_, C_ = torch.split(F.silu(xBC), [d_inner, N, N], dim=-1)
    x = split_heads(x, H, cfg.ssm_head_dim)
    dt = softplus(dt_raw.float() + params["dt_bias"])
    return x, B_, C_, dt, -torch.exp(params["A_log"])


def _mixer_out(params, cfg: ModelConfig, y, x, z):
    """The D skip, the gated norm and the output projection."""
    y = y + params["D"].to(y.dtype)[None, None, :, None] * x
    y = y.reshape(*y.shape[:2], -1)
    y = L.rmsnorm_apply(params["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ params["out_proj"]


def mamba2_decode(params, cfg: ModelConfig, u: torch.Tensor,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """The mixer over C >= 1 new tokens from a cached state (the
    reference's ``mamba2_apply(..., decode=True)``).  u: (B, C, d);
    ``ssm_state`` (B, H, P, N) fp32; ``conv_state`` (B, K - 1, conv_dim),
    the last K - 1 inputs of the convolution.  Returns ``(out,
    (ssm_state, conv_state))``, both new tensors.

    The causal convolution slides over ``[conv_state, new inputs]``; the
    scan is ``ssd_step`` for C == 1 and ``ssd_chunked`` from the cached
    state for a chunk of the prompt.  No length masking: every row's
    tokens are real, as in the reference."""
    Bt, C, _ = u.shape
    d_inner, H, N, conv_dim = mamba2_dims(cfg)
    zxbcdt = u @ params["in_proj"]
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    full = torch.cat([conv_state, xBC], dim=1)          # (B, K-1+C, conv)
    new_conv = full[:, C:]
    xBC = sum(full[:, i:i + C, :] * params["conv_w"][i]
              for i in range(cfg.conv_kernel)) + params["conv_b"]
    x, B_, C_, dt, A = _ssd_inputs(params, cfg, xBC, dt_raw)
    if C == 1:
        y, new_ssm = ssd_step(ssm_state, x[:, 0], dt[:, 0], A, B_[:, 0],
                              C_[:, 0])
        y = y[:, None]
    else:
        y, new_ssm = ssd_chunked(x, dt, A, B_, C_, cfg.ssm_chunk,
                                 initial_state=ssm_state)
    return _mixer_out(params, cfg, y, x, z), (new_ssm, new_conv)
