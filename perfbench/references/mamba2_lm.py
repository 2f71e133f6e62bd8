"""Plain reference of the Mamba-2 LM (mamba2_1p3b, arXiv:2405.21060):
float32 products (or the control's float8), one sequence at its true
length.

Per layer, pre-norm and residual: the input projection to (z, x, B, C,
dt), a depthwise causal convolution over (x, B, C) with SiLU, dt =
softplus(dt_raw + dt_bias), A = -exp(A_log), the SSD scan from a zero
state in chunks (its exact chunked form: the intra-chunk products with
the causal decay matrix and the carried chunk states), the D skip, the
gated RMSNorm y * silu(z) and the output projection.  One B/C group
shared by every head; no MLP (d_ff 0).  A final RMSNorm and the tied
head.  The parameter names are the program's tree paths.  Imports
nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pbench.refcore import rmsnorm, row_ce


def dims(m: dict):
    d_inner = m["ssm_expand"] * m["d_model"]
    H = d_inner // m["ssm_head_dim"]
    N = m["ssm_state"]
    return d_inner, H, N, d_inner + 2 * N


def param_spec(m: dict) -> list:
    """[(name, shape, dtype, init)] in the program's order; ``init`` is
    ("normal", std), ("ones",), ("zeros",) or ("log_linspace", lo, hi)."""
    if m.get("d_ff"):
        raise NotImplementedError("the Mamba-2 reference has no MLP blocks")
    if not m["tie_embeddings"]:
        raise NotImplementedError("the Mamba-2 reference ties its head")
    d, V, K = m["d_model"], m["vocab_size"], m["conv_kernel"]
    d_inner, H, N, conv_dim = dims(m)
    dt = m["dtype"]
    spec = [("embed", (V, d), dt, ("normal", 0.02)),
            ("final_norm.scale", (d,), dt, ("ones",))]
    for i in range(m["num_layers"]):
        b = f"blocks.{i}."
        spec += [
            (b + "norm1.scale", (d,), dt, ("ones",)),
            (b + "ssm.in_proj", (d, 2 * d_inner + 2 * N + H), dt,
             ("normal", 1.0 / math.sqrt(d))),
            (b + "ssm.conv_w", (K, conv_dim), dt, ("normal", 0.1)),
            (b + "ssm.conv_b", (conv_dim,), dt, ("zeros",)),
            (b + "ssm.A_log", (H,), "float32", ("log_linspace", 1.0, 16.0)),
            (b + "ssm.dt_bias", (H,), "float32", ("zeros",)),
            (b + "ssm.D", (H,), "float32", ("ones",)),
            (b + "ssm.norm.scale", (d_inner,), dt, ("ones",)),
            (b + "ssm.out_proj", (d_inner, d), dt,
             ("normal", 1.0 / math.sqrt(d_inner)))]
    return spec


def ssd(x, dt, A, Bm, Cm, chunk: int, ein):
    """y (S, H, P) of the SSD recurrence h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t^T, y_t = h_t C_t, from h = 0, in chunks of ``chunk``."""
    S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Nc, Q = (S + pad) // chunk, chunk
    xc, dtc = x.reshape(Nc, Q, H, P), dt.reshape(Nc, Q, H)
    Bc, Cc = Bm.reshape(Nc, Q, N), Cm.reshape(Nc, Q, N)
    la = torch.cumsum(dtc * A, dim=1)                       # (Nc, Q, H)
    rel = la[:, :, None, :] - la[:, None, :, :]             # (Nc, i, j, H)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(torch.where(causal[None, :, :, None], rel,
                               float("-inf")))
    cb = ein("cin,cjn->cij", Cc, Bc)
    w = cb[..., None] * Lm * dtc[:, None, :, :]
    y = ein("cijh,cjhp->cihp", w, xc)
    decay_to_end = torch.exp(la[:, -1:, :] - la)            # (Nc, Q, H)
    bx = ein("cjn,cjhp->chpn", Bc, xc * (decay_to_end * dtc)[..., None])
    chunk_decay = torch.exp(la[:, -1, :])                   # (Nc, H)
    state = torch.zeros(H, P, N, device=x.device)
    prev = []
    for c in range(Nc):
        prev.append(state)
        state = state * chunk_decay[c, :, None, None] + bx[c]
    y_off = ein("cin,chpn->cihp", Cc, torch.stack(prev)) \
        * torch.exp(la)[..., None]
    return (y + y_off).reshape(Nc * Q, H, P)[:S]


def _mixer(p, m, u, ein):
    S = u.shape[0]
    d_inner, H, N, conv_dim = dims(m)
    P, K = m["ssm_head_dim"], m["conv_kernel"]
    zxbcdt = ein("sd,de->se", u, p["in_proj"])
    z, xBC, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    padded = F.pad(xBC, (0, 0, K - 1, 0))
    xBC = sum(padded[i:i + S] * p["conv_w"][i] for i in range(K)) \
        + p["conv_b"]
    x, Bm, Cm = torch.split(F.silu(xBC), [d_inner, N, N], dim=-1)
    x = x.reshape(S, H, P)
    dt = torch.logaddexp(dt_raw + p["dt_bias"], torch.zeros_like(dt_raw))
    A = -torch.exp(p["A_log"])
    y = ssd(x, dt, A, Bm, Cm, m["ssm_chunk"], ein)
    y = (y + p["D"][None, :, None] * x).reshape(S, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm.scale"], float(m.get("norm_eps",
                                                           1e-6)))
    return ein("se,ed->sd", y, p["out_proj"])


def row_loss(params: dict, m: dict, tokens, labels, weights, ein):
    """Sum of the weighted cross entropy over one sequence (S,)."""
    eps = float(m.get("norm_eps", 1e-6))
    x = params["embed"][tokens]
    for i in range(m["num_layers"]):
        b = f"blocks.{i}."
        p = {k[len(b):]: t for k, t in params.items() if k.startswith(b)}
        h = rmsnorm(x, p["norm1.scale"], eps)
        x = x + _mixer({k[4:]: t for k, t in p.items()
                        if k.startswith("ssm.")}, m, h, ein)
    x = rmsnorm(x, params["final_norm.scale"], eps)
    return row_ce(ein("sd,dv->sv", x, params["embed"].t()), labels, weights)
