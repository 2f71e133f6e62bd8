"""Plain reference of the dense decoder-only LM (stablelm_3b): float32
products (or the control's float8), one sequence at its true length.

Written from the configuration: embedding, then per layer a pre-norm
causal multi-head attention with rotary positions and a pre-norm SwiGLU
MLP, both residual; a final RMSNorm and the LM head (untied, or the
embedding's transpose when tied).  Dense weights are (d_in, d_out) and
applied as ``x @ w``.  The parameter names are the program's tree paths
(``blocks.<i>.attn.wq`` ...), so each leaf is compared by name.
Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from pbench.refcore import rmsnorm, rope, row_ce


def _hd(m: dict) -> int:
    return int(m.get("head_dim") or m["d_model"] // m["num_heads"])


def param_spec(m: dict) -> list:
    """[(name, shape, dtype, init)] in the program's order; ``init`` is
    ("normal", std), ("ones",) or ("zeros",)."""
    if m.get("qk_norm") or m.get("sliding_window") or m.get("mrope"):
        raise NotImplementedError("the dense reference has no qk-norm, "
                                  "window or M-RoPE")
    if m.get("mlp_act", "swiglu") != "swiglu":
        raise NotImplementedError("the dense reference's MLP is SwiGLU")
    d, V, ff, hd = m["d_model"], m["vocab_size"], m["d_ff"], _hd(m)
    H, Hkv = m["num_heads"], m["num_kv_heads"]
    dt = m["dtype"]

    def dense(a, b):
        return ((a, b), dt, ("normal", 1.0 / math.sqrt(a)))

    spec = [("embed", (V, d), dt, ("normal", 0.02)),
            ("final_norm.scale", (d,), dt, ("ones",))]
    if not m["tie_embeddings"]:
        spec.append(("lm_head",) + dense(d, V))
    for i in range(m["num_layers"]):
        b = f"blocks.{i}."
        spec += [(b + "norm1.scale", (d,), dt, ("ones",)),
                 (b + "attn.wq",) + dense(d, H * hd),
                 (b + "attn.wk",) + dense(d, Hkv * hd),
                 (b + "attn.wv",) + dense(d, Hkv * hd),
                 (b + "attn.wo",) + dense(H * hd, d),
                 (b + "norm2.scale", (d,), dt, ("ones",)),
                 (b + "mlp.wi",) + dense(d, ff),
                 (b + "mlp.wg",) + dense(d, ff),
                 (b + "mlp.wo",) + dense(ff, d)]
    return spec


def _attention(p, m, h, ein):
    S = h.shape[0]
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], _hd(m)
    q = ein("sd,de->se", h, p["wq"]).reshape(S, H, hd)
    k = ein("sd,de->se", h, p["wk"]).reshape(S, Hkv, hd)
    v = ein("sd,de->se", h, p["wv"]).reshape(S, Hkv, hd)
    theta = float(m.get("rope_theta", 10000.0))
    q, k = rope(q, theta), rope(k, theta)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    s = ein("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = ein("hqk,khd->qhd", a, v).reshape(S, H * hd)
    return ein("se,ed->sd", o, p["wo"])


def row_loss(params: dict, m: dict, tokens, labels, weights, ein):
    """Sum of the weighted cross entropy over one sequence (S,)."""
    eps = float(m.get("norm_eps", 1e-6))
    x = params["embed"][tokens]
    for i in range(m["num_layers"]):
        b = f"blocks.{i}."
        p = {k[len(b):]: t for k, t in params.items() if k.startswith(b)}
        h = rmsnorm(x, p["norm1.scale"], eps)
        x = x + _attention({k[5:]: t for k, t in p.items()
                            if k.startswith("attn.")}, m, h, ein)
        h = rmsnorm(x, p["norm2.scale"], eps)
        g = torch.nn.functional.silu(ein("sd,df->sf", h, p["mlp.wg"]))
        u = ein("sd,df->sf", h, p["mlp.wi"])
        x = x + ein("sf,fd->sd", g * u, p["mlp.wo"])
    x = rmsnorm(x, params["final_norm.scale"], eps)
    head = (params["embed"].t() if m["tie_embeddings"]
            else params["lm_head"])
    return row_ce(ein("sd,dv->sv", x, head), labels, weights)
