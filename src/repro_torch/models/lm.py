"""The language-model shell: embedding -> N plannable blocks -> final
norm -> tied lm head.

Counterpart of the reference's ``models/lm.py`` for the dense family in
unrolled mode.  The Mimose planner sees the model as an ordered list of
plan units (one per block) and decides which to rematerialise; REMAT is
``torch.utils.checkpoint`` (non-reentrant), so a rematerialised block's
forward runs again in the backward pass.

    lm = LM(cfg, attn_impl="flash", device="cuda")
    loss, metrics = lm.loss(batch, actions)
    units = lm.plan_units(batch)          # for the Mimose collector

Parameters keep the reference's tree and layout (``embed``,
``final_norm.scale``, ``blocks.<i>.{norm1, attn.{wq,wk,wv,wo}, norm2,
mlp.{wi,wo}}``, dense weights ``(d_in, d_out)``), so ``repro_torch.bridge``
converts the reference's parameters with a plain copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.actions import Action, as_actions
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and no GPU is present (there is no quiet fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    return dev


def block_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, layer_is_global: bool = True,
                impl: str = "xla",
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One dense block: pre-norm attention and MLP, both residual."""
    eps = cfg.norm_eps
    x = x + L.attention_apply(params["attn"], cfg,
                              L.rmsnorm_apply(params["norm1"], x, eps),
                              positions=positions,
                              layer_is_global=layer_is_global, impl=impl,
                              kv_len=seq_lens)
    return x + L.mlp_apply(params["mlp"],
                           L.rmsnorm_apply(params["norm2"], x, eps),
                           cfg.mlp_act)


@dataclasses.dataclass
class PlanUnit:
    """One schedulable unit: a block."""
    name: str
    index: int                     # forward timestamp order
    params: Any                    # the block's parameter tree
    apply: Callable[[Any, torch.Tensor], torch.Tensor]   # fn(params, x) -> x
    # behavioural statics baked into ``apply``: two units with equal
    # signature and equal param/input shapes save identical residuals,
    # so the collector traces only one of them
    signature: Optional[tuple] = None


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "family": cfg.family != "dense",
        "qk_norm": cfg.qk_norm,
        "mrope": cfg.mrope,
        "encoder_layers": cfg.encoder_layers > 0,
        "vision_tokens": cfg.vision_tokens > 0,
        "remat_mode": cfg.remat_mode != "unrolled",
        "tie_embeddings": not cfg.tie_embeddings,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense, unrolled, tied-embedding "
            f"models only; unsupported settings: {bad}")


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, attn_impl: str = "xla", *,
                 device="cuda", seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        if attn_impl not in ("xla", "flash"):
            raise ValueError(f"attn_impl must be 'xla' or 'flash', "
                             f"not {attn_impl!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.kind = "dense"
        dt = _DTYPES[cfg.dtype]
        device = resolve_device(device)
        # the reference's init distributions, drawn on the CPU from one
        # seeded generator so every device gets the same weights
        gen = torch.Generator().manual_seed(seed)
        d, hd = cfg.d_model, cfg.resolved_head_dim()

        def ones(n):
            return nn.ParameterDict({"scale": torch.ones(n, dtype=dt)})

        def dense(a, b):
            return L.dense_init(gen, a, b, dt)

        self.embed = nn.Parameter(L.embed_init(gen, cfg.vocab_size, d, dt))
        self.final_norm = ones(d)
        blocks = []
        for _ in range(cfg.num_layers):
            mlp = {"wi": dense(d, cfg.d_ff)}
            if cfg.mlp_act == "swiglu":
                mlp["wg"] = dense(d, cfg.d_ff)
            mlp["wo"] = dense(cfg.d_ff, d)
            blocks.append(nn.ModuleDict({
                "norm1": ones(d),
                "attn": nn.ParameterDict({
                    "wq": dense(d, cfg.num_heads * hd),
                    "wk": dense(d, cfg.num_kv_heads * hd),
                    "wv": dense(d, cfg.num_kv_heads * hd),
                    "wo": dense(cfg.num_heads * hd, d)}),
                "norm2": ones(d),
                "mlp": nn.ParameterDict(mlp)}))
        self.blocks = nn.ModuleList(blocks)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def _is_global(self, i: int) -> bool:
        g = self.cfg.global_interval
        if not self.cfg.sliding_window:
            return True
        if not g:
            return False              # uniform sliding window
        return (i + 1) % g == 0

    # -- forward -----------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor],
                actions=None) -> torch.Tensor:
        """Logits (B, S, V) in fp32.  ``actions``: per-unit plan (bools or
        ``Action``); REMAT units are checkpointed.  An OFFLOAD unit runs
        as REMAT (the reference's ``offload_exec=False``).  ``lengths``
        ((B,) true lengths of a bucket-padded batch) are threaded into
        every block's attention."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self.embed[tokens]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        seq_lens = batch.get("lengths")
        if seq_lens is not None:
            seq_lens = seq_lens.to(device=x.device, dtype=torch.int32)
        n = self.num_plan_units()
        acts = (as_actions(actions) if actions is not None
                else (Action.KEEP,) * n)
        if len(acts) != n:
            raise ValueError(f"plan has {len(acts)} actions for {n} units")
        for i, blk in enumerate(self.blocks):
            def one(xx, _blk=blk, _g=self._is_global(i)):
                return block_apply(_blk, cfg, xx, positions=positions,
                                   layer_is_global=_g, impl=self.attn_impl,
                                   seq_lens=seq_lens)
            if acts[i] in (Action.REMAT, Action.OFFLOAD):
                x = checkpoint(one, x, use_reentrant=False)
            else:
                x = one(x)
        x = L.rmsnorm_apply(self.final_norm, x, cfg.norm_eps)
        return (x @ self.embed.t()).float()

    def loss(self, batch: Dict[str, torch.Tensor],
             actions=None) -> Tuple[torch.Tensor, dict]:
        """Weighted mean of (logsumexp - label logit) over
        ``max(sum(weights), 1)``."""
        logits = self.forward(batch, actions)
        labels = batch["labels"].long()
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(labels.shape, device=logits.device)
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels[..., None])[..., 0]
        total_w = weights.float().sum().clamp_min(1.0)
        ce = ((lse - label_logit) * weights).sum() / total_w
        return ce, {"ce": ce, "tokens": total_w}

    # -- plan units ----------------------------------------------------------
    def num_plan_units(self) -> int:
        return self.cfg.num_layers

    def plan_unit_meta(self, batch) -> List[Dict[str, Any]]:
        """One dict per plan unit: the static facts the roofline cost
        model needs to price its forward (= its recompute cost)."""
        B, S = batch["tokens"].shape
        return [{"kind": self.kind, "layers": 1, "batch": int(B),
                 "seq": int(S), "is_global": self._is_global(i)}
                for i in range(self.cfg.num_layers)]

    def plan_units(self, batch) -> List[PlanUnit]:
        """Ordered plannable units.  Each ``apply(params, x)`` builds its
        positions from ``x`` (no lengths, as in the reference), so the
        collector can run it on ``meta`` tensors."""
        cfg = self.cfg
        units = []
        for i, blk in enumerate(self.blocks):
            def blk_fn(p, xx, _g=self._is_global(i)):
                B, S = xx.shape[:2]
                pos = torch.arange(S, device=xx.device).expand(B, S)
                return block_apply(p, cfg, xx, positions=pos,
                                   layer_is_global=_g, impl=self.attn_impl)
            units.append(PlanUnit(f"block{i}", i, blk, blk_fn,
                                  signature=("block", self._is_global(i))))
        return units
