"""The language-model shell: embedding -> N plannable blocks -> final
norm -> lm head (tied to the embedding, or its own ``lm_head``).

Counterpart of the reference's ``models/lm.py`` for every family --
dense (qk-norm and sliding-window layers included), ssm (Mamba2), moe,
hybrid (Hymba), encdec (a bidirectional encoder over stub ``frames``
and a decoder with cross attention) and vlm (stub ``vision_embeds``
prepended to the text, M-RoPE) -- in unrolled or scan mode.  Families
differ only in what a block contains.  The Mimose planner sees
the model as an ordered list of plan units and decides which to
rematerialise: the encoder's layers first (one unit each, never
stacked), then one unit per decoder block in unrolled mode, or one per
chunk of consecutive layers in scan mode (``scan_chunks`` chunks, the
reference's ``_chunk_bounds``).  REMAT is ``torch.utils.checkpoint``
(non-reentrant) around each layer of the unit — the reference's scan
mode checkpoints the scan *body*, so a REMAT chunk keeps every layer
input of the chunk, not one — and a rematerialised layer's forward runs
again in the backward.

    lm = LM(cfg, attn_impl="flash", device="cuda")
    loss, metrics = lm.loss(batch, actions)
    units = lm.plan_units(batch)          # for the Mimose collector
    cache = lm.init_cache(batch_size, max_len)
    logits, cache = lm.decode_step(tokens, cache, index)   # serving

Parameters keep the reference's tree and layout (``embed``,
``final_norm.scale``, ``lm_head`` when untied, ``blocks.<i>.{norm1,
attn.{wq,wk,wv,wo[,q_norm,k_norm]}, [norm_cross, cross,] norm2, mlp |
moe}``, ``encoder.{blocks.<i>, final_norm}`` for encdec,
``blocks.<i>.{norm1, ssm.{in_proj, conv_w, ...}}`` or ``blocks.<i>.{norm1,
mixer.{attn, ssm, attn_scale, ssm_scale}, norm2, mlp}``, dense weights
``(d_in, d_out)``), one entry per layer in both modes, so
``repro_torch.bridge`` converts the reference's parameters with a plain
copy (unstacking the scan mode's layer axis).  ``attn_impl="flash"``
selects the hand-written kernels of every mixer: flash attention, the
SSD chunk scan, or both (hybrid).  A block returns its auxiliary loss
beside its output (the MoE load-balance loss; ``None`` for the other
kinds, the reference's zeros), and the loss is ``ce + aux``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.actions import Action, as_actions
from repro_torch.config import ModelConfig
from repro_torch.models import hymba as HY
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.sharding import dtensor as D
from repro_torch.train.transfer import TransferLane

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
FAMILIES = ("dense", "ssm", "moe", "hybrid", "encdec", "vlm")
# the decoder's block kind of each family (the encoder's is "enc")
BLOCK_KIND = {"encdec": "dec", "vlm": "dense"}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and no GPU is present (there is no quiet fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    return dev


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensors become parameters and
    dicts sub-trees, so the state-dict keys are the reference's tree paths
    (``blocks.3.ssm.norm.scale``) and leaves keep their own dtypes."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(key, nn.Parameter(value))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def items(self):
        yield from self._parameters.items()
        yield from self._modules.items()

    def values(self):
        for _, value in self.items():
            yield value


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> dict:
    d = cfg.d_model
    p = {"norm1": L.rmsnorm_init(d, dtype)}
    if kind == "ssm":
        p["ssm"] = M.mamba2_init(gen, cfg, dtype)
        if cfg.d_ff:
            p["norm2"] = L.rmsnorm_init(d, dtype)
            p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype)
        return p
    # the feed-forward part is drawn before the mixer, so a seed gives
    # the dense models the weights it gave them before the other kinds
    ffn = (MOE.moe_init(gen, cfg, dtype) if kind == "moe"
           else L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype))
    if kind == "hybrid":
        p["mixer"] = HY.hymba_init(gen, cfg, dtype)
    else:
        p["attn"] = L.attention_init(gen, cfg, dtype)
    if kind == "dec":
        p["norm_cross"] = L.rmsnorm_init(d, dtype)
        p["cross"] = L.attention_init(gen, cfg, dtype)
    p["norm2"] = L.rmsnorm_init(d, dtype)
    p["moe" if kind == "moe" else "mlp"] = ffn
    return p


def block_apply(params, cfg: ModelConfig, x: torch.Tensor, kind: str, *,
                positions: torch.Tensor, layer_is_global: bool = True,
                impl: str = "xla",
                seq_lens: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                mrope_positions: Optional[torch.Tensor] = None,
                constrain: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block: pre-norm mixer (attention; the Mamba2 mixer for
    ``kind="ssm"``; attention and Mamba2 in parallel for ``"hybrid"``)
    and MLP (the MoE for ``"moe"``), both residual; an ssm block without
    ``d_ff`` has no MLP.  ``"enc"``'s self attention is bidirectional;
    ``"dec"`` adds a pre-norm cross attention over ``enc_out`` (B, F, d)
    after its causal self attention, with keys and values projected from
    ``enc_out`` (no RoPE).  ``constrain`` (None: identity) is applied to
    each branch's normed input and to its output before the residual add
    (the residual stream's placements on a mesh, ``LM.act_sharding``).
    Returns ``(x, aux)``: the MoE's load-balance loss, or None."""
    eps = cfg.norm_eps
    c = constrain or (lambda t: t)
    h = c(L.rmsnorm_apply(params["norm1"], x, eps))
    if kind == "ssm":
        x = x + c(M.mamba2_apply(params["ssm"], cfg, h, seq_lens=seq_lens,
                                 impl=impl))
        if not cfg.d_ff:
            return x, None
    elif kind == "hybrid":
        x = x + c(HY.hymba_apply(params["mixer"], cfg, h,
                                 positions=positions,
                                 layer_is_global=layer_is_global, impl=impl,
                                 seq_lens=seq_lens))
    else:
        x = x + c(L.attention_apply(params["attn"], cfg, h,
                                    positions=positions,
                                    layer_is_global=layer_is_global,
                                    impl=impl, kv_len=seq_lens,
                                    mrope_positions=mrope_positions,
                                    causal=kind != "enc"))
    if kind == "dec":
        # k and v in one product: the encoder output's gradient then
        # takes one term per decoder layer, summed in the same order
        # whether the layer ran under KEEP, REMAT or OFFLOAD
        B, F = enc_out.shape[:2]
        wkv = torch.cat([params["cross"]["wk"], params["cross"]["wv"]], 1)
        ck, cv = (enc_out @ wkv).reshape(
            B, F, 2, cfg.num_kv_heads, cfg.resolved_head_dim()).unbind(2)
        hx = c(L.rmsnorm_apply(params["norm_cross"], x, eps))
        x = x + c(L.attention_apply(params["cross"], cfg, hx,
                                    positions=positions, impl=impl,
                                    cross_kv=(ck, cv)))
    return _ffn(params, cfg, x, kind, c)


def _ffn(params, cfg: ModelConfig, x, kind: str, c=lambda t: t):
    """The pre-norm MLP (the MoE for ``"moe"``), residual: ``(x, aux)``;
    ``c`` constrains the branch's output (``block_apply``)."""
    h2 = c(L.rmsnorm_apply(params["norm2"], x, cfg.norm_eps))
    if kind == "moe":
        out, aux = MOE.moe_apply(params["moe"], cfg, h2)
        return x + c(out), aux
    return x + c(L.mlp_apply(params["mlp"], h2, cfg.mlp_act)), None


def block_decode(params, cfg: ModelConfig, x: torch.Tensor, kind: str, *,
                 positions: torch.Tensor, cache: dict, cache_index,
                 layer_is_global: bool = True,
                 mrope_positions: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """``block_apply`` over the layer's cache (the reference's
    ``block_apply`` with ``cache`` and ``decode=True``, kinds dense, moe,
    ssm, hybrid and dec): x (B, C, d) are the C new tokens at
    ``positions``.  The cache dict is updated: k and v written in place
    at ``cache_index``, ``ssm`` and ``conv`` replaced by the new states;
    a dec block's cross attention reads the cached ``ck`` and ``cv``.
    The MoE's auxiliary loss is dropped, as the reference's decode
    drops it."""
    h = L.rmsnorm_apply(params["norm1"], x, cfg.norm_eps)
    if kind == "ssm":
        out, (cache["ssm"], cache["conv"]) = M.mamba2_decode(
            params["ssm"], cfg, h, cache["ssm"], cache["conv"])
        x = x + out
        if not cfg.d_ff:
            return x
    elif kind == "hybrid":
        x = x + HY.hymba_decode(params["mixer"], cfg, h, positions=positions,
                                cache=cache, cache_index=cache_index,
                                layer_is_global=layer_is_global)
    else:
        x = x + L.attention_decode(params["attn"], cfg, h,
                                   positions=positions, kv_cache=cache,
                                   cache_index=cache_index,
                                   layer_is_global=layer_is_global,
                                   mrope_positions=mrope_positions)[0]
    if kind == "dec":
        hx = L.rmsnorm_apply(params["norm_cross"], x, cfg.norm_eps)
        x = x + L.attention_apply(params["cross"], cfg, hx,
                                  positions=positions,
                                  cross_kv=(cache["ck"], cache["cv"]))
    return _ffn(params, cfg, x, kind)[0]


class _OffloadChain:
    """The offloaded inputs of one forward, in forward order, so each
    layer's backward can prefetch the input the backward needs next."""

    def __init__(self, lane: TransferLane):
        self.lane = lane
        self.handles: list = []
        self.prefetched: dict = {}

    def prefetch(self, i: int) -> None:
        if 0 <= i < len(self.handles) and i not in self.prefetched:
            self.prefetched[i] = self.lane.prefetch(self.handles[i])

    def fetch(self, i: int) -> torch.Tensor:
        self.prefetch(i)
        h = self.prefetched.pop(i)
        self.handles[i] = None
        return self.lane.fetch(h)


class _OffloadLayer(torch.autograd.Function):
    """One layer whose input checkpoint goes to host memory.  Inputs:
    ``(x, fn, chain, n_extra, *extra, *params)``: ``fn(x, *extra)`` runs
    the layer on its parameters ``params`` (passed so autograd routes
    their gradients) and returns ``(y, aux)``; ``extra`` are the other
    tensors the layer reads (a decoder layer's encoder output), kept on
    the device and given their gradients too.  Outputs ``y``, or ``(y,
    aux)`` when the layer has an auxiliary loss; the backward takes the
    incoming gradient of each."""

    @staticmethod
    def forward(ctx, x, fn, chain, n_extra, *tensors):
        ctx.fn, ctx.chain = fn, chain
        ctx.index = len(chain.handles)
        chain.handles.append(chain.lane.offload(x))
        ctx.extra, ctx.params = tensors[:n_extra], tensors[n_extra:]
        y, aux = fn(x, *ctx.extra)   # forward of a Function: no grad
        ctx.has_aux = aux is not None
        return (y, aux) if ctx.has_aux else y

    @staticmethod
    def backward(ctx, *grad_outs):
        chain, i = ctx.chain, ctx.index
        x = chain.fetch(i)
        chain.prefetch(i - 1)        # the next input the backward needs
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            extra = tuple(e.detach().requires_grad_(e.requires_grad)
                          for e in ctx.extra)
            y, aux = ctx.fn(xx, *extra)
            outs = (y, aux) if ctx.has_aux else (y,)
            wrt = (xx,) + tuple(e for e in extra if e.requires_grad) \
                + tuple(ctx.params)
            grads = iter(torch.autograd.grad(outs, wrt, grad_outs,
                                             allow_unused=True))
        gx = next(grads)
        g_extra = tuple(next(grads) if e.requires_grad else None
                        for e in extra)
        return (gx, None, None, None) + g_extra + tuple(grads)


@dataclasses.dataclass
class PlanUnit:
    """One schedulable unit: a block (unrolled) or a layer chunk (scan)."""
    name: str
    index: int                     # forward timestamp order
    params: Any                    # the block's tree, or a list of them
    # fn(params, x) -> x (the auxiliary loss is dropped, as the
    # reference's units do)
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    # behavioural statics baked into ``apply``: two units with equal
    # signature and equal param/input shapes save identical residuals,
    # so the collector traces only one of them
    signature: Optional[tuple] = None


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "family": cfg.family not in FAMILIES,
        "remat_mode": cfg.remat_mode not in ("unrolled", "scan"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the families {FAMILIES}, unrolled "
            f"or in scan mode; unsupported settings: {bad}")


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
        self.kind = BLOCK_KIND.get(cfg.family, cfg.family)
        # vision patches prepended to the text (the reference's test)
        self.vision = cfg.family == "vlm" and cfg.vision_tokens > 0
        dt = _DTYPES[cfg.dtype]
        device = resolve_device(device)
        # the reference's init distributions, drawn on the CPU from one
        # seeded generator so every device gets the same weights; on
        # ``meta`` only the shapes are made (for the collector)
        gen = torch.Generator().manual_seed(seed)
        with torch.device("meta" if device.type == "meta" else "cpu"):
            embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
            final_norm = L.rmsnorm_init(cfg.d_model, dt)
            lm_head = (None if cfg.tie_embeddings else
                       L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt))
            blocks = [block_init(gen, cfg, self.kind, dt)
                      for _ in range(cfg.num_layers)]
            enc_blocks = [block_init(gen, cfg, "enc", dt)
                          for _ in range(cfg.encoder_layers)]
            enc_norm = L.rmsnorm_init(cfg.d_model, dt)
        self.embed = nn.Parameter(embed)
        self.final_norm = ParamTree(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.blocks = nn.ModuleList(ParamTree(b) for b in blocks)
        # the encoder keeps one tree per layer in both modes, as the
        # reference's (never stacked)
        self.encoder = None
        if cfg.encoder_layers:
            self.encoder = nn.Module()
            self.encoder.blocks = nn.ModuleList(ParamTree(b)
                                                for b in enc_blocks)
            self.encoder.final_norm = ParamTree(enc_norm)
        self.to(device)
        # OFFLOAD execution: True runs it for real (the only mode on
        # CUDA unless a caller asks otherwise); the lane is made on first
        # use, or set by the trainer to carry its telemetry
        self.offload_exec = True
        self.transfer_lane: Optional[TransferLane] = None
        # the reference's perf switches (set by ``launch/steps.py``):
        # the residual stream's placements on a mesh (DTensor
        # placements; None leaves them to DTensor's propagation), logits
        # in fp32, and prefill logits for the last position only
        self.act_sharding = None
        self.logits_f32 = True
        self.last_logits_only = False

    def _constrain(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on ``act_sharding`` (a plain tensor, or no
        ``act_sharding``: ``x``)."""
        return D.constrain(x, self.act_sharding)

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

    def _chunk_bounds(self) -> List[Tuple[int, int]]:
        """Scan mode's layer chunks (the reference's ``_chunk_bounds``)."""
        L_ = self.cfg.num_layers
        if self.cfg.sliding_window and self.cfg.global_interval:
            # type-homogeneous chunks: runs of local layers and global
            # singletons, so each chunk has one local/global flag
            bounds, s = [], 0
            for i in range(L_):
                if self._is_global(i):
                    if i > s:
                        bounds.append((s, i))
                    bounds.append((i, i + 1))
                    s = i + 1
            if s < L_:
                bounds.append((s, L_))
            return bounds
        K = max(1, min(self.cfg.scan_chunks, L_))
        step = math.ceil(L_ / K)
        return [(s, min(s + step, L_)) for s in range(0, L_, step)]

    def _chunk_flag(self, s: int, e: int) -> bool:
        """The local/global flag of a chunk (True for a mixed one)."""
        flags = {self._is_global(i) for i in range(s, e)}
        return flags.pop() if len(flags) == 1 else True

    def unit_bounds(self) -> List[Tuple[int, int]]:
        """The decoder layers [s, e) of each decoder plan unit, in
        forward order."""
        if self.cfg.remat_mode == "scan":
            return self._chunk_bounds()
        return [(i, i + 1) for i in range(self.cfg.num_layers)]

    def plan_unit_layers(self) -> List[Tuple[str, int, int]]:
        """``(stack, s, e)`` of every plan unit in forward order: the
        encoder's layers (stack ``"encoder.blocks"``, one unit each),
        then the decoder's units (``"blocks"``); ``stack.<i>.`` prefixes
        the parameter names of layer i."""
        return ([("encoder.blocks", i, i + 1)
                 for i in range(self.cfg.encoder_layers)]
                + [("blocks", s, e) for s, e in self.unit_bounds()])

    # -- forward -----------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor],
                actions=None) -> torch.Tensor:
        """Logits (B, S, V) in fp32 (``forward_aux`` also returns the
        auxiliary loss); S counts the vision prefix."""
        return self.forward_aux(batch, actions)[0]

    def _mrope_positions(self, B: int, St: int, device) -> torch.Tensor:
        """(3, B, vt + St) M-RoPE positions: the vision patches at t = 0
        on a side x side grid (h, w), the text at ``side + arange(St)``
        on all three streams."""
        vt = self.cfg.vision_tokens
        side = max(int(math.sqrt(vt)), 1)
        idx = torch.arange(vt, device=device)
        text = torch.arange(St, device=device) + side
        three = torch.stack([torch.cat([torch.zeros_like(idx), text]),
                             torch.cat([idx // side, text]),
                             torch.cat([idx % side, text])])
        return three[:, None, :].expand(3, B, vt + St)

    def _embed_inputs(self, batch):
        """(x, positions (B, S), M-RoPE positions (3, B, S) or None): the
        token embeddings, behind the vision prefix for the vlm family."""
        tokens = batch["tokens"]
        B, St = tokens.shape
        x = D.embed_lookup(self.embed, tokens)
        mrope_positions = None
        if self.vision:
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
            S = x.shape[1]
            positions = torch.arange(S, device=x.device).expand(B, S)
            if self.cfg.mrope:
                mrope_positions = self._mrope_positions(B, St, x.device)
        else:
            positions = batch.get("positions")
            if positions is None:
                positions = torch.arange(St, device=x.device).expand(B, St)
        return x, positions, mrope_positions

    def forward_aux(self, batch: Dict[str, torch.Tensor], actions=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(logits (B, S, V), the blocks' summed auxiliary loss or None);
        the logits in fp32 unless ``logits_f32`` is off, and at the last
        position only (B, 1, V) with ``last_logits_only``.  ``actions``:
        per-unit plan (bools or ``Action``), the encoder's units first; every layer of a REMAT unit is
        checkpointed, every layer input of an OFFLOAD unit goes to host
        memory.  ``lengths`` ((B,) true text lengths of a bucket-padded
        batch; the vision prefix is added to them) are threaded into
        every decoder block's mixer; the encoder runs over every frame,
        as the reference's."""
        cfg = self.cfg
        x, positions, mrope_positions = self._embed_inputs(batch)
        x = self._constrain(x)
        seq_lens = batch.get("lengths")
        if seq_lens is not None:
            seq_lens = seq_lens.to(device=x.device, dtype=torch.int32)
            if self.vision:
                seq_lens = seq_lens + cfg.vision_tokens
        n = self.num_plan_units()
        acts = (as_actions(actions) if actions is not None
                else (Action.KEEP,) * n)
        if len(acts) != n:
            raise ValueError(f"plan has {len(acts)} actions for {n} units")
        ne = cfg.encoder_layers
        # one chain over both stacks: the backward walks the decoder's
        # inputs, then the encoder's
        chain = self._offload_chain(acts)
        enc_out = self.encode(batch, acts[:ne], chain) if ne else None
        x, aux = self.blocks_forward(x, acts[ne:], positions, seq_lens,
                                     enc_out=enc_out,
                                     mrope_positions=mrope_positions,
                                     chain=chain)
        return self._head(x), aux

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the vocabulary projection, under
        ``last_logits_only`` and ``logits_f32``."""
        if self.last_logits_only:
            x = x[:, -1:]
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        head = self.embed.t() if self.lm_head is None else self.lm_head
        logits = x @ head
        return logits.float() if self.logits_f32 else logits

    def lane(self) -> TransferLane:
        """The transfer lane OFFLOAD units copy through."""
        if self.transfer_lane is None:
            self.transfer_lane = TransferLane(self.device)
        return self.transfer_lane

    def _offload_chain(self, actions) -> Optional[_OffloadChain]:
        """The chain OFFLOAD layers send their inputs through, when the
        plan has one that executes (``offload_exec`` on, grad on)."""
        if (Action.OFFLOAD in actions and self.offload_exec
                and torch.is_grad_enabled()):
            return _OffloadChain(self.lane())
        return None

    def _layer(self, act, fn, x, params, extra, chain):
        """``fn(x, *extra) -> (y, aux)``, one layer, under ``act``: KEEP
        runs it; REMAT checkpoints it (non-reentrant); OFFLOAD sends x to
        the host through ``chain`` (``_OffloadLayer``; as REMAT without a
        chain).  ``extra``: other tensors the layer reads, each given its
        gradient."""
        if act is Action.OFFLOAD and chain is not None:
            out = _OffloadLayer.apply(x, fn, chain, len(extra), *extra,
                                      *params)
            return out if isinstance(out, tuple) else (out, None)
        if act in (Action.REMAT, Action.OFFLOAD):
            return checkpoint(fn, x, *extra, use_reentrant=False)
        return fn(x, *extra)

    def encode(self, batch, actions, chain=None) -> torch.Tensor:
        """The bidirectional encoder over the stub ``frames`` (B, F, d),
        one ``actions`` entry per encoder layer, then its own final norm
        (the reference's ``_encode``: no lengths)."""
        cfg = self.cfg
        x = batch["frames"].to(self.dtype)
        B, F = x.shape[:2]
        pos = torch.arange(F, device=x.device).expand(B, F)
        acts = as_actions(actions)
        chain = chain or self._offload_chain(acts)
        for act, blk in zip(acts, self.encoder.blocks):
            def one(xx, _blk=blk):
                return block_apply(_blk, cfg, xx, "enc", positions=pos,
                                   impl=self.attn_impl)
            x, _ = self._layer(act, one, x, list(blk.parameters()), (),
                               chain)
        return L.rmsnorm_apply(self.encoder.final_norm, x, cfg.norm_eps)

    def blocks_forward(self, x: torch.Tensor, actions, positions,
                       seq_lens=None, *, enc_out=None, mrope_positions=None,
                       chain=None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Every decoder block under ``actions`` (one per decoder unit;
        each layer of a unit under ``_layer``); a decoder layer reads
        ``enc_out`` as a tensor input, so its gradient reaches the
        encoder under every action.  Returns the last block's output and
        the summed auxiliary loss (None when no block has one).  Each
        layer's output, and each of its branches' outputs, is put on
        ``act_sharding`` (the reference's constraint point)."""
        bounds = self.unit_bounds()
        acts = (as_actions(actions) if actions is not None
                else (Action.KEEP,) * len(bounds))
        if len(acts) != len(bounds):
            raise ValueError(f"plan has {len(acts)} actions for "
                             f"{len(bounds)} units")
        extra = () if enc_out is None else (enc_out,)
        chain = chain or self._offload_chain(acts)
        pin = None if self.act_sharding is None else self._constrain
        aux = None
        for act, (s, e) in zip(acts, bounds):
            for i in range(s, e):
                def one(xx, *enc, _blk=self.blocks[i],
                        _g=self._is_global(i)):
                    return block_apply(_blk, self.cfg, xx, self.kind,
                                       positions=positions,
                                       layer_is_global=_g,
                                       impl=self.attn_impl,
                                       seq_lens=seq_lens,
                                       enc_out=enc[0] if enc else None,
                                       mrope_positions=mrope_positions,
                                       constrain=pin)
                x, a = self._layer(act, one, x,
                                   list(self.blocks[i].parameters()),
                                   extra, chain)
                x = self._constrain(x)
                if a is not None:
                    aux = a if aux is None else aux + a
        return x, aux

    def loss(self, batch: Dict[str, torch.Tensor],
             actions=None) -> Tuple[torch.Tensor, dict]:
        """``ce + aux``: ce the weighted mean of (logsumexp - label logit)
        over ``max(sum(weights), 1)`` at the text positions (the vision
        prefix has no labels), aux the blocks' summed auxiliary loss (0
        for families without one).  Metrics: ``ce``, ``aux``,
        ``tokens``."""
        logits, aux = self.forward_aux(batch, actions)
        if self.vision:
            logits = logits[:, self.cfg.vision_tokens:]
        labels = batch["labels"].long()
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones(labels.shape, device=logits.device)
        lse, label_logit = D.ce_terms(logits, labels)
        total_w = weights.float().sum().clamp_min(1.0)
        ce = ((lse - label_logit) * weights).sum() / total_w
        if aux is None:
            return ce, {"ce": ce, "aux": torch.zeros_like(ce),
                        "tokens": total_w}
        return ce + aux, {"ce": ce, "aux": aux, "tokens": total_w}

    # -- decode (serving) ----------------------------------------------------
    # The cache is one dict per decoder layer in both remat modes (the
    # port's parameters are per layer), so the request/batch axis of
    # every leaf is 0: k, v (B, Smax, Hkv, hd) in the model's dtype for
    # the attention kinds, ssm (B, H, P, N) fp32 and conv (B, K - 1,
    # conv_dim) in the model's dtype for ssm and hybrid.  Every cache
    # method runs under ``torch.inference_mode`` (the parameters require
    # grad, and a decode step must build no autograd graph), and writes
    # the cache in place: a caller that wants the old cache clones it.

    @torch.inference_mode()
    def init_cache(self, batch_size: int, max_len: int, device=None, *,
                   cross_frames: Optional[int] = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """A zero cache of ``batch_size`` rows and ``max_len`` positions,
        on ``device`` (the model's by default; ``"meta"`` allocates
        nothing).  The encoder-decoder family's decoder needs each
        request's encoder frames: it has a cache only with
        ``cross_frames``, which adds the reference's cross-attention keys
        and values ``ck``, ``cv`` (B, cross_frames, Hkv, hd) to k and v
        (zeros here: the dry run's decode step reads them as cached)."""
        if self.kind == "dec" and cross_frames is None:
            raise ValueError(
                "encoder/decoder serving needs encoder frames per request;"
                " the continuous-batching engine serves decoder-only "
                "families (dense/moe/ssm/hybrid)")
        cfg, dt = self.cfg, self.dtype
        dev = self.device if device is None else torch.device(device)
        B = batch_size
        one = {}
        hd = cfg.resolved_head_dim()
        if self.kind in ("dense", "moe", "hybrid", "dec"):
            for key in ("k", "v"):
                one[key] = ((B, max_len, cfg.num_kv_heads, hd), dt)
        if self.kind == "dec":
            for key in ("ck", "cv"):
                one[key] = ((B, cross_frames, cfg.num_kv_heads, hd), dt)
        if self.kind in ("ssm", "hybrid"):
            _, H, N, conv_dim = M.mamba2_dims(cfg)
            one["ssm"] = ((B, H, cfg.ssm_head_dim, N), torch.float32)
            one["conv"] = ((B, cfg.conv_kernel - 1, conv_dim), dt)
        return [{k: torch.zeros(shape, dtype=d, device=dev)
                 for k, (shape, d) in one.items()}
                for _ in range(cfg.num_layers)]

    def cache_batch_axis(self) -> int:
        """The request/batch axis of every cache leaf: 0 in both modes
        (the reference stacks a leading layer axis in scan mode)."""
        return 0

    @staticmethod
    def _rows(leaf: torch.Tensor, slot, n: int) -> slice:
        """Rows ``[slot, slot + n)`` with the start clamped to ``[0,
        B - n]``, as ``jax.lax.dynamic_slice`` clamps it."""
        s = min(max(int(slot), 0), leaf.shape[0] - n)
        return slice(s, s + n)

    @torch.inference_mode()
    def cache_insert(self, pool, rows, slot):
        """Write ``rows`` (a cache of >= 1 request rows, such as a
        prefill staging cache) into ``pool`` from batch row ``slot``, in
        place; returns ``pool``.  Shapes match outside the batch axis."""
        for p_layer, r_layer in zip(pool, rows):
            for key, p in p_layer.items():
                r = r_layer[key]
                p[self._rows(p, slot, r.shape[0])] = r.to(p.dtype)
        return pool

    @torch.inference_mode()
    def cache_grow(self, pool, batch_size: int):
        """``pool`` with ``batch_size`` rows: its own rows first, zero
        rows after (the reference's ``cache_insert`` of the pool into a
        new ``init_cache(batch_size, ...)`` at row 0).  Leaf by leaf in
        the layer dicts, so at most one old leaf is alive beside the new
        cache, not the whole old pool; returns ``pool``."""
        for layer in pool:
            for key, p in layer.items():
                grown = p.new_zeros((batch_size, *p.shape[1:]))
                grown[:p.shape[0]] = p
                layer[key] = grown
        return pool

    @torch.inference_mode()
    def cache_extract(self, pool, slot):
        """One request row of ``pool`` as a new batch-1 cache."""
        return [{key: p[self._rows(p, slot, 1)].clone()
                 for key, p in layer.items()} for layer in pool]

    @torch.inference_mode()
    def cache_evict(self, pool, slot):
        """Zero one request row of ``pool`` in place (a freed slot keeps
        no stale state); returns ``pool``."""
        for layer in pool:
            for p in layer.values():
                p[self._rows(p, slot, 1)] = 0
        return pool

    def decode_step(self, tokens: torch.Tensor, cache, index
                    ) -> Tuple[torch.Tensor, list]:
        """tokens: (B, C) integer, C == 1 for token decode or a block of
        the prompt for chunked prefill; ``index``: the position of the
        first token, an int for every row, or a (B,) integer tensor of
        per-row positions (the continuous-batching engine's form; a row
        parked at index == cache length writes nothing).  Returns
        (logits (B, C, V) fp32, cache), the cache advanced by C
        positions in place.  Every mixer runs its plain path, as the
        reference's decode runs ``impl="xla"``; the vlm family decodes
        text only, its M-RoPE streams all at the text positions.  Runs
        under ``torch.inference_mode``, or ``no_grad`` on DTensor
        parameters (DTensor's views cannot be made of parameters in
        inference mode)."""
        grad_off = (torch.no_grad() if D.is_dtensor(self.embed)
                    else torch.inference_mode())
        with grad_off:
            return self._decode_step(tokens, cache, index)

    def _decode_step(self, tokens: torch.Tensor, cache, index
                     ) -> Tuple[torch.Tensor, list]:
        cfg = self.cfg
        B, C = tokens.shape
        x = D.embed_lookup(self.embed, tokens)
        offs = torch.arange(C, device=x.device)
        if isinstance(index, torch.Tensor) and index.ndim >= 1:
            index = index.to(device=x.device, dtype=torch.long)
            positions = index[:, None] + offs[None, :]
        else:
            index = int(index)
            positions = (index + offs).expand(B, C)
        mrope_positions = (positions[None].expand(3, B, C) if cfg.mrope
                           else None)
        for i, (blk, layer_cache) in enumerate(zip(self.blocks, cache)):
            x = block_decode(blk, cfg, x, self.kind, positions=positions,
                             cache=layer_cache, cache_index=index,
                             layer_is_global=self._is_global(i),
                             mrope_positions=mrope_positions)
        x = L.rmsnorm_apply(self.final_norm, x, cfg.norm_eps)
        head = self.embed.t() if self.lm_head is None else self.lm_head
        return (x @ head).float(), cache

    # -- plan units ----------------------------------------------------------
    def num_plan_units(self) -> int:
        return self.cfg.encoder_layers + len(self.unit_bounds())

    def _unit_geometry(self, batch) -> Tuple[int, int, int]:
        """(B, S of the residual stream, F encoder frames) of a batch."""
        B, St = batch["tokens"].shape
        S = St + (self.cfg.vision_tokens if self.vision else 0)
        F = batch["frames"].shape[1] if "frames" in batch else 0
        return int(B), int(S), int(F)

    def plan_unit_meta(self, batch) -> List[Dict[str, Any]]:
        """One dict per plan unit: the static facts the roofline cost
        model needs to price its forward (= its recompute cost)."""
        B, S, F = self._unit_geometry(batch)
        return ([{"kind": "enc", "layers": 1, "batch": B, "seq": F,
                  "is_global": True}
                 for _ in range(self.cfg.encoder_layers)]
                + [{"kind": self.kind, "layers": e - s, "batch": B,
                    "seq": S, "is_global": self._chunk_flag(s, e),
                    "enc_frames": F}
                   for s, e in self.unit_bounds()])

    def unit_input_shape(self, unit: "PlanUnit", batch) -> tuple:
        """The shape of ``unit``'s input at this batch: the encoder's
        stream (B, F, d) for an encoder unit, else the residual stream
        (B, S, d), S counting the vision prefix."""
        B, S, F = self._unit_geometry(batch)
        seq = F if unit.index < self.cfg.encoder_layers else S
        return (B, seq, self.cfg.d_model)

    def plan_units(self, batch) -> List[PlanUnit]:
        """Ordered plannable units, the encoder's first.  Each
        ``apply(params, x)`` builds its positions from ``x`` (no lengths,
        as in the reference; M-RoPE's three streams all ``arange(S)``,
        since only shapes matter to the collector), and a decoder unit
        of an encoder-decoder reads a zero encoder output of the batch's
        geometry, so the collector can run it on ``meta`` tensors.  A
        scan-mode unit's params are the list of its layers' trees."""
        cfg = self.cfg
        scan = cfg.remat_mode == "scan"
        B, _, F = self._unit_geometry(batch)
        units = []
        for i in range(cfg.encoder_layers):
            def enc_fn(p, xx):
                Bx, Fx = xx.shape[:2]
                pos = torch.arange(Fx, device=xx.device).expand(Bx, Fx)
                return block_apply(p, cfg, xx, "enc", positions=pos,
                                   impl=self.attn_impl)[0]
            units.append(PlanUnit(f"enc{i}", i, self.encoder.blocks[i],
                                  enc_fn, signature=("enc",)))
        # a decoder unit closes over the encoder's output: its geometry
        # is part of the signature, or residuals collected at one frame
        # count would be replayed at another
        enc_sig = (B, F, cfg.d_model) if cfg.encoder_layers else None
        for u, (s, e) in enumerate(self.unit_bounds()):
            flag = self._chunk_flag(s, e)

            def unit_fn(p, xx, _g=flag):
                Bx, Sx = xx.shape[:2]
                pos = torch.arange(Sx, device=xx.device).expand(Bx, Sx)
                mpos = pos[None].expand(3, Bx, Sx) if cfg.mrope else None
                enc = (None if enc_sig is None else
                       torch.zeros((Bx, F, cfg.d_model), dtype=xx.dtype,
                                   device=xx.device))
                for lp in (p if scan else [p]):
                    xx, _ = block_apply(lp, cfg, xx, self.kind,
                                        positions=pos, layer_is_global=_g,
                                        impl=self.attn_impl, enc_out=enc,
                                        mrope_positions=mpos)
                return xx
            tail = () if enc_sig is None else (enc_sig,)
            index = cfg.encoder_layers + u
            if scan:
                units.append(PlanUnit(f"chunk{u}[{s}:{e}]", index,
                                      list(self.blocks[s:e]), unit_fn,
                                      signature=("chunk", flag, e - s)
                                      + tail))
            else:
                units.append(PlanUnit(f"block{s}", index, self.blocks[s],
                                      unit_fn,
                                      signature=("block", flag) + tail))
        return units


def configure_offload(lm: LM, lane: Optional[TransferLane] = None) -> bool:
    """Make ``lm`` execute OFFLOAD for real, through ``lane`` when given.
    Returns whether OFFLOAD degrades to REMAT: never in the port (one
    device needs no mesh probe; a failing copy raises instead), so the
    launcher's fallback counter stays 0."""
    lm.offload_exec = True
    if lane is not None:
        lm.transfer_lane = lane
    return False
