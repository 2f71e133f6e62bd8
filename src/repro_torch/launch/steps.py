"""Step builders, abstract input specs and per-device counts for every
(arch x input shape), the counterpart of the reference's
``launch/steps.py``.

Parameters, AdamW moments, batches and caches are DTensors on a
``DeviceMesh``, at the placements ``sharding/specs.py`` gives them
(ZeRO-1's moments included).  On ``meta`` nothing is allocated: under a
fake process group as large as the mesh (``launch/dryrun.py`` makes one)
a single process builds the full mesh, rank 0's shards are meta tensors,
and ``count_setup`` runs the step once on them -- the counterpart of the
reference's ``lower`` + ``compile`` + cost and memory analyses.  On a
real mesh (a one-rank ``nccl`` or ``gloo`` group, or one process per
device) ``Setup.fn`` is a step that executes: the train step is the
trainer's (``lm.loss``, the backward, AdamW) with each gradient reduced
to its parameter's placements before the update.

    setup = build_setup(get_config("qwen3_1p7b"), INPUT_SHAPES["train_4k"],
                        mesh)
    counts = count_setup(setup, mesh)      # rank 0's FLOPs, bytes, ...
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.actions import as_actions
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.sharding import dtensor as D
from repro_torch.sharding import specs as SP

# the HBM a device plans against: the H100 SXM5's 80 GiB (the reference
# plans a TPU v5e's 16 GiB)
HBM_PER_DEVICE = 80 * 2**30

def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, ("skipped: pure full-attention architecture; 500k-token "
                       "decode requires sub-quadratic attention (DESIGN.md §4)")
    return True, ""


# ---------------------------------------------------------------------------
# abstract batch specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for the mini-batch of this input shape: the
    reference's keys and shapes in the port's batch dtypes."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _struct((B, 1), torch.long)}
    text_len = S
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm" and cfg.vision_tokens:
        text_len = S - cfg.vision_tokens
        batch["vision_embeds"] = _struct((B, cfg.vision_tokens, cfg.d_model),
                                         torch.float32)
    if cfg.family == "encdec":
        batch["frames"] = _struct((B, S, cfg.d_model), torch.float32)
    batch["tokens"] = _struct((B, text_len), torch.long)
    if shape.kind == "train":
        batch["labels"] = _struct((B, text_len), torch.long)
        batch["weights"] = _struct((B, text_len), torch.float32)
        # true per-sequence lengths (full length in a dry run)
        batch["lengths"] = _struct((B,), torch.int32)
    return batch


# ---------------------------------------------------------------------------
# remat plan for the dry run
# ---------------------------------------------------------------------------

def plan_remat_mask(lm: LM, batch, *, mode, mesh,
                    hbm_per_chip: float = HBM_PER_DEVICE,
                    zero1: bool = False,
                    seq_parallel: bool = False,
                    attn_replicated: bool = False,
                    expert_2d: bool = False,
                    cost_aware: bool = True,
                    offload: bool = False,
                    pcie_gbps: float = 16.0,
                    max_microbatches: int = 1) -> Tuple[tuple, int]:
    """Returns ``(actions, microbatch)``: the per-unit action plan and
    the gradient-accumulation split the planner chose.  ``mode``:
    ``"none"``, ``"all"``, ``"mimose"`` (the input-aware planner against
    the per-device budget of ``mesh``, its fixed bytes the parameter and
    moment shards under the same policy flags the shardings use), or an
    explicit plan (a sequence of actions, run at k = 1).  The planner
    reads the parameters from ``lm`` (plain tensors: plan before they
    are distributed) and ``batch`` is the global batch."""
    n = lm.num_plan_units()
    if not isinstance(mode, str):
        acts = as_actions(mode)
        if len(acts) != n:
            raise ValueError(f"plan has {len(acts)} actions for {n} units")
        return acts, 1
    if mode == "none":
        return tuple([False] * n), 1
    if mode == "all":
        return tuple([True] * n), 1
    if mode != "mimose":
        raise ValueError(f"remat must be none, all, mimose or a plan, "
                         f"not {mode!r}")
    from repro_torch.core.planner import MimosePlanner
    from repro_torch.sharding.budget import MeshBudget
    budget = MeshBudget.from_mesh(mesh, hbm_per_chip, zero1=zero1,
                                  seq_parallel=seq_parallel,
                                  attn_replicated=attn_replicated,
                                  expert_2d=expert_2d)
    planner = MimosePlanner(lm, mesh_budget=budget,
                            warmup_samples=1, quantum=1,
                            cost_aware=cost_aware,
                            offload=offload, pcie_gbps=pcie_gbps,
                            max_microbatches=max_microbatches)
    mask, info = planner.plan(batch)
    return mask, max(int(info.plan.microbatch), 1)


# ---------------------------------------------------------------------------
# placing tensors on the mesh
# ---------------------------------------------------------------------------

def place(tree, shardings, mesh):
    """Every tensor of ``tree`` (dicts and lists of tensors) as a
    DTensor at its placements in ``shardings`` (``specs.*_shardings``),
    this rank's chunk of it (``dtensor.local_shard``); a DTensor is
    redistributed."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, s, mesh) for v, s in zip(tree, shardings)]
    placements = shardings[1]
    if D.is_dtensor(tree):
        return tree.redistribute(mesh, placements)
    return D.local_shard(tree, mesh, placements)


def zeros_placed(shape, dtype, mesh, placements, device) -> torch.Tensor:
    """A zero DTensor of global ``shape`` that allocates only this
    rank's shard (on ``device``)."""
    from torch.distributed.tensor import DTensor
    probe = D.local_shard(torch.empty(shape, dtype=dtype, device="meta"),
                          mesh, placements)
    local = torch.zeros(probe.to_local().shape, dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=probe.shape, stride=probe.stride())


def init_opt_state(params: Dict[str, torch.Tensor], o_sh: dict, mesh,
                   device) -> AdamWState:
    """AdamW's zero state with m and v at their placements (fp32, as
    ``AdamW.init``); ``device`` is where the shards live."""
    def zeros():
        return {n: zeros_placed(p.shape, torch.float32, mesh,
                                o_sh["m"][n][1], device)
                for n, p in params.items()}
    return AdamWState(0, zeros(), zeros())


@torch.no_grad()
def sharded_update(opt: AdamW, grads: Dict[str, torch.Tensor],
                   state: AdamWState, params: Dict[str, torch.Tensor],
                   moment_placements: Dict[str, list]) -> AdamWState:
    """``opt``'s update on DTensors: the clip norm over the gradients at
    their parameters' placements, then AdamW on each moment's shard.
    Under ZeRO-1 a moment holds a slice of its parameter, so the update
    runs on that slice of the parameter and gradient and the new
    parameter is gathered back to its own placements (the collective
    that rebuilds the parameters from the moment shards).  Without it
    this is ``opt.update``, arithmetic for arithmetic."""
    cur = opt.begin(grads, state)
    local = {n: D.constrain(p, moment_placements[n])
             for n, p in params.items()}
    g = {n: D.constrain(grads[n], moment_placements[n]) for n in params}
    state = opt.apply(cur, g, state, local)
    for n, p in params.items():
        if local[n] is not p:
            p.copy_(D.constrain(local[n], p.placements))
    return state


# ---------------------------------------------------------------------------
# setups: (step fn, example args, in shardings, out shardings)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Setup:
    name: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    remat_mask: Optional[tuple] = None
    # gradient-accumulation split of the train step (1 = full batch)
    microbatch: int = 1


def _residual_placements(mesh, seq_parallel: bool) -> list:
    """The residual stream's placements: batch over the data axes,
    replicated over ``model`` (Megatron's tensor parallelism), or with
    ``seq_parallel`` the sequence over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(1) if (a == "model" and seq_parallel)
            else Replicate() if a == "model" else Shard(0)
            for a in mesh.mesh_dim_names]


def build_setup(arch_cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                remat="mimose", zero1: bool = False,
                seq_parallel: bool = False, logits_f32: bool = True,
                attn_replicated: bool = False,
                prefill_last_only: bool = False,
                remat_policy: str = "",
                expert_2d: bool = False,
                attn_impl: str = "xla",
                offload: bool = False,
                pcie_gbps: float = 16.0,
                max_microbatches: int = 1,
                device="meta", seed: int = 0,
                optimizer: Optional[AdamW] = None) -> Setup:
    """The step of ``shape``'s kind on ``mesh``: ``train_step(params,
    opt_state, batch, actions=None) -> (params, opt_state, loss)``
    (parameters and moments updated in place, as the trainer's;
    ``actions`` replaces the planned mask for one call),
    ``prefill_step(params, batch) -> logits`` or ``serve_step(params,
    batch, cache, index) -> (logits, cache)``.

    ``device="meta"`` builds everything on ``meta`` (the dry run);
    another device builds the model there from ``seed`` (the LM's own
    initialisation) and places its weights on the mesh.  ``remat``:
    ``plan_remat_mask``'s ``mode``.  ``remat_policy`` names a
    ``jax.checkpoint_policies`` policy, which has no torch counterpart:
    a non-empty one raises.  OFFLOAD units run as REMAT on a mesh (their
    transfer lane copies plain tensors), as the reference degrades them
    where the mesh cannot shard its host-offload calls; the plan keeps
    its typed actions."""
    if remat_policy:
        raise ValueError(
            f"remat_policy={remat_policy!r}: jax.checkpoint_policies has no "
            f"torch counterpart; the port rematerialises whole units")
    lm = LM(arch_cfg, attn_impl=attn_impl, device=device, seed=seed)
    lm.logits_f32 = logits_f32
    if offload:
        lm.offload_exec = False
    if prefill_last_only and shape.kind == "prefill":
        lm.last_logits_only = True
    dev = lm.device
    scanned = arch_cfg.remat_mode == "scan"
    p_sh = SP.params_shardings(lm, mesh, scanned=scanned,
                               attn_replicated=attn_replicated,
                               expert_2d=expert_2d)
    batch = input_specs(arch_cfg, shape)
    repl = SP.placements((), mesh)

    if shape.kind == "train":
        opt = optimizer if optimizer is not None else AdamW()
        o_sh = SP.opt_state_shardings(p_sh, lm, mesh, zero1=zero1)
        mask, microbatch = plan_remat_mask(
            lm, batch, mode=remat, mesh=mesh, zero1=zero1,
            seq_parallel=seq_parallel, attn_replicated=attn_replicated,
            expert_2d=expert_2d,
            offload=offload, pcie_gbps=pcie_gbps,
            max_microbatches=max_microbatches)
        params = D.distribute_parameters(lm, p_sh, mesh)
        lm.act_sharding = _residual_placements(mesh, seq_parallel)
        opt_state = init_opt_state(params, o_sh, mesh, dev)
        b_sh = SP.batch_shardings(batch, mesh, shard_sequence=False)
        moment_pl = {n: pl for n, (_, pl) in o_sh["m"].items()}

        def train_step(params, opt_state, b, actions=None):
            acts = mask if actions is None else actions
            with implicit_replication():
                if microbatch > 1:
                    # the planner split the batch: the k-way accumulated
                    # step (the split happens inside, on the unsplit
                    # bucket-shaped batch's shards)
                    from repro_torch.train.accumulate import (
                        accumulated_grads)
                    loss, _, grads = accumulated_grads(lm, b, microbatch,
                                                       acts)
                else:
                    loss, _ = lm.loss(b, acts)
                    grads = dict(zip(params, torch.autograd.grad(
                        loss, list(params.values()), allow_unused=True)))
                # each gradient on its parameter's placements: the
                # reduction over the data axes the reference's
                # partitioner inserts, one gradient at a time, so each
                # unreduced one is freed once its reduced one exists
                for n, p in params.items():
                    g = grads[n]
                    grads[n] = D.constrain(
                        torch.zeros_like(p) if g is None else g,
                        p.placements)
                del g
                new_o = sharded_update(opt, grads, opt_state, params,
                                       moment_pl)
            return params, new_o, loss.detach()

        return Setup("train_step", train_step, (params, opt_state, batch),
                     (p_sh, o_sh, b_sh), (p_sh, o_sh, repl),
                     donate_argnums=(0, 1), remat_mask=mask,
                     microbatch=microbatch)

    params = D.distribute_parameters(lm, p_sh, mesh)
    lm.act_sharding = _residual_placements(mesh, seq_parallel)
    if shape.kind == "prefill":
        b_sh = SP.batch_shardings(batch, mesh)
        vocab_ax = ("model" if arch_cfg.vocab_size % SP.axis_sizes(
            mesh)["model"] == 0 else None)
        data = SP._data_axes(mesh)
        logits_spec = (data if len(data) > 1 else data[0], None, vocab_ax)
        logits_sh = (logits_spec, SP.placements(logits_spec, mesh))

        def prefill_step(params, b):
            with torch.no_grad(), implicit_replication():
                return lm.forward(b)

        return Setup("prefill_step", prefill_step, (params, batch),
                     (p_sh, b_sh), logits_sh)

    # decode ---------------------------------------------------------------
    shard_seq = shape.name == "long_500k"
    B = shape.global_batch
    cache = lm.init_cache(
        B, shape.seq_len, device=dev,
        cross_frames=((arch_cfg.encoder_frames or shape.seq_len)
                      if lm.kind == "dec" else None))
    c_sh = SP.cache_shardings(cache, mesh, shard_sequence=shard_seq)
    if shard_seq:
        # long_500k: batch = 1, the (1, 1) tokens stay replicated; the
        # KV / SSM caches carry the sequence sharding instead
        b_sh = {k: ((None,) * t.ndim, SP.placements((None,) * t.ndim,
                                                     mesh))
                for k, t in batch.items()}
    else:
        b_sh = SP.batch_shardings(batch, mesh)
    index = shape.seq_len - 1

    def serve_step(params, b, cache, index):
        with implicit_replication():
            return lm.decode_step(b["tokens"], cache, index)

    return Setup("serve_step", serve_step, (params, batch, cache, index),
                 (p_sh, b_sh, c_sh, repl), (repl, c_sh),
                 donate_argnums=(2,))


def place_args(setup: Setup, mesh) -> tuple:
    """``setup.args`` with the batch (and cache) placed on the mesh at
    ``setup.in_shardings``; the parameters and moments already are."""
    args = list(setup.args)
    for i, (a, sh) in enumerate(zip(args, setup.in_shardings)):
        if i > 0 and isinstance(a, (dict, list)):
            args[i] = place(a, sh, mesh)
    return tuple(args)


# ---------------------------------------------------------------------------
# counting one device's step
# ---------------------------------------------------------------------------

# funcol op name -> the reference's HLO collective kind
_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("broadcast", "collective-permute"))


@dataclasses.dataclass
class StepCounts:
    """Rank 0's figures for one step (``count_setup``)."""
    flops: float                      # matmul FLOPs on the local shards
    bytes: float                      # every op's input + output bytes
    collectives: List[Tuple[str, float]]   # (kind, result bytes)
    arg_bytes: float                  # local shards of the arguments
    temp_bytes: float                 # peak of live temporary bytes


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if D.is_dtensor(t) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter:
    """A dispatch mode that sees each device-local op once.  An op on
    DTensors is handed back (``NotImplemented``) so DTensor runs it, and
    the local ops and collectives it issues come back here; the ops
    DTensor runs on fake tensors to propagate shapes are skipped."""

    def __init__(self, arg_storages):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        counter = self
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Tuple[str, float]] = []
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, Any] = {k: None for k in arg_storages}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if any(issubclass(t, FakeTensor) for t in types) or any(
                        isinstance(t, FakeTensor) for t in _tensors(out)):
                    return out
                counter._record(func, args, kwargs, out, flop_registry)
                return out

        self.mode = Mode()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(key=key, n=n):
            self.live -= n
            self._seen.pop(key, None)
        self._seen[key] = weakref.finalize(st, free)

    def _record(self, func, args, kwargs, out, flop_registry) -> None:
        outs = [t for t in _tensors(out)]
        if func.namespace == "_c10d_functional":
            name = func.__name__
            for prefix, kind in _KINDS:
                if name.startswith(prefix):
                    self.collectives.append(
                        (kind, float(sum(_nbytes(t) for t in outs))))
                    break
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes += float(
                    sum(_nbytes(t) for t in _tensors(args))
                    + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)


def count_setup(setup: Setup, mesh) -> StepCounts:
    """Run ``setup.fn`` once on rank 0's shards (placed on the mesh at
    ``setup.in_shardings``) and count what this device does: FLOPs of
    the matmuls on its local shards (a flop counter around DTensor ops
    would count the global ones), each op's input and output bytes
    (unfused: an upper bound on HBM traffic, where the reference reads
    XLA's figure after fusion), the collectives by kind, the argument
    bytes (local shards of params, moments, batch and cache) and the
    peak of live temporary bytes.  The dry run's ``compile_s`` times
    this."""
    args = place_args(setup, mesh)
    leaves = [_local(t) for t in _tensors(
        [a if not isinstance(a, AdamWState) else [a.m, a.v] for a in args])]
    arg_bytes = float(sum(_nbytes(t) for t in leaves))
    counter = _Counter({t.untyped_storage()._cdata for t in leaves})
    with counter.mode:
        setup.fn(*args)
    return StepCounts(flops=counter.flops, bytes=counter.bytes,
                      collectives=counter.collectives, arg_bytes=arg_bytes,
                      temp_bytes=float(counter.peak))
