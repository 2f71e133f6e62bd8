"""Sharding rules: parameter, optimizer-state, batch and cache specs per
model family, the counterpart of the reference's ``sharding/specs.py``.

Mesh axes:
  * ``data``  -- batch (and sequence, for the long-context decode shape)
  * ``model`` -- tensor parallel: attention heads / MLP hidden / experts
  * ``pod``   -- optional outer data-parallel axis across pods

Scheme (megatron-style 1D tensor parallel + expert parallel):
  * column-parallel: wq/wk/wv, mlp wi/wg, mamba in_proj  -> (None, 'model')
  * row-parallel:    wo, mlp wo, mamba out_proj          -> ('model', None)
  * embeddings vocab-sharded over 'model'
  * MoE expert weights (E, d, f) sharded ('model', None, None): expert
    parallel
  * scan-stacked params get a leading None for the layer axis
  * optional ZeRO-1: optimizer moments additionally sharded over 'data'
    on the first unsharded divisible axis

A spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (``("pod",
"data")``); it compares element by element with the reference's
``PartitionSpec``.  A path is a tensor's state-dict key split at the
dots (``blocks.3.attn.wq``), which ``bridge.py`` makes the reference's
tree path.  In scan mode the reference stacks the layers into ``(L,
...)`` leaves under ``blocks``; the port keeps one tensor per layer, and
``reference_leaves`` regroups them into the reference's layout, so every
rule is evaluated on the same shapes as there.

The ``*_shardings`` functions return, per named tensor, its spec and
the ``torch.distributed.tensor`` placements on a ``DeviceMesh`` (one
``Shard(dim)`` or ``Replicate()`` per mesh dimension).  A stacked
leaf's spec loses its layer entry on the per-layer tensors.  Nothing on
the training path distributes tensors: the launcher plans per device and
keeps inputs replicated, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import torch

_COLUMN = {"wq", "wk", "wv", "wi", "wg", "in_proj", "conv_w"}
_ROW = {"wo", "out_proj"}


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a ``MeshBudget``
    (a mesh shape this process cannot build)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return mesh.axis_dict


def _data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _shape(leaf) -> tuple:
    return tuple(int(s) for s in getattr(leaf, "shape", leaf))


def _names(path) -> tuple:
    return tuple(path.split(".")) if isinstance(path, str) else tuple(path)


# ---------------------------------------------------------------------------
# the reference's parameter layout
# ---------------------------------------------------------------------------

def _named(params) -> Iterable[Tuple[str, torch.Tensor]]:
    if hasattr(params, "named_parameters"):
        return params.named_parameters()
    return params.items()


def reference_leaves(params, *, scanned: bool
                     ) -> List[Tuple[str, tuple, torch.dtype, List[str]]]:
    """``(reference key, shape, dtype, port names)`` of every leaf of
    the reference's parameter tree.  Unrolled, each port tensor is its
    own leaf.  ``scanned``: the tensors ``blocks.<i>.<rest>`` become one
    leaf ``blocks.<rest>`` of shape ``(L,) + shape``, as the reference
    stacks them; everything else (the encoder's layers too) stays as it
    is.  ``params``: a module or a ``{name: tensor}`` mapping."""
    out, stacks = [], {}
    for name, t in _named(params):
        parts = name.split(".")
        if scanned and parts[0] == "blocks" and parts[1].isdigit():
            rest = ".".join(parts[2:])
            if rest not in stacks:
                stacks[rest] = len(out)
                out.append([f"blocks.{rest}", tuple(t.shape), t.dtype, []])
            out[stacks[rest]][3].append(name)
        else:
            out.append([name, tuple(t.shape), t.dtype, [name]])
    for leaf in out:
        if leaf[0] != leaf[3][0]:
            leaf[1] = (len(leaf[3]),) + leaf[1]
    return [tuple(leaf) for leaf in out]


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_spec(path, leaf, *, scanned: bool, model_dim: int,
               attn_replicated: bool = False, expert_2d: bool = False,
               data_dim: int = 0) -> tuple:
    """The spec of one parameter, from its path and shape (``leaf``: a
    tensor or a shape).

    ``attn_replicated`` turns tensor parallelism off for the attention
    projections (they stay data-parallel-replicated, MLP/MoE keep TP);
    ``expert_2d`` spreads expert weights over data x model."""
    names = _names(path)
    leafname = names[-1]
    shape = _shape(leaf)
    if attn_replicated and ("attn" in names or "cross" in names):
        return (None,) * len(shape)
    lead = (None,) if (scanned and "blocks" in names) else ()
    body_rank = len(shape) - len(lead)

    def ok(dim_from_end: int) -> bool:
        return shape[len(shape) - dim_from_end] % model_dim == 0

    if leafname in ("embed", "lm_head"):
        if leafname == "embed" and shape[0] % model_dim == 0:
            return ("model", None)
        if leafname == "lm_head" and shape[1] % model_dim == 0:
            return (None, "model")
        return (None, None)
    if leafname == "router":
        return lead + (None, None)
    if leafname in ("wi", "wg", "wo") and body_rank == 3:
        # stacked expert weights (E, d, f): expert parallel
        E, d2, d3 = shape[len(lead):]
        if expert_2d and data_dim and E % data_dim == 0:
            # experts over 'data', hidden over 'model'
            if leafname == "wo" and d2 % model_dim == 0:
                return lead + ("data", "model", None)
            if leafname != "wo" and d3 % model_dim == 0:
                return lead + ("data", None, "model")
            return lead + ("data", None, None)
        if E % model_dim == 0:
            return lead + ("model", None, None)
        return lead + (None, None, None)
    if leafname in _COLUMN and body_rank == 2:
        return lead + ((None, "model") if ok(1) else (None, None))
    if leafname in _ROW and body_rank == 2:
        return lead + (("model", None) if ok(2) else (None, None))
    # everything else (norm scales, biases, A_log, dt_bias, D, scalars)
    return (None,) * len(shape)


def moment_spec(spec: tuple, shape, data_axes: tuple, data_dim: int, *,
                zero1: bool) -> tuple:
    """An AdamW moment's spec: its parameter's, plus ZeRO-1's ``data``
    sharding on the first unsharded axis the data ways divide."""
    shape = _shape(shape)
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if zero1:
        for i, s in enumerate(spec):
            if s is None and shape[i] % data_dim == 0:
                spec[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                break
    return tuple(spec)


def placements(spec: tuple, mesh) -> list:
    """The ``torch.distributed.tensor`` placements of ``spec`` on
    ``mesh``: per mesh dimension, ``Shard(i)`` where tensor dimension
    ``i`` names its axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def params_shardings(params, mesh, *, scanned: bool,
                     attn_replicated: bool = False,
                     expert_2d: bool = False) -> Dict[str, tuple]:
    """``{name: (spec, placements)}`` for every parameter of ``params``
    (a module or mapping) on ``mesh``; each rule reads the reference's
    leaf, and a stacked leaf's per-layer tensors take its spec without
    the layer entry."""
    axes = axis_sizes(mesh)
    out = {}
    for key, shape, _, members in reference_leaves(params, scanned=scanned):
        spec = param_spec(key, shape, scanned=scanned,
                          model_dim=axes["model"],
                          attn_replicated=attn_replicated,
                          expert_2d=expert_2d, data_dim=axes.get("data", 1))
        if key != members[0]:
            spec = spec[1:]
        for name in members:
            out[name] = (spec, placements(spec, mesh))
    return out


def opt_state_shardings(params_sh: Mapping[str, tuple], params, mesh, *,
                        zero1: bool = False) -> dict:
    """AdamW state: ``step`` replicated; ``m`` and ``v`` like the
    parameters, optionally ZeRO-1 (on each tensor's own axes)."""
    data_axes = _data_axes(mesh)
    axes = axis_sizes(mesh)
    data_dim = 1
    for a in data_axes:
        data_dim *= axes[a]
    moments = {}
    for name, t in _named(params):
        spec = moment_spec(params_sh[name][0], t.shape, data_axes, data_dim,
                           zero1=zero1)
        moments[name] = (spec, placements(spec, mesh))
    return {"step": ((), placements((), mesh)), "m": moments,
            "v": dict(moments)}


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def batch_spec(name: str, shape, mesh, shard_sequence: bool = False
               ) -> tuple:
    """Input tensors.  Normally batch over data; the long-context decode
    shape (batch=1) shards the sequence axis over data instead."""
    shape = _shape(shape)
    data = _data_axes(mesh)
    data = data if len(data) > 1 else data[0]
    if name == "lengths":                 # (B,) per-sequence true lengths
        return (data,)
    if name in ("tokens", "labels", "weights", "positions"):
        if shard_sequence:
            return (None, data)
        return (data,) + (None,) * (len(shape) - 1)
    if name in ("vision_embeds", "frames"):
        if shard_sequence:
            return (None, data, None)
        return (data, None, None)
    return (None,) * len(shape)


def cache_spec(name: str, shape, mesh, shard_sequence: bool = False
               ) -> tuple:
    """KV / SSM caches, per layer (a leading None where stacked).

    Attention KV: (B, S, Hkv, hd) -- batch over data, kv heads over
    model when divisible (else sequence over model).  SSM state: (B, H,
    P, N) -- heads over model.  Conv buffer: (B, K-1, C) -- channels
    over model."""
    shape = _shape(shape)
    data = _data_axes(mesh)
    data = data if len(data) > 1 else data[0]
    model_dim = axis_sizes(mesh)["model"]
    if name in ("k", "v", "ck", "cv"):
        B, S, Hkv, hd = shape[-4:]
        lead = (None,) * (len(shape) - 4)
        batch_ax = None if shard_sequence else data
        seq_ax = data if shard_sequence else None
        head_ax = "model" if Hkv % model_dim == 0 else None
        if head_ax is None and seq_ax is None and S % model_dim == 0:
            seq_ax = "model"
        return lead + (batch_ax, seq_ax, head_ax, None)
    if name == "ssm":
        B, H, Pd, N = shape[-4:]
        lead = (None,) * (len(shape) - 4)
        head_ax = "model" if H % model_dim == 0 else None
        return lead + (None if shard_sequence else data, head_ax, None, None)
    if name == "conv":
        B, K, C = shape[-3:]
        lead = (None,) * (len(shape) - 3)
        ch_ax = "model" if C % model_dim == 0 else None
        return lead + (None if shard_sequence else data, None, ch_ax)
    return (None,) * len(shape)


def batch_shardings(batch: Mapping[str, torch.Tensor], mesh,
                    shard_sequence: bool = False) -> Dict[str, tuple]:
    """``{key: (spec, placements)}`` for every entry of ``batch``."""
    out = {}
    for key, t in batch.items():
        spec = batch_spec(key, t.shape, mesh, shard_sequence)
        out[key] = (spec, placements(spec, mesh))
    return out


def cache_shardings(cache, mesh, shard_sequence: bool = False) -> list:
    """The port's cache (one dict per layer in both modes): per layer,
    ``{key: (spec, placements)}``."""
    out = []
    for layer in cache:
        one = {}
        for key, t in layer.items():
            spec = cache_spec(key, t.shape, mesh, shard_sequence)
            one[key] = (spec, placements(spec, mesh))
        out.append(one)
    return out
