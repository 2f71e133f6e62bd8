"""Shuttling online collector (paper §4.2), for PyTorch.

The reference computes a block's residual bytes abstractly with
``jax.eval_shape`` over ``jax.vjp``.  The counterpart here runs the
block's forward on ``meta`` tensors — no FLOPs, no device memory —
under ``torch.autograd.graph.saved_tensors_hooks`` and sums the bytes of
the storages autograd saves for the backward:

* only the unit input requires grad, as the reference differentiates
  with respect to the input alone (params closed over) — residuals that
  only the weight gradients need are not counted;
* the unit's parameters are excluded (they are resident anyway);
* storages are deduplicated by identity (``data_ptr()`` is 0 on meta);
* offloadable bytes are the saved storages seen through a view of two
  or more dimensions;
* optimizer-moment bytes (what OFFLOAD_OPT parks) are the unit's
  parameter count x 8 (fp32 AdamW m + v), input-size independent.

On one device every ``device_*`` quantity equals its global one (the
reference divides them by a mesh's sharding; the port has no mesh).

The collection runs lazily, on the live batch geometry, only when a new
input size appears; identical units are traced once (dedup by signature).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.models.lm import PlanUnit


@dataclasses.dataclass
class UnitRecord:
    name: str
    index: int                 # forward timestamp
    activation_bytes: int      # residuals autograd saves (excluding weights)
    output_bytes: int          # boundary tensor (kept even when rematted)
    param_bytes: int
    # analytic forward FLOPs at the collection geometry (recompute cost)
    flops: float = 0.0
    # residual bytes worth a host copy (matrix-shaped saved tensors)
    offloadable_bytes: int = 0
    device_offloadable_bytes: int = 0
    # fp32 AdamW moment bytes (m + v) of the unit's parameters: what an
    # OFFLOAD_OPT action parks on the host
    opt_bytes: int = 0
    device_opt_bytes: int = 0


@dataclasses.dataclass
class CollectionResult:
    input_size: int            # elements in the mini-batch input tensor
    records: List[UnitRecord]
    collect_time_s: float = 0.0
    traced_units: int = 0      # meta traces actually run
    dedup_hits: int = 0        # units served from an identical unit's trace

    def activation_vector(self) -> np.ndarray:
        return np.array([r.activation_bytes for r in self.records],
                        dtype=np.float64)

    def flops_vector(self) -> np.ndarray:
        return np.array([r.flops for r in self.records], dtype=np.float64)

    def output_vector(self) -> np.ndarray:
        return np.array([r.output_bytes for r in self.records],
                        dtype=np.float64)

    def offloadable_vector(self) -> np.ndarray:
        return np.array([r.offloadable_bytes for r in self.records],
                        dtype=np.float64)

    def device_offloadable_vector(self) -> np.ndarray:
        return np.array([r.device_offloadable_bytes for r in self.records],
                        dtype=np.float64)

    def opt_vector(self) -> np.ndarray:
        """Per-unit fp32 AdamW moment bytes, the OFFLOAD_OPT price
        vector (parameter shapes only)."""
        return np.array([r.opt_bytes for r in self.records],
                        dtype=np.float64)

    def device_opt_vector(self) -> np.ndarray:
        return np.array([r.device_opt_bytes for r in self.records],
                        dtype=np.float64)

    def total_activation_bytes(self) -> int:
        return int(sum(r.activation_bytes for r in self.records))


def _meta_tree(node):
    """The parameter tree (dicts, and lists for a scan-mode chunk's
    layers) with every tensor replaced by a ``meta`` tensor of the same
    shape and dtype."""
    if isinstance(node, torch.Tensor):
        return torch.empty_like(node, device="meta")
    if isinstance(node, (list, tuple)):
        return [_meta_tree(v) for v in node]
    return {k: _meta_tree(v) for k, v in node.items()}


def _leaves(node):
    if isinstance(node, torch.Tensor):
        yield node
    else:
        for v in (node if isinstance(node, (list, tuple))
                  else node.values()):
            yield from _leaves(v)


def unit_residual_bytes(unit: PlanUnit, x_shape, dtype, *,
                        weight_grads: bool = False) -> Dict[str, int]:
    """Residual footprint of one unit at input shape ``x_shape``, from a
    forward on ``meta`` tensors.  ``weight_grads=True`` lets the
    parameters require grad too, so the count also holds what the weight
    gradients need — what a training step really keeps; the planner
    uses the reference's input-only count."""
    params = _meta_tree(unit.params)
    if weight_grads:
        for t in _leaves(params):
            t.requires_grad_(True)
    param_ids = {t.untyped_storage()._cdata for t in _leaves(params)}
    saved: Dict[int, list] = {}          # storage id -> [bytes, >= 2-d view]
    alive = []                           # keeps storage ids from reuse

    def pack(t):
        alive.append(t)
        st = t.untyped_storage()
        if st._cdata not in param_ids:
            entry = saved.setdefault(st._cdata, [st.nbytes(), False])
            entry[1] = entry[1] or t.dim() >= 2
        return t

    x = torch.empty(x_shape, dtype=dtype, device="meta", requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = unit.apply(params, x)
    act = sum(nb for nb, _ in saved.values())
    offl = sum(nb for nb, two_d in saved.values() if two_d)
    return {"activation_bytes": int(act),
            "output_bytes": out.numel() * out.element_size(),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
            "offloadable_bytes": int(min(offl, act))}


def unit_moment_bytes(unit_params) -> float:
    """Fp32 AdamW moment bytes (m + v) owned by one plan unit, the
    per-unit price of OFFLOAD_OPT: ``2 x 4 x n`` per parameter.  A copy
    of the reference's ``sharding/budget.unit_moment_bytes`` without a
    mesh (a scan-mode unit's params are its layers' trees, so every
    layer of the chunk counts, as the stacked leaves do there)."""
    return float(sum(2 * 4 * t.numel() for t in _leaves(unit_params)))


def input_size_of(batch) -> int:
    """Paper §3.1: input size = number of elements in the input tensor:
    the tokens, plus one per encoder frame and per vision patch (the
    stub frontends' (B, F) and (B, vt) positions), as the reference
    counts them."""
    size = int(np.prod(tuple(batch["tokens"].shape)))
    for key in ("frames", "vision_embeds"):
        if key in batch:
            size += int(np.prod(tuple(batch[key].shape[:2])))
    return size


def _param_sig(node) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in _leaves(node))


class ShuttlingCollector:
    """Collects per-unit activation bytes for the live batch geometry.

    Units are deduplicated by (behavioural signature, parameter shapes,
    input shape and dtype): a homogeneous 12-block model needs one meta
    trace per input size, not 12, and 8 equal scan-mode chunks one (an
    encoder-decoder: one encoder and one decoder trace).  ``dedup=False``
    traces every unit.
    """

    def __init__(self, lm, dedup: bool = True):
        self.lm = lm
        self.dedup = dedup
        self._trace_cache: Dict[tuple, dict] = {}

    def collect(self, batch) -> CollectionResult:
        t0 = time.perf_counter()
        units = self.lm.plan_units(batch)
        unit_flops = plan_unit_flops(self.lm, batch)
        dtype = self.lm.dtype
        records: List[UnitRecord] = []
        traced = hits = 0
        for u in units:
            # the encoder's stream for an encoder unit, else the
            # residual stream (the vision prefix included)
            x_shape = self.lm.unit_input_shape(u, batch)
            key = info = None
            if self.dedup and u.signature is not None:
                key = (u.signature, _param_sig(u.params), x_shape, str(dtype))
                info = self._trace_cache.get(key)
            if info is None:
                info = unit_residual_bytes(u, x_shape, dtype)
                if key is not None:
                    self._trace_cache[key] = info
                traced += 1
            else:
                hits += 1
            opt_b = int(unit_moment_bytes(u.params))
            records.append(UnitRecord(
                u.name, u.index, info["activation_bytes"],
                info["output_bytes"], info["param_bytes"],
                float(unit_flops[u.index]),
                offloadable_bytes=info["offloadable_bytes"],
                device_offloadable_bytes=info["offloadable_bytes"],
                opt_bytes=opt_b, device_opt_bytes=opt_b))
        return CollectionResult(input_size_of(batch), records,
                                time.perf_counter() - t0,
                                traced_units=traced, dedup_hits=hits)
