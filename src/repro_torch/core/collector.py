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

Sharding-aware collection: given a ``MeshBudget`` the collector also
records each unit's per-device bytes.  Every saved storage is divided by
``MeshBudget.activation_divisor`` of its shape (the
``sharding/specs.py`` rules: batch over the data axes, tensor-parallel
intermediates over ``model``), read through the first view autograd
saved it with that covers it whole.  The reference's closure leaves
lead with ``B``; autograd often saves a folded view instead: ``matmul``
on a ``(B, S, d)`` input keeps ``(B*S, d)``, ``bmm`` over heads
``(B*H, S, hd)``.  A second trace at batch ``2B`` tells them apart from
a leading axis that only looks like a multiple of ``B``, such as a MoE
block's expert count: a leading axis that doubles with the batch is
read as ``(B, k) + rest``, and any other storage is replicated.
Without a budget, or with a one-device mesh, every ``device_*``
quantity is its global one, from the same storages.

The collection runs lazily, on the live batch geometry, only when a new
input size appears; identical units are traced once (dedup by signature).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.roofline import plan_unit_flops
from repro_torch.models.lm import PlanUnit
from repro_torch.sharding.budget import MeshBudget, unit_moment_bytes


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
    # per-device residual and boundary bytes under the collection's
    # MeshBudget (the global ones without one)
    device_activation_bytes: int = 0
    device_output_bytes: int = 0


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

    def device_activation_vector(self) -> np.ndarray:
        """Per-unit bytes landing on one device under the collection's
        MeshBudget (``activation_vector`` without one)."""
        return np.array([r.device_activation_bytes for r in self.records],
                        dtype=np.float64)

    def flops_vector(self) -> np.ndarray:
        return np.array([r.flops for r in self.records], dtype=np.float64)

    def output_vector(self) -> np.ndarray:
        return np.array([r.output_bytes for r in self.records],
                        dtype=np.float64)

    def device_output_vector(self) -> np.ndarray:
        return np.array([r.device_output_bytes for r in self.records],
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


def _saved_storages(unit: PlanUnit, params, x_shape, dtype):
    """Run ``unit`` forward on ``meta`` at ``x_shape`` and return the
    storages autograd saves, the parameters' excluded, in the order they
    were first saved, each as ``[bytes, seen through a >= 2-d view, the
    shape to shard it by]`` (the first view covering the storage whole,
    else the first view), with the output."""
    param_ids = {t.untyped_storage()._cdata for t in _leaves(params)}
    saved: Dict[int, list] = {}          # insertion-ordered
    whole: set = set()
    alive = []                           # keeps storage ids from reuse

    def pack(t):
        alive.append(t)
        st = t.untyped_storage()
        if st._cdata not in param_ids:
            entry = saved.setdefault(st._cdata,
                                     [st.nbytes(), False, tuple(t.shape)])
            entry[1] = entry[1] or t.dim() >= 2
            if (st._cdata not in whole
                    and t.numel() * t.element_size() == entry[0]):
                whole.add(st._cdata)
                entry[2] = tuple(t.shape)
        return t

    x = torch.empty(x_shape, dtype=dtype, device="meta", requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = unit.apply(params, x)
    return list(saved.values()), out


def _batch_led(shape: tuple, shape_2b: tuple, batch: int):
    """``shape`` read with its batch axis in front, or None when it has
    none.  ``shape_2b`` is the same storage's shape in a trace at twice
    the batch: a leading axis that doubles with it is ``B * k`` tokens'
    worth, a folded view such as ``matmul``'s ``(B*S, d)`` or ``bmm``'s
    ``(B*H, S, hd)``, and unfolds to ``(B, k)``.  One that does not
    (a MoE ``(E, G*C, d)`` leads with the expert count) is replicated."""
    if (not shape or len(shape) != len(shape_2b)
            or shape_2b[0] != 2 * shape[0] or shape[0] % batch):
        return None
    k = shape[0] // batch
    return tuple(shape) if k == 1 else (batch, k) + tuple(shape[1:])


def unit_residual_bytes(unit: PlanUnit, x_shape, dtype,
                        mesh_budget: Optional[MeshBudget] = None, *,
                        weight_grads: bool = False) -> Dict[str, int]:
    """Residual footprint of one unit at input shape ``x_shape``, from a
    forward on ``meta`` tensors.  ``weight_grads=True`` lets the
    parameters require grad too, so the count also holds what the weight
    gradients need -- what a training step really keeps; the planner
    uses the reference's input-only count.  With a ``mesh_budget`` of
    more than one device the ``device_*`` counts divide each storage by
    its sharding divisor, which a second trace at twice the batch tells
    batch-led storages from the rest."""
    params = _meta_tree(unit.params)
    if weight_grads:
        for t in _leaves(params):
            t.requires_grad_(True)
    saved, out = _saved_storages(unit, params, x_shape, dtype)
    act = sum(nb for nb, _, _ in saved)
    offl = sum(nb for nb, two_d, _ in saved if two_d)
    out_bytes = out.numel() * out.element_size()
    info = {"activation_bytes": int(act), "output_bytes": out_bytes,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in _leaves(params)),
            "offloadable_bytes": int(min(offl, act))}
    if mesh_budget is None or mesh_budget.n_devices == 1:
        info.update(device_activation_bytes=info["activation_bytes"],
                    device_offloadable_bytes=info["offloadable_bytes"],
                    device_output_bytes=out_bytes)
        return info
    B, d = int(x_shape[0]), int(x_shape[-1])
    saved_2b, _ = _saved_storages(unit, params,
                                  (2 * B,) + tuple(x_shape[1:]), dtype)
    if len(saved_2b) != len(saved):
        raise RuntimeError(
            f"unit {unit.name!r} saves {len(saved)} storages at batch {B} "
            f"and {len(saved_2b)} at {2 * B}: its batch axes cannot be "
            "matched")
    dev = dev_offl = 0.0
    for (nb, two_d, shape), (_, _, shape_2b) in zip(saved, saved_2b):
        led = _batch_led(shape, shape_2b, B)
        div = (1 if led is None else
               mesh_budget.activation_divisor(led, batch=B, d_model=d))
        dev += nb / div
        if two_d:
            dev_offl += nb / div
    out_div = mesh_budget.activation_divisor(tuple(out.shape), batch=B,
                                             d_model=d)
    info.update(device_activation_bytes=int(dev),
                device_offloadable_bytes=int(min(dev_offl, dev)),
                device_output_bytes=int(out_bytes / out_div))
    return info


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
    traces every unit.  ``mesh_budget`` fills the ``device_*`` fields
    under its divisors; its signature is part of the trace-cache key.
    """

    def __init__(self, lm, dedup: bool = True,
                 mesh_budget: Optional[MeshBudget] = None):
        self.lm = lm
        self.dedup = dedup
        self.mesh_budget = mesh_budget
        self._mesh_sig = mesh_budget.sig() if mesh_budget is not None else None
        self._trace_cache: Dict[tuple, dict] = {}

    def collect(self, batch) -> CollectionResult:
        t0 = time.perf_counter()
        units = self.lm.plan_units(batch)
        unit_flops = plan_unit_flops(self.lm, batch)
        dtype = self.lm.dtype
        mb = self.mesh_budget
        records: List[UnitRecord] = []
        traced = hits = 0
        for u in units:
            # the encoder's stream for an encoder unit, else the
            # residual stream (the vision prefix included)
            x_shape = self.lm.unit_input_shape(u, batch)
            key = info = None
            if self.dedup and u.signature is not None:
                key = (u.signature, _param_sig(u.params), x_shape, str(dtype),
                       self._mesh_sig)
                info = self._trace_cache.get(key)
            if info is None:
                info = unit_residual_bytes(u, x_shape, dtype, mb)
                if key is not None:
                    self._trace_cache[key] = info
                traced += 1
            else:
                hits += 1
            # a scan chunk's layers count as the reference's stacked
            # leaves
            scanned = u.name.startswith("chunk")
            opt_b = int(unit_moment_bytes(u.params, scanned=scanned))
            dev_opt_b = (int(unit_moment_bytes(u.params, mb, scanned=scanned))
                         if mb is not None else opt_b)
            records.append(UnitRecord(
                u.name, u.index, info["activation_bytes"],
                info["output_bytes"], info["param_bytes"],
                float(unit_flops[u.index]),
                offloadable_bytes=info["offloadable_bytes"],
                device_offloadable_bytes=info["device_offloadable_bytes"],
                opt_bytes=opt_b, device_opt_bytes=dev_opt_b,
                device_activation_bytes=info["device_activation_bytes"],
                device_output_bytes=info["device_output_bytes"]))
        return CollectionResult(input_size_of(batch), records,
                                time.perf_counter() - t0,
                                traced_units=traced, dedup_hits=hits)
