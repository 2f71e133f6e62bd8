"""Per-device memory budgets derived from a mesh shape (sharding-aware
planning), the counterpart of the reference's ``sharding/budget.py``.

Under a mesh, the bytes that land on each device are the global bytes
divided by the product of the mesh-axis sizes a tensor is sharded over,
and that divisor differs between parameters (tensor-parallel over
``model`` per ``sharding/specs.py``), optimizer moments (additionally
ZeRO-1 sharded over ``data``) and activations (batch over ``data``,
tensor-parallel intermediates over ``model``).

``MeshBudget`` is that arithmetic and nothing else: it never touches a
``DeviceMesh`` or a device, so a (16, 16) pod budget can be planned and
simulated on one device or on the CPU.  The divisor rules mirror
``sharding/specs.py``:

* parameters / gradients -- ``specs.param_spec`` per leaf, the divisor
  the product of the axis sizes named in the spec;
* optimizer moments -- like parameters, with ZeRO-1's extra ``data``
  sharding replayed leaf by leaf;
* activations -- batch-leading tensors divide by the data ways;
  tensor-parallel intermediates (anything that is not a residual-stream
  boundary tensor ``(B, S, d_model)``) further divide by the model ways
  when divisible; with ``seq_parallel`` the boundary tensors shard their
  sequence axis over ``model`` too.

Parameters are read from ``lm.named_parameters()`` in the reference's
layout (``specs.reference_leaves``): in scan mode the per-layer tensors
``blocks.<i>.<rest>`` count as one stacked ``(L,) + shape`` leaf, as the
reference keeps them, so ZeRO-1's "first unsharded divisible axis" sees
the layer axis there too.

Entry points:
    budget = MeshBudget.from_shape((4, 2), hbm_per_device=16 << 30)
    budget = MeshBudget.from_mesh(device_mesh, hbm_per_device=16 << 30)
    budget.activation_divisor(shape, batch=B, d_model=d)
    fixed_train_bytes_per_device(lm, budget, scanned=...)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.sharding import specs as SP

_DEFAULT_AXES = {1: ("data",), 2: ("data", "model"),
                 3: ("pod", "data", "model")}


def resolve_axis_names(shape: Sequence[int],
                       axis_names: Optional[Sequence[str]] = None) -> tuple:
    """Validate a mesh shape and resolve its axis names (shared by
    ``MeshBudget.from_shape`` and ``launch.mesh.make_production_mesh``,
    so the launcher's mesh and the planner's budget agree on naming).
    Defaults by rank: ("data",), ("data", "model"), ("pod", "data",
    "model")."""
    shape = tuple(int(s) for s in shape)
    if not shape or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    if axis_names is None:
        if len(shape) not in _DEFAULT_AXES:
            raise ValueError(
                f"no default axis_names for a rank-{len(shape)} mesh "
                f"{shape}; pass axis_names explicitly")
        axis_names = _DEFAULT_AXES[len(shape)]
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {axis_names} does not match "
                         f"shape {shape}")
    return shape, axis_names


def spec_divisor(spec, axis_sizes: Mapping[str, int]) -> int:
    """Product of the mesh-axis sizes a spec shards over.  Entries may
    be ``None`` (replicated), an axis name, or a tuple of axis names."""
    div = 1
    for entry in spec:
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for nm in names:
            div *= int(axis_sizes.get(nm, 1))
    return div


@dataclasses.dataclass(frozen=True)
class MeshBudget:
    """Per-device budget and sharding divisors for one mesh shape.

    ``axis_sizes`` is an ordered tuple of (axis name, size) pairs, e.g.
    ``(("data", 4), ("model", 2))``.  ``hbm_per_device_bytes`` is the
    memory each device offers; the planner subtracts the fixed
    (parameter / gradient / optimizer shard) bytes and plans activations
    into the rest.  ``attn_replicated`` and ``expert_2d`` are the
    parameter-sharding policy (``specs.param_spec``)."""
    axis_sizes: Tuple[Tuple[str, int], ...]
    hbm_per_device_bytes: float
    zero1: bool = False
    seq_parallel: bool = False
    attn_replicated: bool = False
    expert_2d: bool = False

    @classmethod
    def from_shape(cls, shape: Sequence[int], hbm_per_device: float, *,
                   axis_names: Optional[Sequence[str]] = None,
                   zero1: bool = False, seq_parallel: bool = False,
                   attn_replicated: bool = False,
                   expert_2d: bool = False) -> "MeshBudget":
        shape, axis_names = resolve_axis_names(shape, axis_names)
        return cls(tuple(zip(axis_names, shape)), float(hbm_per_device),
                   zero1=zero1, seq_parallel=seq_parallel,
                   attn_replicated=attn_replicated, expert_2d=expert_2d)

    @classmethod
    def from_mesh(cls, mesh, hbm_per_device: float, *,
                  zero1: bool = False, seq_parallel: bool = False,
                  attn_replicated: bool = False,
                  expert_2d: bool = False) -> "MeshBudget":
        """From a live ``torch.distributed.device_mesh.DeviceMesh``."""
        return cls(tuple(SP.axis_sizes(mesh).items()), float(hbm_per_device),
                   zero1=zero1, seq_parallel=seq_parallel,
                   attn_replicated=attn_replicated, expert_2d=expert_2d)

    @property
    def axis_dict(self) -> dict:
        return dict(self.axis_sizes)

    @property
    def n_devices(self) -> int:
        return math.prod(s for _, s in self.axis_sizes)

    @property
    def data_ways(self) -> int:
        """Product of all non-``model`` axes (pod x data)."""
        return math.prod(s for a, s in self.axis_sizes if a != "model")

    @property
    def model_ways(self) -> int:
        return int(self.axis_dict.get("model", 1))

    def sig(self) -> tuple:
        """Hashable identity for plan and step cache keys: budgets with
        other mesh shapes or sharding policies never share a plan."""
        return (self.axis_sizes, self.zero1, self.seq_parallel,
                self.attn_replicated, self.expert_2d)

    # -- activations ----------------------------------------------------
    def activation_divisor(self, shape: Sequence[int], *, batch: int,
                           d_model: int) -> int:
        """Sharding divisor for one saved activation of ``shape``.

        Tensors that do not lead with the batch axis are replicated.
        Batch-leading ones shard the batch over the data ways;
        residual-stream boundary tensors ``(B, S, d_model)`` stay
        replicated over ``model`` unless ``seq_parallel``, and every
        other batch-leading tensor is a tensor-parallel intermediate
        that divides by the model ways when divisible."""
        shape = tuple(int(s) for s in shape)
        if not shape or shape[0] != int(batch):
            return 1
        div = 1
        if self.data_ways > 1 and shape[0] % self.data_ways == 0:
            div *= self.data_ways
        boundary = len(shape) == 3 and shape[-1] == int(d_model)
        if boundary:
            if (self.seq_parallel and self.model_ways > 1
                    and shape[1] % self.model_ways == 0):
                div *= self.model_ways
        elif self.model_ways > 1:
            if math.prod(shape[1:]) % self.model_ways == 0:
                div *= self.model_ways
        return div

    # -- parameters -----------------------------------------------------
    def _param_spec(self, path, shape, *, scanned: bool) -> tuple:
        return SP.param_spec(path, shape, scanned=scanned,
                             model_dim=self.model_ways,
                             attn_replicated=self.attn_replicated,
                             expert_2d=self.expert_2d,
                             data_dim=self.axis_dict.get("data", 1))

    def param_divisor(self, path, shape, *, scanned: bool) -> int:
        """Exact divisor for one parameter leaf (``path`` its dotted key
        or names, ``shape`` its shape) via ``specs.param_spec``."""
        return spec_divisor(self._param_spec(path, shape, scanned=scanned),
                            self.axis_dict)

    def _moment_divisor(self, path, shape, *, scanned: bool) -> int:
        """Optimizer-moment divisor: the parameter's, times the data ways
        where ZeRO-1 finds an unsharded axis they divide."""
        shape = tuple(shape)
        spec = self._param_spec(path, shape, scanned=scanned)
        div = spec_divisor(spec, self.axis_dict)
        if self.zero1 and self.data_ways > 1:
            padded = list(spec) + [None] * (len(shape) - len(spec))
            for i, s in enumerate(padded):
                if s is None and shape[i] % self.data_ways == 0:
                    div *= self.data_ways
                    break
        return div


def unit_moment_bytes(unit_params, budget: Optional[MeshBudget] = None, *,
                      scanned: bool = False) -> float:
    """Fp32 AdamW moment bytes (m + v) owned by one plan unit, the
    per-unit price of the ``OFFLOAD_OPT`` action: ``2 x 4 x n`` per
    leaf, each divided by its moment divisor under ``budget``.

    ``unit_params`` is the unit's tree (a module: one block), or in scan
    mode the list of its layers' trees; ``scanned=True`` reads the list
    as the reference's chunk leaves, stacked ``(layers in the chunk,) +
    shape`` under a ``blocks`` path, so ZeRO-1 sees their leading axis."""
    if isinstance(unit_params, (list, tuple)):
        params = {f"blocks.{i}.{n}": t for i, tree in enumerate(unit_params)
                  for n, t in tree.named_parameters()}
        leaves = SP.reference_leaves(params, scanned=True)
    else:
        leaves = SP.reference_leaves(unit_params, scanned=False)
    total = 0.0
    for key, shape, _, _ in leaves:
        div = (budget._moment_divisor(key, shape, scanned=scanned)
               if budget is not None else 1)
        total += 2 * 4 * math.prod(shape) / div          # fp32 m + v
    return float(total)


def fixed_train_bytes_per_device(params, budget: MeshBudget, *,
                                 scanned: bool = False,
                                 optimizer: str = "adamw",
                                 grad_dtype_bytes: Optional[int] = None
                                 ) -> float:
    """Per-device resident bytes independent of input size: each
    parameter leaf divided by its ``specs.param_spec`` divisor,
    gradients sharded like parameters, fp32 AdamW moments like
    parameters plus ZeRO-1's data sharding when enabled.  ``params``: a
    module (``lm``) or a ``{name: tensor}`` mapping."""
    total = 0.0
    for key, shape, dtype, _ in SP.reference_leaves(params, scanned=scanned):
        n = math.prod(shape)
        pdiv = budget.param_divisor(key, shape, scanned=scanned)
        pb = n * dtype.itemsize / pdiv
        gb = (n * grad_dtype_bytes / pdiv if grad_dtype_bytes is not None
              else pb)
        ob = 0.0
        if optimizer == "adamw":
            ob = 2 * 4 * n / budget._moment_divisor(key, shape,
                                                     scanned=scanned)
        total += pb + gb + ob
    return float(total)
