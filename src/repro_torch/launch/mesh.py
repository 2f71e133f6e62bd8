"""Mesh construction and per-device budget derivation, the counterpart
of the reference's ``launch/mesh.py`` on a
``torch.distributed.device_mesh.DeviceMesh``.

A mesh covers the ranks of this process's group, its axis names the
``mesh_dim_names``.  When no group exists, ``ensure_process_group``
makes a one-rank group (``nccl`` on CUDA, ``gloo`` on the CPU) over an
in-process ``HashStore``; an existing group is reused.  The port runs
one process, so the mesh it can build holds one device: a ``(1, 1)``
mesh, or any shape of one device.  A larger shape raises
``MeshUnavailable``, naming the devices it needs and the ones present,
and the launcher then plans per device and executes on its one device.

Functions, never module-level objects: importing this module touches
no process group or device.  ``budget_from_mesh`` turns a live mesh into
the planner's ``MeshBudget`` (``sharding/budget.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.sharding.budget import MeshBudget, resolve_axis_names


class MeshUnavailable(RuntimeError):
    """A mesh needs more devices than this process's group holds."""

    def __init__(self, shape: tuple, needed: int, present: int):
        super().__init__(
            f"mesh {shape} needs {needed} devices but only {present} "
            f"present: a mesh holds the ranks of this process's group "
            f"(world size {present}); plan for it per device with "
            f"MeshBudget.from_shape instead")
        self.needed, self.present = needed, present


def reachable_devices() -> int:
    """The devices a mesh of this process can hold: its process group's
    world size (1 when there is no group yet)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def ensure_process_group(device_type: str = "cpu") -> bool:
    """Make a one-rank process group when none exists; returns whether
    it made one (the caller then destroys it when done)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Sequence[int]] = None,
                         axis_names: Optional[Sequence[str]] = None,
                         device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over this process's ranks.

    Without ``shape`` the reference's production defaults apply: (16,
    16), or (2, 16, 16) with ``multi_pod``.  ``axis_names`` default by
    rank through the same ``resolve_axis_names`` the planner's
    ``MeshBudget`` uses.  ``device_type``: ``cuda`` when a GPU is
    present, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape, axis_names = resolve_axis_names(shape, axis_names)
    n, present = math.prod(shape), reachable_devices()
    if present < n:
        raise MeshUnavailable(shape, n, present)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ensure_process_group(device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: Optional[str] = None):
    """A small (data, model) mesh over the devices present (tests)."""
    return make_production_mesh(shape=(data, model), device_type=device_type)


def budget_from_mesh(mesh, hbm_per_device: float, *, zero1: bool = False,
                     seq_parallel: bool = False) -> MeshBudget:
    """Per-device planning budget for a live mesh."""
    return MeshBudget.from_mesh(mesh, hbm_per_device, zero1=zero1,
                                seq_parallel=seq_parallel)


def parse_mesh_shape(text: str) -> tuple:
    """Parse a CLI mesh shape like ``"4x2"`` or ``"2x16x16"``."""
    try:
        shape = tuple(int(p) for p in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh shape {text!r}; expected e.g. '4x2'")
    if not shape or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh shape {text!r}; axes must be >= 1")
    return shape
