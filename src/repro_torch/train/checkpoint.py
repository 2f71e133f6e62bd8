"""Parameter and optimizer-state files, the counterpart of the
reference's ``train/checkpoint.py`` on ``torch.save``.

A file holds one flat ``{name: tensor}`` dict: the parameters by name,
or an ``AdamWState`` as ``step`` (a 0-d int64 tensor) and ``m/<name>``,
``v/<name>`` for the fp32 moments.  ``save`` is crash-consistent (a
``.tmp`` file, then ``os.replace``).  ``load`` is strict as the
reference's is: the key set stands in for the reference's treedef, and
each leaf's dtype and shape are checked against ``like``, the leaf
named in every error.  A truncated or unreadable file raises
``CheckpointError``.  Files load with ``weights_only=True`` onto
``like``'s device, so a snapshot written on the card loads on the CPU
and the reverse.  The snapshot layer (``train/resilience.py``) guards
whole snapshots with a content-hash manifest.
"""
from __future__ import annotations

import os
from typing import Dict, Union

import torch

from repro_torch.optim.adamw import AdamWState

FORMAT = 1

Tree = Union[Dict[str, torch.Tensor], AdamWState]


class CheckpointError(ValueError):
    """A checkpoint file does not match the expected structure/content."""


def _flatten(tree: Tree) -> Dict[str, torch.Tensor]:
    if isinstance(tree, AdamWState):
        flat = {"step": torch.tensor(int(tree.step), dtype=torch.int64)}
        flat.update({f"m/{n}": t for n, t in tree.m.items()})
        flat.update({f"v/{n}": t for n, t in tree.v.items()})
        return flat
    return dict(tree)


def _unflatten(flat: Dict[str, torch.Tensor], like: Tree) -> Tree:
    if isinstance(like, AdamWState):
        return AdamWState(int(flat["step"]),
                          {n: flat[f"m/{n}"] for n in like.m},
                          {n: flat[f"v/{n}"] for n in like.v})
    return {n: flat[n] for n in like}


def save(path: str, tree: Tree) -> None:
    payload = {"format": FORMAT,
               "leaves": {n: t.detach() for n, t in _flatten(tree).items()}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like`` (a ``{name: tensor}`` dict
    or an ``AdamWState``); each leaf lands on its ``like`` leaf's
    device."""
    ref = _flatten(like)
    first = next(iter(ref.values()), None)
    device = first.device if first is not None else torch.device("cpu")
    try:
        payload = torch.load(path, map_location=device, weights_only=True)
    except Exception as e:
        raise CheckpointError(f"{path}: not a readable checkpoint "
                              f"({type(e).__name__}: {e})") from e
    if (not isinstance(payload, dict) or payload.get("format") != FORMAT
            or not isinstance(payload.get("leaves"), dict)):
        raise CheckpointError(f"{path}: malformed checkpoint payload")
    stored = payload["leaves"]
    if set(stored) != set(ref):
        missing = sorted(set(ref) - set(stored))
        extra = sorted(set(stored) - set(ref))
        raise CheckpointError(
            f"{path}: key mismatch — checkpoint was written for a "
            f"different structure; missing {missing[:8]}, unexpected "
            f"{extra[:8]}")
    out = {}
    for name, want in ref.items():
        got = stored[name]
        if not isinstance(got, torch.Tensor):
            raise CheckpointError(f"{path}: leaf {name} is not a tensor")
        if got.dtype != want.dtype:
            raise CheckpointError(
                f"{path}: dtype mismatch at {name}: stored {got.dtype}, "
                f"expected {want.dtype}")
        if tuple(got.shape) != tuple(want.shape):
            raise CheckpointError(
                f"{path}: shape mismatch at {name}: stored "
                f"{tuple(got.shape)}, expected {tuple(want.shape)}")
        out[name] = got.to(want.device)
    return _unflatten(out, like)
