"""Parameter conversion between the reference's parameter tree and the
port's tensors, through numpy.

The reference keeps parameters as nested dicts and lists of arrays
(``LM.init``: ``embed``, ``final_norm``, ``lm_head`` when untied,
``blocks[i].{norm1, attn.{wq, wk, wv, wo, q_norm, k_norm}, norm2, mlp |
moe}``, hymba's ``mixer.{attn, ssm, attn_scale, ssm_scale}`` with 0-d
scales, the MoE's experts on a leading ``(E, ...)`` axis).  The port's
``LM`` uses the same tree and layout, so a path ``blocks/3/attn/wq`` is
the state-dict key
``blocks.3.attn.wq`` and the values copy without a transpose.  In scan
mode the reference stacks the layers instead: ``blocks`` is a dict of
arrays with a leading layer axis; they are unstacked into
``blocks.<i>.…`` here and stacked back by ``tree_from_state_dict(...,
stacked=True)``.  bfloat16 crosses as its 16-bit pattern (``torch``
cannot read numpy's bfloat16).  Arrays are read with ``np.asarray``
only, so this module needs no JAX.

Serving caches convert the same way: the reference's ``init_cache`` is
a list of per-layer dicts in unrolled mode and one dict of arrays with a
leading layer axis in scan mode; the port's is a list of per-layer dicts
in both (``cache_from_tree`` / ``cache_to_tree``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                     # numpy's bfloat16
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flat(node, prefix: str):
    """(dotted path, leaf) pairs of a nested dict/list tree."""
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        yield prefix, node
        return
    for key, child in items:
        yield from _flat(child, f"{prefix}.{key}" if prefix else str(key))


def state_dict_from_tree(tree) -> Dict[str, torch.Tensor]:
    """Flatten a nested dict/list parameter tree into ``{dotted path:
    tensor}`` (CPU tensors holding copies of the arrays); a stacked
    ``blocks`` dict (scan mode) becomes one entry per layer."""
    flat: Dict[str, torch.Tensor] = {}
    for path, leaf in _flat(tree, ""):
        if path.startswith("blocks.") and isinstance(tree["blocks"], dict):
            rest = path[len("blocks."):]
            for i, layer in enumerate(np.asarray(leaf)):
                flat[f"blocks.{i}.{rest}"] = _to_torch(layer)
        else:
            flat[path] = _to_torch(leaf)
    return flat


def tree_from_state_dict(state: Dict[str, torch.Tensor],
                         stacked: bool = False) -> dict:
    """Inverse of ``state_dict_from_tree``: numeric path segments become
    list indices, leaves numpy arrays; ``stacked=True`` stacks the
    ``blocks`` list on a leading layer axis, as the reference's scan
    mode keeps it."""
    root: dict = {}
    for path, value in state.items():
        node = root
        keys = path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = _to_numpy(value)

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([t[k] for t in layers]) for k in layers[0]}
        return np.stack(layers)

    tree = listify(root)
    if stacked:
        tree["blocks"] = stack(tree["blocks"])
    return tree


def load_tree(lm: torch.nn.Module, tree) -> None:
    """Copy a reference parameter tree (unrolled or stacked) into
    ``lm``'s parameters."""
    lm.load_state_dict(state_dict_from_tree(tree), strict=True)


def cache_from_tree(tree) -> List[Dict[str, torch.Tensor]]:
    """A reference serving cache (a list of per-layer dicts, or a dict of
    layer-stacked arrays) as the port's list of per-layer dicts of CPU
    tensors."""
    if isinstance(tree, dict):
        n = len(next(iter(tree.values())))
        return [{k: _to_torch(np.asarray(v)[i]) for k, v in tree.items()}
                for i in range(n)]
    return [{k: _to_torch(v) for k, v in layer.items()} for layer in tree]


def cache_to_tree(cache, stacked: bool = False):
    """The port's cache as numpy: a list of per-layer dicts, or with
    ``stacked=True`` one dict of arrays with a leading layer axis (the
    reference's scan-mode layout)."""
    layers = [{k: _to_numpy(v) for k, v in layer.items()} for layer in cache]
    if stacked:
        return {k: np.stack([layer[k] for layer in layers])
                for k in layers[0]}
    return layers
