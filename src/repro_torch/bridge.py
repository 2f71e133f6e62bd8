"""Parameter conversion between the reference's parameter tree and the
port's tensors, through numpy.

The reference keeps parameters as nested dicts and lists of arrays
(``LM.init``: ``embed``, ``final_norm``, ``blocks[i].{norm1, attn.{wq,
wk, wv, wo}, norm2, mlp.{wi, wo}}``).  The port's ``LM`` uses the same
tree and layout, so a path ``blocks/3/attn/wq`` is the state-dict key
``blocks.3.attn.wq`` and the values copy without a transpose.  Arrays
are read with ``np.asarray`` only, so this module needs no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_dict_from_tree(tree) -> Dict[str, torch.Tensor]:
    """Flatten a nested dict/list parameter tree into ``{dotted path:
    tensor}`` (CPU tensors holding copies of the arrays)."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix: str) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            flat[prefix] = torch.from_numpy(np.array(node, copy=True))
            return
        for key, child in items:
            walk(child, f"{prefix}.{key}" if prefix else str(key))

    walk(tree, "")
    return flat


def tree_from_state_dict(state: Dict[str, torch.Tensor]) -> dict:
    """Inverse of ``state_dict_from_tree``: numeric path segments become
    list indices, leaves numpy arrays."""
    root: dict = {}
    for path, value in state.items():
        node = root
        keys = path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def load_tree(lm: torch.nn.Module, tree) -> None:
    """Copy a reference parameter tree into ``lm``'s parameters."""
    lm.load_state_dict(state_dict_from_tree(tree), strict=True)
