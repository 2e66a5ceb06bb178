"""Checkpoints and the state bridge to the reference package.

The npz layout is the reference's (``lio_mapping_tpu/io/checkpoint.py``):
for each named tree, its leaves in ``jax.tree.flatten`` order under keys
``name.0``, ``name.1``, ... plus a ``name.__treedef__`` string that loading
ignores. A checkpoint written by the reference ``LioPipeline.save`` loads
into the port's ``LioPipeline.load``, and the other way round.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_unflatten


def state_from_numpy_leaves(template, leaves):
    """Build a tree shaped like ``template`` from numpy ``leaves`` given in
    ``jax.tree.flatten`` order; each leaf takes the template leaf's dtype
    and device."""
    t_leaves = tree_leaves(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(f"template has {len(t_leaves)} leaves, got {len(leaves)}")
    out = []
    for ref, arr in zip(t_leaves, leaves):
        arr = np.array(arr)  # a writable copy (jax arrays read back read-only)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf shape {arr.shape} does not match the template's {tuple(ref.shape)}")
        out.append(torch.as_tensor(arr).to(dtype=ref.dtype, device=ref.device))
    return tree_unflatten(template, out)


def save_state(path: str, **trees):
    """Save named trees (e.g. est=..., odom=...) to npz."""
    out: Dict[str, Any] = {}
    for name, tree in trees.items():
        leaves = tree_leaves(tree)
        out[f"{name}.__treedef__"] = f"{type(tree).__name__} with {len(leaves)} leaves"
        for i, leaf in enumerate(leaves):
            out[f"{name}.{i}"] = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) \
                else np.asarray(leaf)
    np.savez_compressed(path, **out)


def load_state(path: str, **templates):
    """Load trees saved by ``save_state`` (this package's or the
    reference's); ``templates`` give structure, dtype and device."""
    with np.load(path, allow_pickle=False) as data:
        result = {}
        for name, template in templates.items():
            n = len(tree_leaves(template))
            result[name] = state_from_numpy_leaves(template, [data[f"{name}.{i}"] for i in range(n)])
    return result
