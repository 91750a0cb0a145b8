"""The JAX package's parameter trees for the port's modules.

A port module holds its weights as ``nn.Parameter`` attributes in
``model.parameters()`` order; the reference holds the same weights in a
nested dict (``{"embed", "bottom": [{"w"}, ...], ...}`` for the DLRM,
``{"embed", "groups": {"l0": {"attn": {"wq", ...}}}, ...}`` for the LM,
whose grouped layers are stacked on a leading axis).  A *path list*
names, for each entry of ``model.parameters()``, its place in the
reference's tree: ``(path, at)``, ``path`` a tuple of dict keys and list
indices and ``at`` the index on the stacked axis (``None`` when the
leaf is not stacked).  :func:`to_ref` builds the reference's tree from
a list aligned with the parameters (the parameters themselves, or an
optimizer's per-parameter state) and :func:`from_ref` takes it apart
again; :func:`to_numpy` turns a tree of tensors into the reference's
numpy tree.  The path lists are ``models.dlrm.ref_paths`` and
``models.backbone.ref_paths``.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["to_ref", "from_ref", "opt_to_ref", "opt_from_ref", "to_numpy"]


def _lists(node):
    """Dicts keyed 0..k-1 become lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _stack(parts: list):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts)
    return np.stack([np.asarray(p) for p in parts])


def to_ref(leaves: Sequence, paths: Sequence) -> dict:
    """The reference's tree holding ``leaves[i]`` at ``paths[i]``."""
    root: dict = {}
    stacked: dict = {}
    for leaf, (path, at) in zip(leaves, paths, strict=True):
        if at is not None:
            stacked.setdefault(path, {})[at] = leaf
            continue
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    for path, parts in stacked.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _stack([parts[g] for g in range(len(parts))])
    return _lists(root)


def from_ref(tree: dict, paths: Sequence) -> list:
    """The leaves of ``tree`` at ``paths``, one per parameter (a stacked
    leaf's row ``at``)."""
    out = []
    for path, at in paths:
        node: Any = tree
        for key in path:
            node = node[key]
        out.append(node if at is None else node[at])
    return out


def opt_to_ref(state, paths: Sequence):
    """An optimizer state of :mod:`repro_torch.optim` in the reference's
    layout: row-wise Adagrad's per-parameter list as the parameter tree,
    Adam's ``{"mu", "nu", "t"}`` with ``mu`` and ``nu`` as parameter
    trees, SGD's empty state as the reference's ``()``."""
    if isinstance(state, dict):
        return {"mu": to_ref(state["mu"], paths),
                "nu": to_ref(state["nu"], paths), "t": state["t"]}
    return to_ref(state, paths) if len(state) else ()


def opt_from_ref(tree, paths: Sequence):
    """:func:`opt_to_ref`'s inverse."""
    if isinstance(tree, dict) and set(tree) == {"mu", "nu", "t"}:
        return {"mu": from_ref(tree["mu"], paths),
                "nu": from_ref(tree["nu"], paths), "t": tree["t"]}
    return from_ref(tree, paths) if len(tree) else []


def to_numpy(tree):
    """A tree of tensors as numpy on the host (bf16 as f32), the
    structure kept; numpy leaves pass through."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return tree
