"""Checkpointing: flat-path .npz save/restore of nested trees of tensors.

The counterpart of the JAX package's ``checkpoint``, writing the same
archive: one ``.npz`` a step, ``ckpt_NNNNNNNN.npz``, holding ``__step__``
and one entry a leaf, named by the leaf's path in the tree with the
parts joined by ``::`` (``params::embed``, ``params::bottom::0::w``,
``opt::mu::embed``, ``esd::latest``).  A tree is nested dicts (a part is
the key), lists and tuples (the index) and dataclasses such as
:class:`repro_torch.core.dispatch.SparseEsdState` or ``EsdState`` (the
field name); a
leaf is a torch tensor, a numpy array or a scalar, and ``None`` is no
leaf.  The training driver writes the reference's tree,
``{params, opt, esd, qres}`` in the reference's layout
(:func:`train_tree`, through the models' ``ref_paths``; a PS-stacked
table is its (n_ps, max_rows, E) leaf), so either package restores the
other's checkpoints.

Leaves are copied to the host on save; a leaf numpy cannot hold
(bfloat16) is stored as f32.  On restore each leaf takes the dtype of
the template's leaf and, for a tensor, its device.

Crash-safe by construction: a save writes ``ckpt_NNNNNNNN.tmp.npz`` and
renames only when complete, so a kill mid-save leaves a ``.tmp`` file —
never a truncated ``ckpt_NNNNNNNN.npz``.  Discovery (:func:`latest_step`)
matches the final names exactly (a leftover ``.tmp`` is skipped, and the
next successful save cleans it up), and :func:`restore_checkpoint` with
``step=None`` falls back to the previous checkpoint if the newest archive
turns out unreadable anyway (e.g. torn by the filesystem) — structural
mismatches (wrong shapes, missing leaves) are real errors and always
propagate, naming the offending leaf path.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.tree import from_ref, opt_from_ref, opt_to_ref, to_ref
from ..obs.trace import get_tracer

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "train_tree", "load_train_tree"]

_SEP = "::"
_CKPT_RE = re.compile(r"ckpt_(\d{8})\.npz")


def _children(node) -> list | None:
    """``[(label, child), ...]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(key, leaf), ...]`` with the reference's ``::``-joined keys."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for label, child in kids:
        out += _flatten(child, f"{prefix}{_SEP}{label}" if prefix else label)
    return out


def _unflatten(tree: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return leaves[prefix]
    new = {label: _unflatten(child, leaves,
                            f"{prefix}{_SEP}{label}" if prefix else label)
           for label, child in kids}
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(new[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **new)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                          torch.float8_e5m2):
            leaf = leaf.float()      # numpy has no bf16/f8: store as f32
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub":     # ml_dtypes (bf16/f8): store as f32
        arr = arr.astype(np.float32)
    return arr


def save_checkpoint(directory: str | Path, step: int, tree: Any) -> Path:
    with get_tracer().span("checkpoint.save", track="io", step=step):
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        # a crashed earlier save may have left partial .tmp files behind
        for stale in directory.glob("ckpt_*.tmp.npz"):
            stale.unlink(missing_ok=True)
        path = directory / f"ckpt_{step:08d}.npz"
        tmp = path.with_suffix(".tmp.npz")
        flat = {key: _to_host(leaf) for key, leaf in _flatten(tree)}
        np.savez(tmp, __step__=np.int64(step), **flat)
        tmp.rename(path)
        return path


def _steps(directory: Path) -> list[int]:
    """Completed checkpoint steps, ascending (``.tmp`` leftovers and any
    other stray ``ckpt_*`` names are not checkpoints)."""
    steps = []
    for f in directory.glob("ckpt_*.npz"):
        mt = _CKPT_RE.fullmatch(f.name)
        if mt:
            steps.append(int(mt.group(1)))
    return sorted(steps)


def latest_step(directory: str | Path) -> int | None:
    steps = _steps(Path(directory))
    return steps[-1] if steps else None


def _like(arr: np.ndarray, leaf):
    """``arr`` as ``leaf``'s kind: its dtype, and its device for a tensor."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def _load_leaves(path: Path, flat) -> dict[str, Any]:
    with np.load(path) as data:
        leaves = {}
        for key, leaf in flat:
            if key not in data:
                raise KeyError(
                    f"{path.name} has no entry for leaf {key!r}")
            arr = data[key]
            shape = tuple(np.shape(leaf))
            if arr.shape != shape:
                raise ValueError(f"{key}: shape {arr.shape} != {shape}")
            leaves[key] = _like(arr, leaf)
    return leaves


def restore_checkpoint(directory: str | Path, tree_like: Any,
                       step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (shapes must match).

    With ``step=None`` the newest completed checkpoint is used; if its
    archive is unreadable (truncated/torn), older checkpoints are tried
    in turn — only *archive* corruption triggers the fallback, a shape
    mismatch or missing leaf is a caller bug and raises immediately.
    """
    with get_tracer().span("checkpoint.restore", track="io"):
        directory = Path(directory)
        flat = _flatten(tree_like)
        if step is not None:
            leaves = _load_leaves(directory / f"ckpt_{step:08d}.npz", flat)
            return _unflatten(tree_like, leaves), step
        candidates = _steps(directory)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        for s in reversed(candidates):
            path = directory / f"ckpt_{s:08d}.npz"
            try:
                leaves = _load_leaves(path, flat)
            except (zipfile.BadZipFile, EOFError, OSError) as e:
                warnings.warn(
                    f"skipping unreadable checkpoint {path.name}: {e}",
                    RuntimeWarning, stacklevel=2)
                continue
            return _unflatten(tree_like, leaves), s
        raise FileNotFoundError(f"no readable checkpoint in {directory} "
                                f"(tried steps {candidates})")


def train_tree(params: list, paths: list, state: dict, esd=None) -> dict:
    """A training run's checkpoint tree in the reference's layout:
    ``params`` (the model's parameters, placed by ``paths``, the model's
    ``ref_paths``), ``opt`` (``state["opt"]``), ``esd`` (the cache state,
    when given) and ``qres`` (``state["qres"]``, the codec's residual by
    table name, when the run has one).  Its leaves are the run's tensors,
    or stacks of them; :func:`save_checkpoint` copies them to the host."""
    tree = {"params": to_ref(params, paths),
            "opt": opt_to_ref(state["opt"], paths)}
    if esd is not None:
        tree["esd"] = esd
    if state.get("qres"):
        tree["qres"] = dict(state["qres"])
    return tree


def load_train_tree(tree: dict, params: list, paths: list, state: dict):
    """Put a restored :func:`train_tree` back: the parameters copied in
    place, ``state``'s optimizer state and residuals replaced.  Returns
    the tree's cache state (None without one)."""
    with torch.no_grad():
        for p, v in zip(params, from_ref(tree["params"], paths), strict=True):
            p.copy_(v)
    state["opt"] = opt_from_ref(tree["opt"], paths)
    if "qres" in tree:
        state["qres"].update(tree["qres"])
    return tree.get("esd")
