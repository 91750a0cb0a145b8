"""Sharding specs for everything the dry run places: parameters,
optimizer state, train batches, decode caches and the ragged exchange's
buffers.

The counterpart of the JAX package's ``dist/sharding.py``, with its
rule tables.  A *spec* is a :class:`Spec`, a tuple with one entry per
dim of its tensor: a mesh axis name, a tuple of names, or None
(replicated along that dim).  A leaf's spec comes from its *name* in
the reference's parameter tree plus the arch config, then is fitted to
the leaf's rank and shape:

  * the port's modules hold one set of weights a layer, so a parameter
    is named through its model's ``ref_paths`` (list indices skipped)
    and fitted to its own per-layer shape.  The reference's scan-stacked
    leaves (``groups``, whisper's ``enc``/``dec``) carry leading stack
    axes that its rules pad with None; a port spec is therefore the
    reference's spec for that leaf with its leading stack entries
    dropped;
  * a sharded entry is kept only when its axes' size divides the dim
    (vocab 51,866 on a 16-wide axis stays replicated), so ``len(spec) ==
    tensor.dim()`` for every leaf of every arch.

Entry points (the dry run's surface):

  param_specs(model, cfg=None, model_size=16, mesh=None)  parameters
  opt_state_specs(state, model, cfg=None, ...)  optimizer state
  batch_specs(cfg, shape, mesh)               train/prefill batch
  cache_specs(cfg, cache, mesh, batch)        decode cache
  data_axes(mesh)                             batch-carrying mesh axes
  zero1_specs(specs, shapes, mesh)            ZeRO-1 optimizer state
  exchange_specs(mesh)                        ragged-exchange buffers
  to_shardings(specs, mesh=None)              specs -> DTensor placements

Nothing here places a tensor: the port runs on one card
(:mod:`repro_torch.dist.ctx`).
"""
from __future__ import annotations

from typing import Any, Callable

from . import ctx
from .ctx import axis_size, data_axes

# model-axis width of the production mesh (launch/mesh.py): the default
# when the caller gives a config but no mesh
PRODUCTION_MODEL_SIZE = 16

__all__ = [
    "Spec", "param_specs", "opt_state_specs", "batch_specs", "cache_specs",
    "data_axes", "zero1_specs", "to_shardings", "exchange_specs",
    "tree_map", "PRODUCTION_MODEL_SIZE",
]

_M = "model"


class Spec(tuple):
    """One tensor's sharding: an entry per dim (an axis name, a tuple of
    names, or None).  A plain tuple, typed so that a nest of specs can
    be told from the nest's own lists and tuples."""

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def tree_map(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *other_leaves)`` over nests of dicts, lists and
    tuples, the structure kept; ``path`` holds the dict keys and list
    indices down to the leaf.  A :class:`Spec` is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest), path=path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _replicated(ndim: int) -> Spec:
    return Spec([None] * ndim)


# --------------------------------------------------------------------------
# rule tables: parameter name -> pattern over its trailing (logical) dims.
# "model" entries are dropped per leaf where the dim does not divide.
# --------------------------------------------------------------------------
def _attn_axes(mode: str):
    """(kv_axis, group_axis) for the explicit GQA weight layout."""
    return (_M if mode == "kv" else None, _M if mode == "g" else None)


def _lm_rules(mode: str) -> dict[str, tuple]:
    kv_ax, g_ax = _attn_axes(mode)
    return {
        # embeddings / head: vocab over the model axis (row-sharded table)
        "embed": (_M, None),
        "lm_head": (None, _M),
        # attention, explicit (D, KV, G, hd) layout (models/layers.py)
        "wq": (None, kv_ax, g_ax, None),
        "wk": (None, kv_ax, None),
        "wv": (None, kv_ax, None),
        "attn.wo": (kv_ax, g_ax, None, None),
        "xattn.wo": (kv_ax, g_ax, None, None),
        # dense MLP (tensor parallel: ff out, ff in); the bare names also
        # catch llama4's shared expert (ffn.shared.wi)
        "ffn.wi": (None, _M),
        "ffn.wg": (None, _M),
        "ffn.wo": (_M, None),
        "wi": (None, _M),
        "wg": (None, _M),
        "wo": (_M, None),
        # MoE stacked experts: expert-parallel over the model axis
        "router": (None, _M),
        "moe.wi": (_M, None, None),
        "moe.wg": (_M, None, None),
        "moe.wo": (_M, None, None),
        # mamba (d_inner = expand * d_model shards over model)
        "in_proj": (None, _M),
        "conv_w": (None, _M),
        "conv_b": (_M,),
        "x_dt": (_M, None),
        "dt_proj": (None, _M),
        "dt_bias": (_M,),
        "x_B": (_M, None),
        "x_C": (_M, None),
        "A_log": (_M, None),
        "D": (_M,),
        "out_proj": (_M, None),
        # RG-LRU (lru_width shards over model)
        "in_x": (None, _M),
        "in_gate": (None, _M),
        "gate_a": (None, _M),
        "gate_x": (None, _M),
        "Lambda": (_M,),
        "out": (_M, None),
    }


def _dlrm_rules() -> dict[str, tuple]:
    """PS-style DLRM placement: the (V, E) table (and the wide (V, 1)
    term) row-sharded over the data axis, each worker holding a V/n
    slice; the interaction and MLP stack replicated.  A PS-stacked
    (n_ps, max_rows, ...) table (:func:`repro_torch.models.dlrm.
    ps_stack_tables`) shards its PS axis over the data axis, else its
    rows within every PS block, else replicates (:func:`_dlrm_ps_spec`).
    """
    return {"embed": ("data", None), "wide": ("data", None)}


# PS-stacked (n_ps, max_rows, ...) table leaves: prefer one device group
# per parameter server, then rows within each shard, then replicate.
_DLRM_PS_PATTERNS = (("data", None, None), (None, "data", None))


def _dlrm_ps_spec(shape, fit_ctx) -> Spec:
    for pat in _DLRM_PS_PATTERNS:
        spec = _fit(pat, shape, fit_ctx)
        if any(e is not None for e in spec):
            return spec
    return _replicated(len(shape))


def _names(path) -> list[str]:
    """The dict keys along a path, innermost last (list indices
    skipped)."""
    return [p for p in path if isinstance(p, str)]


def _lookup(rules: dict[str, tuple], names: list[str]):
    """A leaf's rule from its path names, innermost first.  ``{"w": ...}``
    wrappers are transparent; qualified "parent.name" keys ("attn.wo",
    "ffn.wi") are tried before bare names, so the attention's rank-4 and
    the MLP's rank-2 "wo" cannot collide."""
    names = [n for n in names if n != "w"]
    for i in range(len(names) - 1, -1, -1):
        name, parent = names[i], names[i - 1] if i else ""
        qualified = f"{parent}.{name}"
        if qualified in rules:
            return name, rules[qualified]
        if name in rules:
            return name, rules[name]
    return None, None


def _fit(pattern, shape, mesh_or_size) -> Spec:
    """A trailing-dims pattern fitted to a leaf's shape: left-padded with
    None, and any sharded entry whose axes' size does not divide its dim
    dropped."""
    if pattern is None or len(shape) < len(pattern):
        return _replicated(len(shape))
    entries = [None] * (len(shape) - len(pattern)) + list(pattern)
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        size = (axis_size(mesh_or_size, e)
                if hasattr(mesh_or_size, "axis_names") else mesh_or_size)
        out.append(e if size > 0 and dim % size == 0 else None)
    return Spec(out)


# --------------------------------------------------------------------------
# parameters / optimizer state
# --------------------------------------------------------------------------
def _ref_paths(model, cfg) -> list:
    from ..models import backbone, dlrm, whisper

    if isinstance(model, dlrm.DLRM):
        return dlrm.ref_paths(model)
    if isinstance(model, whisper.Whisper):
        return whisper.ref_paths(model, cfg)
    return backbone.ref_paths(model, cfg)


def _leaf_rule(model, cfg, model_size, mesh):
    """``one(names, shape) -> Spec`` for ``model``'s family."""
    from ..models.dlrm import DLRM

    is_dlrm = (cfg is None or getattr(cfg, "family", None) == "dlrm"
               or isinstance(model, DLRM))
    if is_dlrm:
        rules = _dlrm_rules()
        # no mesh: assume divisible (to_shardings' callers check)
        fit_ctx: Any = mesh if mesh is not None else 1
    else:
        if model_size is None:
            model_size = (mesh.shape[_M] if mesh is not None
                          else PRODUCTION_MODEL_SIZE)
        rules = _lm_rules(ctx.attn_mode(cfg, model_size))
        fit_ctx = mesh if mesh is not None else model_size

    def one(names: list, shape) -> Spec:
        shape = tuple(shape)
        # PS-stacked DLRM tables: (n_ps, max_rows, ...) under embed/wide
        if (is_dlrm and names and names[-1] in ("embed", "wide")
                and len(shape) == 3):
            return _dlrm_ps_spec(shape, fit_ctx)
        # MoE expert stacks: raw rank-3 tensors directly under "ffn"
        if (names and names[-1] in ("wi", "wg", "wo") and len(names) >= 2
                and names[-2] == "ffn"):
            key = f"moe.{names[-1]}"
            if key in rules and len(shape) >= len(rules[key]):
                return _fit(rules[key], shape, fit_ctx)
        _, pattern = _lookup(rules, names)
        # _fit replicates leaves whose rank is below the pattern's (e.g.
        # row-wise Adagrad's (V,) accumulator of a (V, E) table)
        return _fit(pattern, shape, fit_ctx)

    return one


def param_specs(model, cfg=None, model_size: int | None = None, mesh=None
                ) -> list[Spec]:
    """One :class:`Spec` per entry of ``model.parameters()`` (an
    ``LM``, ``Whisper`` or ``DLRM``; parameters on any device, ``meta``
    included: only shapes are read), each named by its place in the
    reference's tree (the model's ``ref_paths``).

    ``cfg=None`` (or a DLRM) selects the DLRM placement (the
    PS-row-sharded table); LM configs choose head axes by
    ``ctx.attn_mode(cfg, model_size)``.  Pass ``mesh`` to fit
    divisibility against its axis sizes (a DLRM vocabulary the worker
    count does not divide then replicates)."""
    one = _leaf_rule(model, cfg, model_size, mesh)
    return [one(_names(path), p.shape)
            for p, (path, _) in zip(model.parameters(),
                                    _ref_paths(model, cfg), strict=True)]


def opt_state_specs(state, model, cfg=None, model_size: int | None = None,
                    mesh=None):
    """Specs of an optimizer state of ``model``'s parameters, the state's
    structure kept: Adam's ``{"mu", "nu", "t"}`` (the moments named as
    their parameters, the step count replicated), row-wise Adagrad's
    per-parameter list (a leaf below its rule's rank replicates), SGD's
    empty list.  The reference's ``param_specs`` of its optimizer
    state."""
    one = _leaf_rule(model, cfg, model_size, mesh)
    names = [_names(path) for path, _ in _ref_paths(model, cfg)]

    def per_param(leaves):
        return [one(n, t.shape) for n, t in zip(names, leaves, strict=True)]

    if isinstance(state, dict):
        return {k: (per_param(v) if isinstance(v, list)
                    else _replicated(v.dim())) for k, v in state.items()}
    return per_param(state)


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------
def batch_specs(cfg, shape, mesh) -> dict:
    """Input-batch specs: the leading (global-batch) dim over the data
    axes where it divides, everything else replicated.  Matches
    :func:`repro_torch.launch.steps.batch_shapes`."""
    from ..launch.steps import batch_shapes

    dp = data_axes(mesh)
    dsize = axis_size(mesh, dp)

    def one(t) -> Spec:
        b_ax = dp if t.dim() and t.shape[0] % dsize == 0 else None
        return Spec([b_ax] + [None] * (t.dim() - 1))

    return {k: one(t) for k, t in batch_shapes(cfg, shape).items()}


# --------------------------------------------------------------------------
# decode caches
# --------------------------------------------------------------------------
def _cache_rules(mode: str) -> dict[str, tuple]:
    kv_ax, _ = _attn_axes(mode)
    B = "__batch__"   # placeholder resolved to the data axes per leaf
    return {
        # KV ring: (B, C, KV, hd); whisper cross K/V: (L, B, enc, KV, hd)
        "k": (B, None, kv_ax, None),
        "v": (B, None, kv_ax, None),
        "cross_k": (B, None, kv_ax, None),
        "cross_v": (B, None, kv_ax, None),
        "pos": None,                      # (C,) slot positions: replicated
        "conv": (B, None, _M),            # (B, K-1, channels)
        "ssm": (B, _M, None),             # (B, d_inner, N)
        "h": (B, _M),                     # (B, lru_width)
    }


def cache_specs(cfg, cache: Any, mesh, global_batch: int):
    """Decode-cache specs, the cache's structure kept: the batch dim over
    the data axes (where it divides), KV heads over the model axis per
    the arch's mode, SSM and RG-LRU channel states over the model axis.
    The port's caches are one dict a layer (no stack axis); whisper's
    cross K/V keep their leading layer axis, padded with None as the
    reference pads its stacks.  ``global_batch`` is the reference's
    argument; divisibility is decided per leaf from the shapes."""
    rules = _cache_rules(ctx.attn_mode(cfg, mesh.shape[_M]))
    dp = data_axes(mesh)

    def one(path, t) -> Spec:
        _, pattern = _lookup(rules, _names(path))
        if pattern is None:
            return _replicated(t.dim())
        pattern = tuple(dp if e == "__batch__" else e for e in pattern)
        return _fit(pattern, t.shape, mesh)

    return tree_map(one, cache)


# --------------------------------------------------------------------------
# ragged-exchange buffers
# --------------------------------------------------------------------------
def exchange_specs(mesh=None) -> dict:
    """Specs of the ragged exchange's global buffers: ``send`` / ``recv``
    (n_src, n_dst, budget, F) blocks with the source axis over the data
    axes, ``counts`` the (n_src, n_dst) valid-row matrix sharded alike
    (its layout before the all-gather), ``out`` the compacted (k_out, F)
    batch, row-sharded."""
    dp = data_axes(mesh) if mesh is not None else "data"
    return {"send": Spec((dp, None, None, None)),
            "recv": Spec((dp, None, None, None)),
            "counts": Spec((dp, None)),
            "out": Spec((dp, None))}


# --------------------------------------------------------------------------
# ZeRO-1
# --------------------------------------------------------------------------
def zero1_specs(specs: Any, shapes: Any, mesh):
    """ZeRO-1: each optimizer-state leaf also sharded over the data axes.
    Its first still-replicated dim the data-axis size divides switches
    to the data axes; leaves without one (small vectors, scalars) stay
    as they are.  Model-axis entries are kept."""
    dp = data_axes(mesh)
    dsize = axis_size(mesh, dp)

    def one(_, spec: Spec, t) -> Spec:
        entries = list(spec)
        for i, dim in enumerate(t.shape):
            if entries[i] is None and dim >= dsize and dim % dsize == 0:
                entries[i] = dp
                return Spec(entries)
        return spec

    return tree_map(one, specs, shapes)


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------
def to_shardings(specs: Any, mesh=None):
    """Each :class:`Spec` as DTensor placements on ``mesh``: a tuple with
    one ``Shard(dim)`` or ``Replicate()`` per mesh axis
    (``torch.distributed.tensor``), the structure kept.  Entries naming
    axes the mesh lacks ("pod" on a single-pod mesh) are dropped, not an
    error.  ``mesh=None`` is the host's (:func:`repro_torch.launch.mesh.
    make_host_mesh`).  Building placements needs no process group."""
    from torch.distributed.tensor import Replicate, Shard

    if mesh is None:
        from ..launch.mesh import make_host_mesh
        mesh = make_host_mesh()

    def one(_, spec: Spec) -> tuple:
        dims = {}
        for d, e in enumerate(spec):
            names = e if isinstance(e, tuple) else (e,)
            if e is not None and all(n in mesh.axis_names for n in names):
                for n in names:
                    dims[n] = d
        return tuple(Shard(dims[a]) if a in dims else Replicate()
                     for a in mesh.axis_names)

    return tree_map(one, specs)
