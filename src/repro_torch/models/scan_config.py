"""Layer-stack loop control.

The counterpart of the JAX package's ``models/scan_config.py``.  The
reference applies its stacked layer groups with ``lax.scan`` unless
``UNROLL`` is set; the port keeps one module a layer, so
:func:`scan_apply` is always the Python loop.  ``UNROLL`` keeps the
reference's other meaning: the dry run's cost probes set it, and then
the blockwise attention's key block and the plain linear scan's chunk
grow to ``S // PROBE_INNER_STEPS`` (at least their defaults), as the
reference's do (``launch/dryrun.py``).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = ["UNROLL", "PROBE_INNER_STEPS", "scan_apply"]

UNROLL = False
PROBE_INNER_STEPS = 8  # inner-loop steps while UNROLL (the probes' bound)


def scan_apply(body, carry, xs):
    """The reference's unrolled ``lax.scan``: ``carry, y_i = body(carry,
    x_i)`` over the leading axis of every leaf of ``xs`` (a tensor or a
    nest of dicts, lists and tuples of them), returning ``(carry, ys)``,
    ``ys`` the ``y_i`` stacked on a new leading axis leaf by leaf, or
    ``None`` when every ``y_i`` is ``None``."""
    L = pytree.tree_leaves(xs)[0].shape[0]
    ys = []
    for i in range(L):
        carry, y = body(carry, pytree.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if all(y is None for y in ys):
        return carry, None
    return carry, pytree.tree_map(lambda *zs: torch.stack(zs), *ys)
