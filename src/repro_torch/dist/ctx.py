"""Mesh context: attention-mode selection, the in-model sharding
constraints and the MoE dispatch knobs.

The counterpart of the JAX package's ``dist/ctx.py``.  The model code
(:mod:`repro_torch.models.layers`) asks this module for its
constraints; the dry run calls ``set_attention_specs(cfg, mesh)``
before it traces a step and ``clear()`` after, so tests and
single-card runs (where nothing was set) run the same functions with
every constraint the identity.

Attention head-sharding modes (``attn_mode``), in preference order:

  none  attention-free arch (pure SSM: falcon-mamba);
  kv    n_kv_heads divisible by the model-axis size: shard the KV-head
        axis (q, k and v all shard, nothing replicated);
  g     the GQA group axis divides instead: shard q/wo over the group
        axis, k/v replicated (the only head split for MQA, e.g.
        granite's kv 1, g 48);
  seq   neither head axis divides (smollm's 15 = 5 x 3 heads, yi's kv
        4 / g 8 on a 16-wide model axis): shard the activations over
        the sequence instead.

A mesh here is a description, not a process group: anything with
``axis_names`` and a ``shape`` mapping each name to its size
(:class:`AbstractMesh`, :mod:`repro_torch.launch.mesh`).  The port runs
on one card, where every constraint is the identity; asked to compute
on real tensors under a mesh of more than one device it raises
``NotImplementedError`` (ROADMAP A14.9, multi-device placement).  The
dry run traces on the ``meta`` device, where nothing is placed.

``MOE_BLOCKS`` and ``MOE_BLOCK_SPECS`` (the MoE's block dispatch) live
here too: :func:`repro_torch.models.layers.moe_ffn` reads them.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["MOE_BLOCKS", "MOE_BLOCK_SPECS", "AbstractMesh", "data_axes",
           "axis_size", "attn_mode", "qkv_specs", "set_attention_specs",
           "clear", "constrain_qkv"]

# ---- MoE block dispatch ----------------------------------------------------
MOE_BLOCKS: int = 1          # token-dim blocks of moe_ffn's dispatch
MOE_BLOCK_SPECS = None       # (token_block_spec, expert_buffer_spec) or None

# ---- attention activation constraints (set per trace) ----------------------
# (q_spec, kv_spec, mesh) or None when no mesh context is active.
_QKV = None


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device mesh by its axes alone: ``sizes`` (one per axis) over
    ``axis_names``.  ``shape`` maps each name to its size, as a JAX
    mesh's does; ``size`` is the device count."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.sizes)} sizes for "
                             f"{len(self.axis_names)} axes")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def data_axes(mesh):
    """Mesh axes that carry the batch: ('pod', 'data') on multi-pod
    meshes, 'data' otherwise.  Usable directly as one spec entry."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def axis_size(mesh, entry) -> int:
    """Total device count behind one spec entry."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[n] for n in names)


def attn_mode(cfg, model_size: int) -> str:
    """Head-sharding mode for ``cfg`` on a model axis of ``model_size``."""
    if not getattr(cfg, "n_heads", 0):
        return "none"
    kv = cfg.n_kv_heads
    groups = cfg.n_heads // max(kv, 1)
    if kv % model_size == 0:
        return "kv"
    if groups % model_size == 0:
        return "g"
    return "seq"


def qkv_specs(cfg, mesh):
    """(q_spec, kv_spec) for the post-projection activations q: (B, S,
    KV, G, hd) and k/v: (B, S, KV, hd), or None for mode none."""
    mode = attn_mode(cfg, mesh.shape["model"])
    dp = data_axes(mesh)
    if mode == "kv":
        return (dp, None, "model", None, None), (dp, None, "model", None)
    if mode == "g":
        return (dp, None, None, "model", None), (dp, None, None, None)
    if mode == "seq":
        return (dp, "model", None, None, None), (dp, "model", None, None)
    return None


def set_attention_specs(cfg, mesh) -> str:
    """Install the q/k/v constraints for ``cfg`` on ``mesh``; returns the
    mode (the dry run records it).  Call :func:`clear` when done."""
    global _QKV
    mode = attn_mode(cfg, mesh.shape["model"])
    specs = qkv_specs(cfg, mesh)
    _QKV = None if specs is None else (*specs, mesh)
    return mode


def clear():
    """Drop the installed attention constraints."""
    global _QKV
    _QKV = None


def constrain_qkv(q, k, v):
    """The attention activations under the installed mode: the identity
    on the tensors one card holds (and with nothing installed).  Real
    tensors under a mesh of more than one device raise
    ``NotImplementedError``: the port places nothing across devices."""
    n = 1 if _QKV is None else math.prod(_QKV[2].shape.values())
    if n > 1 and q.device.type != "meta":
        raise NotImplementedError(
            f"attention constraints over a {n}-device mesh on {q.device} "
            f"tensors: the port computes on one device (ROADMAP A14.9, "
            f"multi-device placement)")
    return q, k, v
