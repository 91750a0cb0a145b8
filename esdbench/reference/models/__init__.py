"""One module a model kind, found by the configuration's ``kind``:

  ``leaf_specs(cfg)``        ``(name, shape, scale)`` of every leaf, in
                             the order of the port's
                             ``named_parameters()`` (scale 0: a zero
                             leaf; ``<group>.<i>`` leaves form list
                             ``<group>``);
  ``flops_per_sample(cfg)``  one sample's forward operations;
  ``forward(P, ids, dense, cfg, mm) -> logits``, the plain forward pass:
                             ``P`` maps leaf names to tensors, ``mm`` is
                             the product (so the control can run it at a
                             lower precision).

A new kind is a new module here and nothing else."""
import importlib

__all__ = ["kind_of"]


def kind_of(cfg: dict):
    """The module of ``cfg["kind"]``."""
    return importlib.import_module(f"{__name__}.{cfg['kind']}")
