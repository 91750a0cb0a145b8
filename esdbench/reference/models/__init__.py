"""Plain forward passes, one module a model kind: ``forward(P, ids,
dense, cfg, mm) -> logits``.  ``P`` maps leaf names to tensors, ``mm``
is the product (so the control can run it at a lower precision)."""
