"""Per-layer metric readers, one file a metric: ``read(run)``."""
