"""Per-layer metrics, one reader a file: ``read(ctx)`` returns the metric's
value, or None where the run gave it nothing to read."""
