"""Per-layer metrics: one reader a metric, found by its name."""
