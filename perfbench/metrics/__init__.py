"""Per-layer metrics: one reader a metric, ``<name>.py`` with ``read(cell,
counts, trace)`` returning the value or None where it finds nothing to
read. ``_counts`` holds the arithmetic they share."""
