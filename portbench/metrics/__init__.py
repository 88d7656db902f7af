"""Per-layer metrics: one reader a metric, ``read(trace) -> float | None``
over a ``portbench.trace.Summary``; None where the trace holds nothing
for it to read."""
