"""Per-layer metrics, one reader a file, found by the metric's name.

Each ``<name>.py`` defines ``read(trace, cell) -> float | None``: the
metric from one :class:`benchmark.trace.Trace` of a cell
(:class:`benchmark.run.Cell`), or None where the trace holds nothing for
it, and the harness then leaves the metric out of the line.
"""
