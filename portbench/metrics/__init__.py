"""One reader a metric: ``read(rec, name) -> float | None`` over a run's
``drivers.common.Record``.  A reader that finds nothing to read returns
None, and the harness leaves the metric out of the result line."""
