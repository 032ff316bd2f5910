"""Per-layer metrics, one reader a file, found by the metric's name in
``BENCHMARK.json``. ``read(ctx)`` returns the number, or None where the
run holds nothing to read (the harness then leaves the metric out)."""
