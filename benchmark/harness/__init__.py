"""The benchmark harness: manifest, traffic, weights, the program's
build, the measured loop, the trace, the check against the reference and
the roofline arithmetic. Everything that belongs to one configuration,
traffic mix or per-layer metric lives in a file of its own under
``benchmark/configs``, ``benchmark/traffic`` or ``benchmark/metrics``,
found by the name ``BENCHMARK.json`` gives it."""
