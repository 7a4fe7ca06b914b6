"""The benchmark of ``repro_torch``'s live engine: traffic, weights, the
window, the correctness check, the trace and the metrics. Every cell is
found by name from ``BENCHMARK.json``; nothing here names a cell."""
