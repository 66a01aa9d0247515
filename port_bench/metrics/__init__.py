"""Per-layer readers, one file per metric of BENCHMARK.json, loaded by name."""
