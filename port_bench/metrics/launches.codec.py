"""Device kernels launched a batch (the traced window's kernels over its batches)."""

from port_bench.metrics.readers import launches_per_unit as read  # noqa: F401
