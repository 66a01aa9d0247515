"""% of the traced window with no operation running on the device."""

from port_bench.metrics.readers import idle_share as read  # noqa: F401
