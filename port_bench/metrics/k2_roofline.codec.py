"""K2's share of its roofline over the window's K2 launches: their least
time at the storage dtype's peaks, from their shapes, over their device
time."""

from port_bench.metrics.readers import roofline


def read(ctx):
    return roofline(ctx, "K2")
