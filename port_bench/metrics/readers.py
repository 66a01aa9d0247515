"""The arithmetic the per-layer readers share. Each takes a
``harness.Context`` and returns None where the traced window holds
nothing to read (no units, no launch of the kernel)."""

from port_bench.work import MODEL_PEAK, bound_of


def launches_per_unit(ctx):
    """Device kernels launched in the traced window, a batch."""
    return len(ctx.trace.kernels()) / ctx.units if ctx.units else None


def roofline(ctx, kernel: str):
    """% of the least time of the window's ``kernel`` launches (their work
    from the units' shapes, ``work.bound_of``) over their device time; a K2
    call's time takes in its split-K reduction."""
    calls = [c for c in ctx.calls if c.kernel == kernel]
    kinds = (kernel, "K2-reduce") if kernel == "K2" else (kernel,)
    device_ms = sum(e.end_us - e.start_us for e in ctx.trace.kernels()
                    if e.kernel in kinds) / 1e3
    if not calls or not ctx.units or device_ms <= 0:
        return None
    return 100.0 * ctx.units * sum(bound_of(c) for c in calls) / device_ms


def idle_share(ctx):
    """% of the traced window with nothing running on the device."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx):
    """% of the storage dtype's dense peak that the model's FLOPs of the
    window's units make over the window."""
    if not ctx.units:
        return None
    return 100.0 * ctx.model_flops * ctx.units / ctx.trace.window_s / MODEL_PEAK[ctx.storage]
