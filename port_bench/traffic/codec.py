"""Closed-loop codec traffic: a client that keeps at most ``in_flight``
batches on the card, cycling over ``distinct_batches`` seeded batches of
``batch`` images of ``hw`` (the parameters of a mix ``<traffic>.json``
whose ``generator`` is ``codec``).

A batch's latency runs from the host starting to submit it to its outputs
being complete (the card's completion time, from CUDA events anchored to
the host clock at the window's start). Throughput counts the transmitted
images' pixels of the work done inside the window, over the window: every
batch completed in it, and the share of the next one that its time on the
card up to the window's close makes. After the window, the last outputs
of each distinct batch are held to the reference (``reference/<config>.py``
``compare``): every batch of the window repeats one of them.
"""

import collections
import time

import numpy as np
from torch.profiler import record_function

from .. import images
from .common import Clock, Outcome, close_window, open_window, worst_checks

WARMUP_ROUNDS = 2


def batches_done(done: np.ndarray, submitted: np.ndarray, t0: float, end: float) -> float:
    """The batches done by ``end``: those completed by then, and the share
    of the first one still running that lies before it. Batches run one
    after another on the card, so that one ran from the later of its
    submission and the previous batch's completion (or ``t0``) to its own
    completion."""
    n = int((done <= end).sum())
    if n == len(done):
        return float(n)
    start = max(submitted[n], done[n - 1] if n else t0)
    return n + min(max((end - start) / (done[n] - start), 0.0), 1.0)


def run(cell) -> Outcome:
    wl, dev = cell.workload, cell.device
    sd = cell.reference.state(cell.config, cell.seed, dev)
    cell.phases.mark("weights")
    program = cell.make_program(sd)
    cell.phases.mark("program")
    raw = [cell.reference.make_batch(images.generator(cell.seed, 100 + k, dev), wl["batch"],
                                     wl["hw"], dev) for k in range(wl["distinct_batches"])]
    inputs = [program.prepare(r) for r in raw]
    Clock(dev).sync()
    cell.phases.mark("inputs")
    for _ in range(WARMUP_ROUNDS):
        for x in inputs:
            program.submit(x)
    clock = Clock(dev)
    clock.sync()
    cell.phases.mark("warm-up")

    window_s, traced = open_window(cell)
    records, inflight, kept = [], collections.deque(), {}
    t0 = clock.start()
    i = 0
    while time.perf_counter() - t0 < window_s:
        while len(inflight) >= wl["in_flight"]:
            with record_function("port_bench/wait"):
                clock.wait(inflight.popleft())
        k = i % len(inputs)
        submitted = time.perf_counter()
        with record_function("port_bench/submit"):
            kept[k] = program.submit(inputs[k])
        stamp = clock.stamp()
        records.append((submitted, stamp))
        inflight.append(stamp)
        i += 1
    outcome = close_window(cell, clock, traced, t0, units=len(records))

    done = np.array([clock.time_of(stamp) for _, stamp in records])
    submitted = np.array([s for s, _ in records])
    pixels = wl["batch"] * wl["hw"][0] * wl["hw"][1]
    work = float(batches_done(done, submitted, t0, t0 + window_s))
    outcome.e2e = {"codec_mpix_s": work * pixels / window_s / 1e6,
                   "codec_batch_ms_p95": 1e3 * float(np.percentile(done - submitted, 95))}
    outcome.attempted = len(records)
    kept = {k: program.canonical(out) for k, out in kept.items()}
    del program, inputs, records, inflight
    clock.release()
    outcome.checks = worst_checks(
        [cell.reference.compare(sd, raw[k], kept[k]) for k in sorted(kept)],
        wl.get("limits", {}))
    return outcome
