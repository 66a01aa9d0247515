"""What the traffic loops share: the window's clock, opening and closing
the (traced) window, and the outcome a run reports."""

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from .. import trace
from ..adapters._port import launch_counts

# A traced run traces this much of the window at most: a short steady
# stretch keeps the trace and its reading well inside a run's time limit.
TRACE_SECONDS = 5.0


@dataclass
class Outcome:
    setup_s: float
    units: int                       # batches or steps submitted in the window
    launches: Dict[str, int]         # the port's K1/K2/K3 counters over the window
    memory_peak_bytes: int
    trace: Optional[trace.TraceData]
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, Tuple[float, Optional[float]]] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            limit is not None and math.isfinite(v) and v <= limit
            for v, limit in self.checks.values())


class Phases:
    """Set-up's phases on the host clock: ``mark(name)`` ends the phase
    ``name``, which began where the last one ended (the first at the
    process's start). What set-up spends is printed with every run."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.spans: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.spans[name] = now - self.last
        self.last = now


class Clock:
    """The host clock of the window, and the card's completion times on it:
    an event recorded after a unit's work is read back against an event
    recorded at the window's start (on the CPU, the host clock itself)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def start(self) -> float:
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter()
        return self.t0

    def stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, stamp) -> None:
        if self.cuda:
            stamp.synchronize()

    def time_of(self, stamp) -> float:
        return self.t0 + self.e0.elapsed_time(stamp) / 1e3 if self.cuda else stamp

    def release(self) -> None:
        """Give the freed program's memory back before the reference runs."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def open_window(cell):
    """(the window's length, the open trace or None): the profiler started
    (a traced run), the device idle, the window's start marked."""
    window_s = min(cell.seconds, TRACE_SECONDS) if cell.trace else cell.seconds
    traced = trace.Window().__enter__() if cell.trace else None
    cell.launches_at_start = launch_counts()
    Clock(cell.device).sync()
    if traced is not None:
        traced.mark()
    return window_s, traced


def close_window(cell, clock: Clock, traced, t0: float, units: int) -> Outcome:
    """Wait for the window's work, close the trace, read the counters and
    the memory peak."""
    clock.sync()
    data = None
    if traced is not None:
        traced.mark()
        traced.__exit__(None, None, None)
        data = traced.read()
    now = launch_counts()
    launches = {k: now[k] - cell.launches_at_start[k] for k in now}
    peak = torch.cuda.max_memory_allocated(clock.device) if clock.cuda else 0
    return Outcome(setup_s=t0 - cell.t_start, units=units, launches=launches,
                   memory_peak_bytes=peak, trace=data)


def worst_checks(readings, limits: dict) -> Dict[str, Tuple[float, Optional[float]]]:
    """Each number's worst (largest) reading over ``readings``, beside its
    limit (None where the workload sets none)."""
    return {name: (max(r[name] for r in readings), limits.get(name)) for name in readings[0]}
