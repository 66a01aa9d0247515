"""The traced window: a ``torch.profiler`` run over the measured loop, read
into device events, host ranges and the numbers every per-layer reader
takes.

``Window.read`` keeps the device's kernels, copies and sets (never the
ranges' own device spans), each kernel with the host time of its launch
where the trace pairs the two, and the host ranges the benchmark and the
port record (``port_bench/*``, ``train_step/*``). Busy time is the union of
the device events inside the window; an idle gap is charged to the
innermost host range open when it began.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .work import kernel_of

RANGE_PREFIXES = ("port_bench/", "train_step/", "iclr17c::")


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float
    kernel: Optional[str]   # K1, K2, K2-reduce, K3 or None (``work.kernel_of``)
    copy: bool              # a memcpy or memset, not a kernel
    launch_us: Optional[float] = None  # host time of its launch call


@dataclass
class TraceData:
    events: List[DeviceEvent]
    ranges: List[Tuple[str, float, float]]
    window: Tuple[float, float]  # host-clock microseconds, the profiler's clock
    busy_s: float = 0.0
    gaps: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self, kind: Optional[str] = None) -> List[DeviceEvent]:
        return [e for e in self.events if not e.copy and (kind is None or e.kernel == kind)]

    def counts(self) -> Dict[str, int]:
        return {k: len(self.kernels(k)) for k in ("K1", "K2", "K3")}

    def range_spans(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for n, a, b in self.ranges if n == name]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by the
        host range open when each gap began: at most ``top`` each, seconds."""
        by_op: Dict[str, float] = {}
        for e in self.events:
            by_op[e.name] = by_op.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
        by_range: Dict[str, float] = {}
        for a, b in self.gaps:
            name = self.host_range_at(a) or "outside any range"
            by_range[name] = by_range.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_range.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}

    def host_range_at(self, t: float) -> Optional[str]:
        best = None
        for name, a, b in self.ranges:
            if a <= t < b and (best is None or a >= best[1]):
                best = (name, a)
        return None if best is None else best[0]


def _ns(evt, what: str) -> float:
    """An event's start or duration in microseconds, whichever unit this
    torch's Kineto events offer."""
    fn = getattr(evt, f"{what}_ns", None)
    if fn is not None:
        return fn() / 1e3
    return float(getattr(evt, f"{what}_us")())


class Window:
    """``with Window() as w: <the loop>`` traces the loop; ``w.read()`` after."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def mark(self) -> None:
        """Record the window's start or end on the profiler's clock (after a
        synchronize, so that the device is idle there)."""
        from torch.autograd.profiler import record_function

        with record_function("port_bench/mark"):
            pass

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def read(self) -> TraceData:
        cuda = torch.autograd.DeviceType.CUDA
        raw = list(self.prof.profiler.kineto_results.events())
        launches, ranges, marks, device = {}, [], [], []
        for e in raw:
            name = e.name()
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    device.append((e, name, start, end))
            elif name == "port_bench/mark":
                marks.append(start)
            elif name.startswith(RANGE_PREFIXES):
                ranges.append((name, start, end))
            elif name.startswith(("cuda", "cuLaunch")) and e.correlation_id():
                launches[e.correlation_id()] = start
        if len(marks) != 2:
            raise RuntimeError(f"the trace holds {len(marks)} window marks, not 2")
        lo, hi = sorted(marks)
        events = []
        for e, name, start, end in device:
            if lo <= start and end <= hi:
                copy = name.startswith(("Memcpy", "Memset"))
                events.append(DeviceEvent(name, start, end, None if copy else kernel_of(name),
                                          copy, launches.get(e.correlation_id())))
        events.sort(key=lambda ev: ev.start_us)
        data = TraceData(events, ranges, (lo, hi))
        busy, cursor = 0.0, lo
        for ev in events:
            if ev.start_us > cursor:
                data.gaps.append((cursor, ev.start_us))
            busy += max(0.0, ev.end_us - max(cursor, ev.start_us))
            cursor = max(cursor, ev.end_us)
        if hi > cursor:
            data.gaps.append((cursor, hi))
        data.busy_s = busy / 1e6
        return data
