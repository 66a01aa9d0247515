"""Logging meters with reference semantics (reference Meter.py:4-51).

Counterpart of ``iclr_17_compression_tpu/train/meters.py``.
"""

from collections import deque


class WeightedMeter:
    """Running weighted average (reference Meter.py:4-22)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self, total: float = 0.0, count: int = 0):
        self.count = count
        self.total = total
        self.max = -float("inf")
        self.min = float("inf")

    def update(self, val: float, n: int = 1):
        self.count += n
        self.total += val * n
        self.max = max(self.max, val)
        self.min = min(self.min, val)

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class AverageMeter:
    """Windowed running average over the last ``size`` values
    (ring buffer; reference Meter.py:25-51)."""

    def __init__(self, size: int = 100):
        self.size = max(int(size), 1)
        self.reset()

    def reset(self):
        self._buf = deque(maxlen=self.size)
        self.max = -float("inf")
        self.min = float("inf")

    def update(self, val: float):
        self._buf.append(float(val))
        self.max = max(self.max, val)
        self.min = min(self.min, val)

    @property
    def avg(self) -> float:
        if not self._buf:
            return 0.0
        return sum(self._buf) / len(self._buf)

    @property
    def val(self) -> float:
        return self._buf[-1] if self._buf else 0.0
