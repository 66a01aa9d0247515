"""Observability: structured metrics and a profiler window.

Counterpart of ``MetricsLogger`` and ``ProfileWindow`` in
``iclr_17_compression_tpu/train/observability.py``:

- ``MetricsLogger``: every metric dict goes to a JSONL event log
  (``events.jsonl``, always) and to TensorBoard scalars where
  ``torch.utils.tensorboard`` imports.
- ``ProfileWindow``: ``torch.profiler`` (host and CUDA activity) over steps
  [start, start + num) of a training loop, written as a Chrome trace
  (``trace_<start>.json``) that the trace viewers of Chrome and Perfetto
  open. The train step marks ``train_step/forward``, ``/backward`` and
  ``/optimizer``, and the K1/K2 Functions their backward recompute
  (``iclr17c::gdn_backward``, ``iclr17c::conv_gdn_backward``), as ranges.
"""

import json
import os
import time
from typing import Dict

import torch


class MetricsLogger:
    """JSONL event log + optional TensorBoard scalars."""

    def __init__(self, save_dir: str, tensorboard: bool = True):
        os.makedirs(save_dir, exist_ok=True)
        self._f = open(os.path.join(save_dir, "events.jsonl"), "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass  # no tensorboard package: JSONL only
            else:
                self._tb = SummaryWriter(log_dir=os.path.join(save_dir, "tb"))

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            name = f"{prefix}{k}"
            try:
                row[name] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(name, row[name], int(step))
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ProfileWindow:
    """Trace steps [start, start+num) of a training loop. Call ``tick(step)``
    once before each step; the trace starts and stops itself. An empty
    ``trace_dir`` turns it off."""

    def __init__(self, trace_dir: str, start_step: int = 10, num_steps: int = 5):
        self.trace_dir = trace_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None

    def tick(self, step: int) -> None:
        if not self.trace_dir:
            return
        if step == self.start and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.trace_dir, f"trace_{self.start}.json"))
            self._prof = None
