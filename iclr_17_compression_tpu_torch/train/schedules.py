"""Learning-rate schedules of the reference trainers.

Counterpart of ``iclr_17_compression_tpu/train/schedules.py``:

- ``step_decay_schedule``: linear warmup → constant base LR → one-shot decay
  ×``decay`` after ``decay_interval`` steps (reference train.py:69-81), a
  plain ``step → lr`` function that the train step applies to the optimizer
  before each update (the JAX package hands it to ``optax.adam``, which
  evaluates it at the update count, from 0);
- ``ReduceLROnPlateau``: the host-side plateau controller of the DSC
  trainers (factor 0.1, patience 10, min mode).
"""

from typing import Callable


def step_decay_schedule(
    base_lr: float,
    decay: float = 0.1,
    decay_interval: int = 2200000,
    warmup_step: int = 0,
) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if warmup_step > 0 and step < warmup_step:
            return base_lr * step / warmup_step
        return base_lr if step < decay_interval else base_lr * decay

    return schedule


class ReduceLROnPlateau:
    """Multiply the LR by ``factor`` after more than ``patience``
    non-improving epochs."""

    def __init__(
        self,
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
        base_lr: float = 1e-4,
    ):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.lr = base_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
