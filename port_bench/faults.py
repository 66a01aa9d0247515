"""Faults planted under a run's timed path, to show that the comparison
deciding ``correct`` catches them (``tests/test_port_bench_faults.py``, and
``control.py`` on the card): each wraps a codec program and breaks it in
one way.

- ``HalfBatch``: half of the batch left out: the program serves the first
  half and returns it twice.
- ``AlteredAnswer``: one answer altered where it is produced: the first
  image's latent moved by one step.
"""

import torch


def _half(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_half(v) for v in x)
    return x[: x.shape[0] // 2]


def _twice(v):
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return torch.cat([v, v])
    return v


class HalfBatch:
    def __init__(self, program):
        self.program = program

    def prepare(self, raw):
        return self.program.prepare(raw)

    def submit(self, x):
        return self.program.submit(_half(x))

    def canonical(self, out):
        return {k: _twice(v) for k, v in self.program.canonical(out).items()}


class AlteredAnswer:
    def __init__(self, program):
        self.program = program

    def prepare(self, raw):
        return self.program.prepare(raw)

    def submit(self, x):
        return self.program.submit(x)

    def canonical(self, out):
        out = dict(self.program.canonical(out))
        latent = out["latent"].clone()
        latent[0] += 1
        out["latent"] = latent
        return out


FAULTS = {"half": HalfBatch, "altered": AlteredAnswer}


def program_for(c, side: str):
    """What runs in a cell's program's place on ``side``: ``program`` (the
    port), ``control`` (the reference in the precision below the cell's,
    its workload's ``control``) or ``fault:<name>`` (a fault above, planted
    under the port); a function of the state dict, as
    ``harness.Cell.make_program``."""
    if side == "program":
        return c.make_program
    if side == "control":
        return lambda sd: c.reference.Control(sd, c.workload["control"])
    fault = FAULTS[side.split(":", 1)[1]]
    return lambda sd: fault(c.adapter.build(c.workload, c.config, sd, c.device))
