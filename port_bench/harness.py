"""One run of one cell of ``BENCHMARK.json``.

The cell's workload file (``workloads/<cell>.json``) names its
configuration (``configs/<config>.json``, with the plain reference
``reference/<config>.py`` and the port's adapter ``adapters/<config>.py``)
and its traffic mix (``traffic/<traffic>.json``: the parameters of the
loop ``traffic/<generator>.py`` that drives it); each per-layer metric is
read by ``metrics/<metric>.py``. The harness finds them all by name, so a
cell, a configuration, a mix or a metric is added by adding files.

A run makes the inputs and weights from ``--seed``, warms up the cell's
shapes, measures for ``--seconds`` (a traced run: a few seconds of that
window under the profiler), holds what the timed path produced to the
reference, and prints one JSON line last on standard output, after the
compared numbers and their limits as the last lines on standard error. It
prints no result, and exits with another code than 0, where there is no
card or too few, where a traced run's kernels do not match the port's
launch counters, or where JAX or the JAX package was loaded.
"""

import argparse
import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from .traffic.common import Phases

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "iclr_17_compression_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    reference: object = None
    adapter: object = None
    make_program: Optional[Callable] = None
    launches_at_start: dict = field(default_factory=dict)
    phases: Optional[Phases] = None  # set-up's phases, from the process's start


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_workload(name: str) -> dict:
    """The cell's workload file over the parameters of its traffic mix."""
    wl = load_json(HERE / "workloads" / f"{name}.json")
    return {**load_json(HERE / "traffic" / f"{wl['traffic']}.json"), **wl}


def cell(name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
         workload: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its workload (``load_workload``, or ``workload``
    in its place), its configuration, reference and adapter."""
    wl = workload if workload is not None else load_workload(name)
    cfg = load_json(HERE / "configs" / f"{wl['config']}.json")
    c = Cell(name, wl, cfg, seed, seconds, trace, device, t_start)
    c.phases = Phases(t_start)
    c.reference = importlib.import_module(f"port_bench.reference.{wl['config']}")
    c.adapter = importlib.import_module(f"port_bench.adapters.{wl['config']}")
    c.make_program = lambda sd: c.adapter.build(wl, cfg, sd, device)
    return c


def run(c: Cell):
    """The cell's traffic loop: its outcome."""
    return importlib.import_module(f"port_bench.traffic.{c.workload['generator']}").run(c)


def applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def read_metric(name: str, ctx) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


@dataclass
class Context:
    """What a per-layer reader reads: the traced window (``trace``: a
    ``trace.TraceData``), the units (batches or steps) run in it, the
    cell's per-unit kernel calls and model FLOPs, and its storage dtype."""

    trace: object
    units: int
    calls: list
    model_flops: float
    storage: str


def metrics(c: Cell, outcome, bench: dict) -> dict:
    unit_of = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    out = {}
    if not c.trace:
        values = dict(outcome.e2e, setup_s=outcome.setup_s)
        for m in bench["end_to_end"]:
            if applies(m, c.name):
                out[m["name"]] = values[m["name"]]
    else:
        ctx = Context(outcome.trace, outcome.units, c.adapter.kernel_calls(c.workload),
                      c.adapter.model_flops(c.workload), c.workload["storage"])
        for m in bench["per_layer"]:
            if applies(m, c.name):
                value = read_metric(m["name"], ctx)
                if value is not None:
                    out[m["name"]] = value
    return {k: {"value": v, "unit": unit_of[k]} for k, v in out.items()}


def trace_faults(c: Cell, outcome) -> list:
    """Where the traced window's K1/K2/K3 kernels differ from the port's
    launch counters over it (a trace that drops launches would read a false
    idle share), or from the units' kernel calls."""
    faults = []
    seen = outcome.trace.counts()
    per_unit = {k: sum(call.kernel == k for call in c.adapter.kernel_calls(c.workload))
                for k in seen}
    for k in seen:
        if seen[k] != outcome.launches[k]:
            faults.append(f"{k}: {seen[k]} kernels in the trace, {outcome.launches[k]} launched")
        if outcome.launches[k] != per_unit[k] * outcome.units:
            faults.append(f"{k}: {outcome.launches[k]} launched for {outcome.units} units of "
                          f"{per_unit[k]}")
    return faults


def banned_modules() -> list:
    """The top-level names of loaded modules that a run may not load."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(BANNED))


def result(c: Cell, outcome, bench: dict, device: dict) -> dict:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics(c, outcome, bench), "device": device}
    if c.trace:
        device.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    # one host thread: the host's share of a run (its launches) then varies
    # less from run to run
    torch.set_num_threads(1)
    bench = benchmark()
    spec = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if spec is None:
        print(f"port_bench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"port_bench: {args.workload} needs {spec['chips']} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    c = cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    c.phases.mark("imports")
    outcome = run(c)
    if c.trace:
        faults = trace_faults(c, outcome)
        if faults:
            print("port_bench: the trace does not hold the window's launches: "
                  + "; ".join(faults), file=sys.stderr)
            return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = result(c, outcome, bench, device)
    found = banned_modules()
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 3
    spans = ", ".join(f"{k} {v:.3f}" for k, v in c.phases.spans.items())
    print(f"set-up phases (s): {spans}; setup_s {outcome.setup_s:.3f}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
