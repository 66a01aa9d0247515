"""The rest of a run, with the look for a card skipped and the timed path
broken underneath, reads ``correct`` false: for each fault a cell can have
(``faults.py``), and for the control (the reference in the program's
place, in the precision below the cell's). The same run unbroken reads
true. Small sizes on the CPU; the cells' own limits."""

import time

import pytest

from port_bench import faults, harness

SMALL = {
    "balle17.serve_bf16_b128": {"batch": 4, "hw": [128, 192], "distinct_batches": 1},
    "balle17.eval_fp32_b32": {"batch": 4, "hw": [128, 192], "distinct_batches": 1},
}
CASES = [(name, fault) for name in sorted(SMALL) for fault in sorted(faults.FAULTS)]


def _run(name, side="program"):
    wl = harness.load_workload(name)
    wl.update(SMALL[name])
    c = harness.cell(name, 2 ** 31 + 7, 0.3, False, "cpu", time.perf_counter(), workload=wl)
    c.make_program = faults.program_for(c, side)
    out = harness.run(c)
    line = harness.result(c, out, harness.benchmark(), {"platform": "cpu"})
    assert list(line)[-1] == "checks"
    return line


def _over(line):
    return [k for k, v in line["checks"].items() if not v["value"] <= v["limit"]]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_an_unbroken_run_reads_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name, fault", CASES)
def test_a_fault_reads_not_correct(name, fault):
    line = _run(name, f"fault:{fault}")
    assert not line["correct"] and _over(line), line["checks"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_reads_not_correct(name):
    line = _run(name, "control")
    assert not line["correct"] and _over(line), line["checks"]
