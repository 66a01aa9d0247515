#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s ``dsc_train`` phase and report its gradient gate
each time.

    python3 tools/chip_dsc_grad_gate.py [--runs N]

Needs one CUDA card. Each run trains the flagship DSC codec afresh through
the training CLI (cuDNN's backward makes every trained model a little
different) and holds the gradients through K2's Function against the plain
path: the largest and the median tensor's gap, their floor (the largest of
``DSC_PERTURB_SEEDS``' draws of K2's own error), the gate (``DSC_FLOOR_FACTOR``
times the floor), and the TF32-size control, which must miss one of the two
gates. The gate's passes run under ``cudnn_deterministic``, as in
``chip_smoke.py``, where the plain path's gradients must repeat bit for bit.
Prints one JSON line a run and a summary line; exits non-zero if any run
failed a check.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=6)
    args = parser.parse_args()

    import torch

    from iclr_17_compression_tpu_torch.ops.kernels import _build
    from iclr_17_compression_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    tools = chip_smoke.harness(torch, _build.kernels())
    results = {}
    tools.emit = lambda obj: results.update(obj)  # the phase's whole line: keep, not print
    runs = []
    for run in range(args.runs):
        results.clear()
        try:
            chip_smoke.dsc_train_phase(torch, dev, tools)
            error = None
        except chip_smoke.SmokeFailure as e:
            error = str(e)
        keep = {"run": run, "ok": error is None, "error": error,
                "grad_parity": results.get("grad_parity"), "tf32_check": results.get("tf32_check"),
                "seconds": results.get("seconds")}
        runs.append(keep)
        print(json.dumps(keep), flush=True)
    failed = [r["run"] for r in runs if not r["ok"]]
    print(json.dumps({"runs": len(runs), "failed": failed,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
