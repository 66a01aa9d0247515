"""The readings that a cell's limits are set from, several seeds in one
process, at the cell's own size on the card:

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 2 --side <side>

``--side program`` reads the port's numbers (the lower readings);
``control`` puts the reference in the program's place in the precision
below the cell's (its workload's ``control``: ``tf32`` for fp32 with TF32
off, ``fp8`` for bf16); ``fault:<name>`` plants a fault of ``faults.py``
under the port. Each seed prints one JSON line of the compared numbers.
The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import port_bench.run  # noqa: E402,F401  (the run's environment: caches, policy)
from port_bench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--side", default="program")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        c = harness.cell(args.workload, seed, args.seconds, False, "cuda:0", time.perf_counter())
        c.make_program = faults.program_for(c, args.side)
        out = harness.run(c)
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "checks": {k: v for k, (v, _) in out.checks.items()},
                          "e2e": out.e2e, "setup_s": out.setup_s}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
