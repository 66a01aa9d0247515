"""The port's benchmark, one cell and one run:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``harness.py`` says what a run does). The
port's kernels build into its fixed cache ``build/iclr17c_torch/`` inside
the checkout; every other cache a run could write is pinned here too, at
fixed paths under ``build/port_bench/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "port_bench"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(CACHE / sub)
os.environ["OMP_NUM_THREADS"] = "1"
# the configurations' stated policy: fp32 products with TF32 off, no
# space-to-depth lowering of small-Cin convs
os.environ["ICLR17C_PRECISION"] = "highest"
os.environ["ICLR17C_S2D"] = "0"
sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
