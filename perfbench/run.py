"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is the result (see harness/main.py); the
numbers compared with the reference, each beside its limit, are the last
lines of standard error.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache in the checkout, at fixed paths, so that only
# a checkout's first run builds; the port's own kernels build into
# ocean_perception_tpu_torch/_build/ there.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(var, str(ROOT / ".perfbench_cache" / sub))
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, str(ROOT))

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0_fallback=T0))
