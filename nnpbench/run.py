#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 nnpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output and each number the check compared, beside its limit, as
the last lines of standard error.  Exits 2 without a result where the
card the cell needs is missing, 3 where a forbidden module (JAX or the
JAX package) was loaded.  See nnpbench/README.md.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".nnpbench_cache")
# every build and kernel cache at a fixed path inside the checkout; the
# port's own CUDA builds go to torchmdnet_tpu_torch/_build, inside it too
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="makes the inputs and the weights")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer metrics")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from nnpbench import harness

    sys.exit(harness.main(args, T_PROCESS, ROOT))
