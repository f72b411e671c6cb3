"""Run one cell of the benchmark once and print its result line:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, with no result line, without a CUDA device, with fewer
devices than the cell asks for, for a name the benchmark does not know,
or when the run loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
