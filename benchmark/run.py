"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the PyTorch and CUDA port
(``semantic_abstraction_tpu_torch``). Exits non-zero, printing no result,
without a CUDA card (or fewer cards than the cell asks for), without the
port, or when the process has loaded JAX or the JAX package.
"""
import os
import sys

# the checkout's root: the port and this folder (as the package
# ``benchmark``) import from it
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# the kernel and loader builds stay inside the checkout (ops/.build,
# native/.build); a library the port might load must not pull in JAX
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
