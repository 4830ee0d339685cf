"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 oocbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers
compared are the last lines of standard error.  Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 2;
if JAX or the JAX package was loaded, it exits 3.  See
``oocbench/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "oocbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import repro_torch
    src = ROOT / "src"
    if src not in pathlib.Path(repro_torch.__file__).resolve().parents:
        print(f"[oocbench] repro_torch comes from {repro_torch.__file__}, "
              f"not from this checkout's {src}", file=sys.stderr)
        return 2
    from oocbench.harness import bench
    return bench.main(args, ROOT, T_START)


if __name__ == "__main__":
    sys.exit(main())
