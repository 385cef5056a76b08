"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``counts`` and, last, ``checks`` (each compared number
with its limit). The compared numbers are also the last lines of standard
error. Exits non-zero, printing no result, without a CUDA card, or when a
module of JAX or of the JAX package is loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]
CACHE = os.path.join(REPO, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchlib.config import benchmark_file, cell

    bench = benchmark_file()
    w, _ = cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"run.py: {args.workload} needs {w['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    from benchlib.harness import run

    result = run(args.workload, args.seed, args.seconds, bool(args.trace), T_START, bench=bench)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
