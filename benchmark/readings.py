"""The readings the comparison's limits are set from, on the card.

    python3 benchmark/readings.py program --workload <name> --seeds 1,2,3 [--seconds 4]
    python3 benchmark/readings.py control --workload <name> --seeds 1,2,3
    python3 benchmark/readings.py fault --fault <name> --workload <name> --seeds 1,2,3

``program``: one short run of the cell a seed, in one process, with no
limits; ``control``: the control (``benchlib/control.py``) a seed;
``fault``: as ``program``, with a fault of ``benchlib/faults.py`` planted. Each
prints, a seed, one JSON line of the worst reading of every compared number
and of each checked image's, and, with ``--out <file>``, appends it there.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("program", "control", "fault"))
    ap.add_argument("--fault")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", help="a JSONL file the readings are appended to")
    args = ap.parse_args()
    import torch

    from benchlib import check

    if not torch.cuda.is_available():
        print("readings.py: no CUDA card", file=sys.stderr)
        return 2
    huge = {k: float("inf") for k in check.NUMBERS}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        try:
            line = reading(args, seed, t, huge)
        except Exception as e:  # a seed that fails is reported and the others still read
            import traceback

            traceback.print_exc()
            line = {"what": args.what, "workload": args.workload, "seed": seed, "error": repr(e)}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def reading(args, seed, t, huge) -> dict:
    from benchlib import check

    if args.what in ("program", "fault"):
        from benchlib import harness
        from benchlib.faults import FAULTS

        r = harness.run(args.workload, seed, args.seconds, False, t, lims=huge,
                        on_pipeline=FAULTS[args.fault] if args.what == "fault" else None)
        return {"what": args.what if args.what == "program" else f"fault {args.fault}", "workload": args.workload,
                "seed": seed, "metrics": r["metrics"],
                "worst": {k: v["value"] for k, v in r["checks"].items()}, "counts": r["counts"],
                "per_image": {str(k): check.reduce({k: v}) for k, v in harness.LAST["numbers"].items()}}
    from benchlib.control import control_numbers

    per = control_numbers(args.workload, seed)
    return {"what": "control", "workload": args.workload, "seed": seed, "worst": check.reduce(per),
            "per_image": {str(p): check.reduce({p: n}) for p, n in per.items()}}


if __name__ == "__main__":
    sys.exit(main())
