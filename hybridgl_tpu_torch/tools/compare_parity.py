"""Diff two per-ref selection logs (written by the evaluation CLI's
``--parity_log``; counterpart of the reference's tools/compare_parity.py).

    python -m hybridgl_tpu_torch.tools.compare_parity run_a.json run_b.json

Reports selection agreement keyed by (ref_id, sentence) and the first
disagreements: stronger than comparing aggregate oIoU, which can hide
compensating errors.
"""

from __future__ import annotations

import sys

from ..eval.parity import ParityLog, compare


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    res = compare(ParityLog.load(argv[0]), ParityLog.load(argv[1]))
    print(f"compared {res['n']} (ref, sentence) pairs")
    print(f"pure-selection agreement:  {100 * res['pure_agreement']:.2f}%")
    print(f"final-selection agreement: {100 * res['final_agreement']:.2f}%")
    for d in res["diffs"][:20]:
        print("  diff:", d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
