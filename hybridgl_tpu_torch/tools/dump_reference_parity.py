"""The port's own copy of ``tools/dump_reference_parity.py``, kept verbatim apart from
its docstring's pointers, so that the port needs nothing outside its package.

Instrument the ORIGINAL HybridGL repo to dump per-(ref, sentence)
selection records in our parity schema (docs/ACCURACY_VALIDATION.md step 2).

Run from inside a working checkout/environment of the reference
(fhgyuanshen/HybridGL with its torch deps installed):

    python dump_reference_parity.py --hybridgl /path/to/HybridGL \
        --dataset refcoco --split val --fusion_mode G2L \
        --out refcoco_val_ref.json

It wraps ``Compute_IoU`` and ``torch.argmax`` call sites indirectly by
re-running the reference main loop logic through its own public functions
and recording, per sentence: the argmax proposal index before guidance
("pure") and after guidance ("final"), plus both IoUs. Nothing from the
reference is copied — its modules are imported and driven.

NOTE: this script cannot run in a weights-less environment; it exists so a
weights+data environment can produce the golden side of
hybridgl_tpu_torch/tools/compare_parity.py with zero extra engineering.
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hybridgl", required=True, help="path to the reference checkout")
    ap.add_argument("--dataset", default="refcoco")
    ap.add_argument("--split", default="val")
    ap.add_argument("--fusion_mode", default="G2L")
    ap.add_argument("--out", required=True)
    ap.add_argument("--max_images", type=int, default=0)
    args, extra = ap.parse_known_args()

    sys.path.insert(0, args.hybridgl)
    os.chdir(args.hybridgl)

    import torch  # noqa: E402
    import numpy as np  # noqa: E402

    records = []

    # Wrap the reference's Compute_IoU so every (pure, final) evaluation is
    # recorded in order. The reference calls it exactly twice per sentence:
    # once for the pure-hybrid pick, once after guidance
    # (reference: Hybridgl_main.py:171 and :230).
    import utils as ref_utils  # the reference's utils.py

    original_compute = ref_utils.Compute_IoU
    pending = {}

    def recording_compute(pred, target, cum_i, cum_u, mean_iou=[]):
        out = original_compute(pred, target, cum_i, cum_u, mean_iou)
        this_iou = float(out[0])
        if "pure_iou" not in pending:
            pending["pure_iou"] = this_iou
        else:
            records.append(
                {
                    "ref_id": pending.get("ref_id", len(records)),
                    "sentence": pending.get("sentence", ""),
                    "pure_index": pending.get("pure_index", -1),
                    "final_index": pending.get("final_index", -1),
                    "pure_iou": pending.pop("pure_iou"),
                    "final_iou": this_iou,
                }
            )
            pending.clear()
        return out

    ref_utils.Compute_IoU = recording_compute

    # Wrap torch.argmax to capture the selected indices in call order (the
    # reference argmaxes score_clip then, later, topscores).
    original_argmax = torch.argmax

    def recording_argmax(*a, **kw):
        out = original_argmax(*a, **kw)
        try:
            if out.ndim == 0:
                if "pure_index" not in pending:
                    pending["pure_index"] = int(out)
                else:
                    pending["final_index_topk_pos"] = int(out)
        except Exception:
            pass
        return out

    torch.argmax = recording_argmax

    # Drive the reference main
    import Hybridgl_main as ref_main  # noqa: E402

    parser = ref_utils.default_argument_parser()
    argv = [
        "--dataset", args.dataset, "--split", args.split,
        "--fusion_mode", args.fusion_mode, *extra,
    ]
    ref_args = parser.parse_args(argv)
    with torch.no_grad():
        ref_main.main(ref_args, 224, 224)

    with open(args.out, "w") as f:
        json.dump(
            {
                "meta": {
                    "dataset": args.dataset,
                    "split": args.split,
                    "fusion": args.fusion_mode,
                    "source": "reference",
                },
                "records": records,
            },
            f,
        )
    print(f"wrote {len(records)} records -> {args.out}")


if __name__ == "__main__":
    main()
