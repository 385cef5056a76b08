"""Result logging in the reference's byte-identical format, and eval
progress checkpoints (port of hybridgl_tpu/eval/logging.py).

(reference: Hybridgl_main.py:233-254: an append-mode txt file with two
result rows.)
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from .metrics import IoUAccum


def write_result_log(log_dir: str, dataset: str, split: str, split_by: str, fusion_mode: str,
                     pure: IoUAccum, final: IoUAccum, echo: bool = True) -> str:
    """Append the overall / mean IoU rows to ``result_log_<dataset>_<split>.txt``."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"result_log_{dataset}_{split}.txt")
    overall = float(pure.cum_i) * 100.0 / float(pure.cum_u)
    mean_iou = float(pure.sum_iou) / float(pure.count) * 100.0
    overall_f = float(final.cum_i) * 100.0 / float(final.cum_u)
    mean_f = float(final.sum_iou) / float(final.count) * 100.0
    body = (
        f"\n\n fusion_mode={fusion_mode} "
        f"\nDataset: {dataset} / {split} / {split_by}"
        f"\nOverall IoU / mean IoU"
        f"\npure hybridgl: {overall:.2f} / {mean_iou:.2f}"
        f"\nhybridgl w/ spatial guidance: {overall_f:.2f} / {mean_f:.2f}"
    )
    with open(path, "a") as f:
        f.write(body)
    if echo:
        print(body)
    return path


class ProgressCheckpoint:
    """Eval-progress checkpoint and resume: the last finished index, the
    sticky clamps and both accumulators, written atomically as JSON."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def save(self, index: int, state) -> None:
        if not self.path:
            return
        payload = {
            "index": index,
            "k1": state.k1,
            "k2": state.k2,
            "pure": [float(x) for x in state.pure],
            "final": [float(x) for x in state.final],
            "time": time.time(),
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def load(self, state) -> int:
        """Restore ``state`` in place (accumulators on its device); returns
        the next sample index."""
        if not self.path or not os.path.exists(self.path):
            return 0
        with open(self.path) as f:
            payload = json.load(f)
        dev = state.pure.cum_i.device
        state.k1 = payload["k1"]
        state.k2 = payload["k2"]
        state.pure = IoUAccum(*(torch.tensor(v, dtype=torch.float32, device=dev) for v in payload["pure"]))
        state.final = IoUAccum(*(torch.tensor(v, dtype=torch.float32, device=dev) for v in payload["final"]))
        return payload["index"] + 1
