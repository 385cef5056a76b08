"""Break down the single-crop proposal stage on the card (counterpart of the
reference's tools/profile_proposals.py).

Three nested timings on the same inputs: the SAM encoder only, the encoder +
every decoder chunk of the point grid, and the whole ``generate_proposals``
(adds the pass-1 statistics, boxes, NMS and the canonical placement). The
differences isolate each phase. SAM ViT-H (``BENCH_SAM`` names another
preset), random bf16 weights from seed 0, the AMG's quality thresholds zeroed,
CUDA events around each call after a synchronise, median over five frames.
Needs a CUDA card.

    python -m hybridgl_tpu_torch.tools.profile_proposals
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ._common import card_line, event_ms, require_card, sam_frames, sam_weights


def main(argv=None) -> int:
    require_card("profile_proposals")
    from ..core.config import AmgConfig, PipelineConfig
    from ..models.sam import amg
    from ..models.sam.sam import encode, predict_points, preprocess_padded

    cfg = PipelineConfig(sam_model=os.environ.get("BENCH_SAM", "vit_h"),
                         amg=AmgConfig(pred_iou_thresh=0.0, stability_score_thresh=0.0))
    sam_cfg, amg_cfg, C = cfg.sam, cfg.amg, cfg.canonical_size
    params = sam_weights(sam_cfg)
    rh, rw, h, w = 768, 1024, 480, 640
    frames = sam_frames(np.random.default_rng(0), 6, sam_cfg.img_size, rh, rw)
    grid = torch.from_numpy(amg.build_point_grid(amg_cfg.points_per_side)).cuda()
    coords = (grid * torch.tensor([float(rw), float(rh)], device="cuda"))[:, None, :]
    labels = torch.ones((len(grid), 1), device="cuda")

    def enc_only(im):
        return encode(params, preprocess_padded(im, (rh, rw), sam_cfg), sam_cfg)

    def enc_decode(im):
        emb = enc_only(im)
        B = amg_cfg.points_per_batch
        return [predict_points(params, emb, coords[i : i + B], labels[i : i + B], sam_cfg) for i in range(0, len(grid), B)]

    def full(im):
        return amg.generate_proposals(params, im, rh, rw, h, w, sam_cfg, amg_cfg, C)

    with torch.inference_mode():
        t_enc, t_dec, t_full = (event_ms(fn, frames) for fn in (enc_only, enc_decode, full))
    print(f"card: {card_line()}")
    print(f"encode only:        {t_enc:8.1f} ms")
    print(f"+ decode grid:      {t_dec:8.1f} ms  (decode ~{t_dec - t_enc:.1f})")
    print(f"full proposals:     {t_full:8.1f} ms  (stats/boxes/NMS/placement ~{t_full - t_dec:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
