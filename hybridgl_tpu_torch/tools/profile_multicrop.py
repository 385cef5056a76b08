"""Break down the multicrop (PhraseCut configuration) proposal stage on the
card (counterpart of the reference's tools/profile_multicrop.py).

Three nested timings on the same inputs: the five encoder passes, the encoder
+ the raw pass-1 grid decode (every crop's point chunks through
``predict_points``), and the whole ``generate_proposals_multicrop`` (adds the
pass-1 statistics and boxes, the per-crop and cross-crop NMS, the pass-2
re-decode and the canonical placement). SAM ViT-H (``BENCH_SAM``), random bf16
weights from seed 0, ``AMG_PHRASECUT`` with the quality thresholds zeroed
(``BENCH_PPB`` sets the decode batch), CUDA events around each call after a
synchronise, median over three frames. Needs a CUDA card.

    python -m hybridgl_tpu_torch.tools.profile_multicrop
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ._common import card_line, event_ms, require_card, sam_frames, sam_weights


def main(argv=None) -> int:
    require_card("profile_multicrop")
    from ..core.config import AMG_PHRASECUT, PipelineConfig
    from ..models.sam import amg
    from ..models.sam.prompt_encoder import dense_pe, no_mask_dense
    from ..models.sam.sam import encode, predict_points

    amg_cfg = dataclasses.replace(AMG_PHRASECUT, pred_iou_thresh=0.0, stability_score_thresh=0.0)
    if os.environ.get("BENCH_PPB"):
        amg_cfg = dataclasses.replace(amg_cfg, points_per_batch=int(os.environ["BENCH_PPB"]))
    cfg = PipelineConfig(sam_model=os.environ.get("BENCH_SAM", "vit_h"), amg=amg_cfg, canonical_size=1024)
    sam_cfg, C = cfg.sam, cfg.canonical_size
    params = sam_weights(sam_cfg)
    rh, rw, h, w = 768, 1024, 480, 640
    rng = np.random.default_rng(0)
    frames = sam_frames(rng, 4, sam_cfg.img_size, rh, rw)
    canon = torch.zeros((C, C, 3), dtype=torch.uint8)
    canon[:h, :w] = torch.from_numpy(rng.integers(0, 255, (h, w, 3), np.uint8))
    canon = canon.cuda()
    pe, dense = dense_pe(params["prompt"], sam_cfg), no_mask_dense(params["prompt"], sam_cfg, 1)[0]
    B = amg_cfg.points_per_batch
    geo = torch.from_numpy(amg.geometry(rh, rw, h, w, sam_cfg, amg_cfg)).cuda()  # the stage's geometry input
    consts = amg.stage_constants(sam_cfg, amg_cfg, "cuda")

    def enc5(im):
        return [encode(params, frame, sam_cfg) for frame in amg.multicrop_frames(im, canon, geo, sam_cfg)]

    def enc5_decode(im):
        out = []
        for row, chunks, emb in zip(geo, consts.chunks, enc5(im)):
            scale = torch.stack([row[1], row[0]])  # the crop's (rw, rh)
            labels = torch.ones((B, 1), device="cuda")
            out += [predict_points(params, emb, (pts * scale)[:, None, :], labels, sam_cfg, True, pe=pe, dense=dense)
                    for pts in chunks]
        return out

    def full(im):
        return amg.generate_proposals_multicrop(params, im, rh, rw, canon, h, w, sam_cfg, amg_cfg, C)

    with torch.inference_mode():
        t_enc, t_dec, t_full = (event_ms(fn, frames) for fn in (enc5, enc5_decode, full))
    print(f"card: {card_line()}")
    print(f"encode 5 frames:    {t_enc:8.1f} ms")
    print(f"+ pass-1 decode:    {t_dec:8.1f} ms  (decode ~{t_dec - t_enc:.1f})")
    print(f"full multicrop:     {t_full:8.1f} ms  (stats/NMS/pass-2/placement ~{t_full - t_dec:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
