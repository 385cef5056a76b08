"""Single-image demo of the port: image + expression -> overlay
(counterpart of hybridgl_tpu/cli/demo.py; the reference's demo.py:20-229).

    python -m hybridgl_tpu_torch.cli.demo --img_path img.jpg --ref_text "the dog on the left" --random-weights

Same scoring path as the evaluation CLI, G2L fusion by default; writes the
image with the selected mask highlighted. ``--device`` as in ``cli.main``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from PIL import Image

from ..core.config import AmgConfig, PipelineConfig

from ..data.datasets import build_image_sample
from ..pipeline.runner import HybridGLPipeline, materialize_results
from .main import load_params, resolve_device


def overlay(image: np.ndarray, mask: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Green overlay + contour, like the reference viz (demo.py:211-220)."""
    from ..eval.viz import overlay_mask

    return overlay_mask(image, mask, color=(0, 255, 0), alpha=alpha)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--img_path", required=True)
    p.add_argument("--ref_text", required=True)
    p.add_argument("--fusion_mode", default="G2L")
    p.add_argument("--clip_model", default="ViT-B/16")
    p.add_argument("--sam_model", default="vit_b")
    p.add_argument("--sam_checkpoint", default="")
    p.add_argument("--clip_checkpoint", default="")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--out", default="result.jpg")
    p.add_argument("--points_per_side", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if "test-tiny" in (args.clip_model, args.sam_model):
        from ..core.config import tiny_smoke_config

        cfg = tiny_smoke_config(fusion_mode=args.fusion_mode)
    else:
        cfg = PipelineConfig(clip_model=args.clip_model, sam_model=args.sam_model, fusion_mode=args.fusion_mode,
                             amg=AmgConfig(points_per_side=args.points_per_side))
    sam_params, clip_params = load_params(args, cfg, device)
    pipe = HybridGLPipeline(cfg, sam_params, clip_params, device=device)

    image = np.asarray(Image.open(args.img_path).convert("RGB"))
    sample = build_image_sample(image, [args.ref_text], None, cfg.sam.img_size, cfg.canonical_size)
    props = pipe.propose(sample)
    r = materialize_results(pipe._score_image(sample, props, pipe.init_state()))[0]
    if r.final_index < 0:
        print("no proposals found")
        return
    mask = props.masks[r.final_index].cpu().numpy()[: sample.h, : sample.w]
    Image.fromarray(overlay(np.asarray(sample.image_canonical)[: sample.h, : sample.w], mask)).save(args.out)
    print(f"expression: {args.ref_text!r}")
    print(f"selected proposal: pure={r.pure_index} final={r.final_index}")
    print(f"wrote {args.out}")


def cli():
    main(sys.argv[1:])


if __name__ == "__main__":
    cli()
