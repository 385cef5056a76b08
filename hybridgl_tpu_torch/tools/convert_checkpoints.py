"""Convert torch SAM / CLIP checkpoints to ``.npz`` parameter archives (one-off).

    python -m hybridgl_tpu_torch.tools.convert_checkpoints --sam sam_vit_h_4b8939.pth --out-dir ckpts/
    python -m hybridgl_tpu_torch.tools.convert_checkpoints --clip ViT-B-16.pt --out-dir ckpts/

Writes ``<out-dir>/<name>.npz``, which ``hybridgl_tpu_torch.core.checkpoint.load``
and the CLI's ``--sam_checkpoint`` / ``--clip_checkpoint`` read (and the JAX
package's ``core/checkpoint.load`` too: the layout is the same). The CLI also
takes the ``.pth`` / ``.pt`` directly and converts at every start; converting
once saves that time.
"""

import argparse
import os

from ..core import checkpoint, convert


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sam", default="", help="path to a segment-anything .pth")
    p.add_argument("--clip", default="", help="path to an OpenAI CLIP .pt")
    p.add_argument("--out-dir", default="ckpts")
    args = p.parse_args(argv)
    if not args.sam and not args.clip:
        p.error("pass --sam and/or --clip")
    os.makedirs(args.out_dir, exist_ok=True)

    if args.sam:
        params, cfg = convert.load_torch_sam(args.sam)
        name = os.path.splitext(os.path.basename(args.sam))[0]
        out = os.path.join(args.out_dir, f"{name}.npz")
        checkpoint.save(out, params)
        print(f"SAM ({cfg.encoder_depth} blocks, width {cfg.encoder_width}) -> {out}")

    if args.clip:
        params, cfg = convert.load_torch_clip(args.clip)
        name = os.path.splitext(os.path.basename(args.clip))[0].replace("/", "-")
        out = os.path.join(args.out_dir, f"{name}.npz")
        checkpoint.save(out, params)
        print(f"CLIP ({cfg.vision_layers} blocks, width {cfg.vision_width}) -> {out}")


if __name__ == "__main__":
    main()
