"""Cross-check the analytic FLOP model against PyTorch's own operator count
(counterpart of the reference's tools/flops_audit.py).

The bench's MFU fields lean on ``utils/flops.py``; this tool grounds that
model by running each pipeline stage under
``torch.utils.flop_counter.FlopCounterMode``, which counts matrix products
and convolutions as the model does.

    python -m hybridgl_tpu_torch.tools.flops_audit --device cpu [--sam vit_b] [--tol 0.1] [--proposals 16]
    python -m hybridgl_tpu_torch.tools.flops_audit --device cpu --small   (a narrow geometry: seconds)
    python -m hybridgl_tpu_torch.tools.flops_audit                        (on the card)

``--device cpu`` is the full audit: on CPU tensors every kernel wrapper runs
its plain PyTorch version (the same products at the same shapes, countable),
and a stage whose relative error is beyond ``--tol`` (default 10%) fails.
The default geometry then computes a full ViT forward on the host (minutes
and a few GiB at vit_h); ``--small`` keeps every term of the model visible at
widths a test can afford.

On the card (the default; the tool stops without one) the stages launch the
CUDA kernels, whose products PyTorch's counter cannot see. A stage that
launched a kernel is then held from above only (the operators that were
counted must not exceed the model by more than ``--tol``) and reports its
launches; a stage that launched none is held as on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core.config import AmgConfig, ClipConfig, GemConfig, GuidanceConfig, PipelineConfig, SamConfig


def small_config() -> PipelineConfig:
    """A narrow pipeline whose shapes keep the model's structure: a 32 x 32
    SAM grid (image tokens far outnumber the channels, as at full width, so
    the model's image-stream terms dominate the token-side ones it
    simplifies) with windowed and global blocks, 64 image tokens a CLIP crop."""
    sam = SamConfig(img_size=512, encoder_width=96, encoder_depth=4, encoder_heads=3, encoder_global_idx=(1, 3),
                    window_size=7, prompt_dim=64, decoder_heads=8, decoder_mlp_dim=256, iou_head_hidden=64, mask_in_chans=8)
    clip = ClipConfig(image_size=64, patch_size=8, vision_width=96, vision_layers=6, vision_heads=3, context_length=16,
                      vocab_size=101, text_width=64, text_heads=2, text_layers=3, embed_dim=48)
    return PipelineConfig(clip_config=clip, sam_config=sam, fusion_mode="G2L", canonical_size=64, crop_size=64,
                          amg=AmgConfig(points_per_batch=16, max_proposals=8), gem=GemConfig(img_size=64, depth=3),
                          guidance=GuidanceConfig(masking_block=3))


def _count_kernel_operators() -> None:
    """The counter sees each kernel as one operator (``torch.ops.hybridgl.*``)
    and counts nothing inside it: give each a formula that, on CPU tensors,
    counts the products of its plain version (what ran), and on CUDA tensors
    counts nothing (a launch is outside PyTorch's counter)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    from ..kernels import _ops

    for name, op in _ops.REGISTERED.items():
        target = getattr(torch.ops.hybridgl, name)
        if target in flop_registry:
            continue

        def formula(*args, out_val=None, _plain=op.cpu, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                return 0
            return counted_flops(_plain, *args)

        register_flop_formula(target, get_raw=True)(formula)


def counted_flops(fn, *args) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    _count_kernel_operators()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())


def run_audit(cfg: PipelineConfig, tol: float, n_proposals: int | None = None, verbose: bool = True,
              device: str = "cuda"):
    """Audit every stage of the FLOP model on ``device``; returns a list of result dicts."""
    from ..core.params import cast_tree
    from ..kernels import launch_counts
    from ..core.params import init_clip, init_sam
    from ..models.clip.fusion import hybrid_forward
    from ..models.clip.text import encode_text
    from ..models.gem.gem import gem_image_features
    from ..models.sam.image_encoder import encode_image, prepare_sam_params
    from ..models.sam.sam import predict_points
    from ..utils import flops as F

    sam_cfg, clip_cfg = cfg.sam, cfg.clip
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flops_audit: no CUDA card; the countable plain versions run with --device cpu")
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32  # the kernels' stream dtype on the card
    g = torch.Generator(device=dev).manual_seed(0)
    # the serving tree: the weight-only products prepared once, as the pipeline holds them
    sam_params = prepare_sam_params(cast_tree(init_sam(g, sam_cfg), dtype), sam_cfg)
    clip_params = cast_tree(init_clip(g, clip_cfg), dtype)
    S, B = sam_cfg.img_size, cfg.amg.points_per_batch
    N = n_proposals if n_proposals is not None else cfg.amg.max_proposals
    results = []

    def check(stage, model_fl, fn, *args):
        before = launch_counts()
        counted = counted_flops(fn, *args)
        launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        rel = (counted - model_fl) / model_fl if model_fl else float("inf")
        # a launched kernel's products are outside the counter: the count is then a lower bound
        ok = rel <= tol if launched else abs(rel) <= tol
        results.append({"stage": stage, "model_gf": round(model_fl / 1e9, 4), "counted_gf": round(counted / 1e9, 4),
                        "rel_err": round(rel, 4), "ok": ok})
        if launched:
            results[-1]["kernel_launches"] = launched
        if verbose:
            print(f"{'PASS' if results[-1]['ok'] else 'FAIL'} {stage:12s} model {model_fl / 1e9:10.3f} GF   "
                  f"counted {counted / 1e9:10.3f} GF   rel {rel:+.2%}", file=sys.stderr)

    # SAM encoder: one preprocessed frame -> embedding
    check("sam_encoder", F.sam_encoder_flops(sam_cfg), lambda x: encode_image(sam_params["encoder"], x, sam_cfg),
          torch.zeros((1, S, S, 3), device=dev))
    # SAM decode: one points_per_batch chunk, multimask, on the default route (the side-switched
    # attentions and the shared layer 0 that the executed-FLOP model describes, over the 8 token
    # lanes a head that the kernels and their plain versions pad the 7 tokens to; what is left
    # over the model, ~6%, is layer 0's image->token scores in their block-diagonal form); the
    # canonical count of the reference architecture's work is recorded beside it
    emb = torch.zeros((sam_cfg.embed_grid, sam_cfg.embed_grid, sam_cfg.prompt_dim), dtype=dtype, device=dev)
    check("sam_decode", F.sam_decode_flops_executed(sam_cfg, B, token_lanes=8),
          lambda e, c, l: predict_points(sam_params, e, c, l, sam_cfg, True),
          emb, torch.full((B, 1, 2), S / 2.0, device=dev), torch.ones((B, 1), device=dev))
    results[-1]["canonical_gf"] = round(F.sam_decode_flops(sam_cfg, B) / 1e9, 4)
    # CLIP hybrid fusion over N proposals
    Csz, C = cfg.crop_size, cfg.canonical_size
    check("clip_fusion", F.clip_fusion_flops(cfg, N),
          lambda lo, gl, m: hybrid_forward(clip_params["visual"], lo, gl, m, clip_cfg, fusion_mode=cfg.fusion_mode,
                                           masking_block=cfg.guidance.masking_block, compat=cfg.compat, masks_hw=(C, C)),
          torch.zeros((N, Csz, Csz, 3), device=dev), torch.zeros((N, Csz, Csz, 3), device=dev),
          torch.zeros((N, C, C), device=dev))
    # GEM image features
    check("gem", F.gem_flops(cfg), lambda x: gem_image_features(clip_params["visual"], x, clip_cfg, cfg.gem),
          torch.zeros((1, cfg.gem.img_size, cfg.gem.img_size, 3), device=dev))
    # text encoding (sentence + noun phrase + 1 negative)
    check("text", F.text_flops(cfg, 3), lambda t: encode_text(clip_params["text"], t, clip_cfg),
          torch.zeros((3, clip_cfg.context_length), dtype=torch.int64, device=dev))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sam", default="vit_h")
    ap.add_argument("--fusion", default="G2L")
    ap.add_argument("--tol", type=float, default=0.10)
    ap.add_argument("--proposals", type=int, default=None, help="fusion batch (default: the bucket P)")
    ap.add_argument("--small", action="store_true", help="the narrow geometry of small_config()")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; stops without a card) or cpu (the plain versions: the full audit)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("flops_audit: no CUDA card; the countable plain versions run with --device cpu", file=sys.stderr)
        return 2
    cfg = small_config().replace(fusion_mode=args.fusion) if args.small else \
        PipelineConfig(sam_model=args.sam, fusion_mode=args.fusion)
    results = run_audit(cfg, args.tol, n_proposals=args.proposals, device=args.device)
    ok = all(r["ok"] for r in results)
    print(json.dumps({"audit_ok": ok, "device": args.device, "tol": args.tol, "stages": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
