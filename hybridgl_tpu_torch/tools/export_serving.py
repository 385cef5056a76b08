"""Export two serving stages as portable programs (counterpart of the
reference's ``tools/export_serving.py``, which ``jax.export``s them to
StableHLO): ``torch.export`` traces each stage with its parameters as inputs
and ``torch.export.save`` writes it as a ``.pt2`` file that a serving system
loads without the model code.

    python -m hybridgl_tpu_torch.tools.export_serving --out-dir exported/ [--sam vit_b] \\
        [--clip ViT-B/16] [--proposals 64] [--device cuda|cpu]

The two stages:
  * ``sam_encoder.pt2``: ``models/sam/image_encoder.py:encode_image`` on a
    [1, img, img, 3] image, with the encoder's parameters as
    ``prepare_sam_params`` leaves them (the rel-pos tables built once);
  * ``hybrid_fusion.pt2``: ``models/clip/fusion.py:hybrid_forward`` on P
    [S, S, 3] local and global crops and P [S, S] masks, at
    ``cfg.fusion_mode`` and the guidance's ``masking_block`` (capped at the
    last layer index, ``depth - 2``, so that the miniature presets export
    too; ViT-B/16's 9 is kept).

The kernels are registered operators (``kernels/_ops.py``), so the graphs
hold them as ``torch.ops.hybridgl.*`` nodes (K1 and K2 in the encoder, K6 in
the fusion), never a decomposition, and a loaded program launches the same
CUDA kernels as the eager port. Load a program with :func:`load_exported`,
or import ``hybridgl_tpu_torch`` before ``torch.export.load``: that import
registers the operators. A program traced on one device runs on that device.

Random weights from a ``torch.Generator`` seeded 0 (the reference uses
``PRNGKey(0)``), cast to ``cfg.compute_dtype`` as the CLI serves them.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


class SamEncoder(torch.nn.Module):
    """``encode_image(params, image, cfg)``: [1, img, img, 3] -> [1, g, g, prompt_dim]."""

    def __init__(self, sam_cfg):
        super().__init__()
        self.cfg = sam_cfg

    def forward(self, params, image):
        from ..models.sam.image_encoder import encode_image

        return encode_image(params, image, self.cfg)


class HybridFusion(torch.nn.Module):
    """``hybrid_forward(p_visual, local, glob, masks)`` -> [P, embed_dim] f32."""

    def __init__(self, clip_cfg, fusion_mode: str, masking_block: int):
        super().__init__()
        self.cfg, self.fusion_mode, self.masking_block = clip_cfg, fusion_mode, masking_block

    def forward(self, p_visual, local, glob, masks):
        from ..models.clip.fusion import hybrid_forward

        return hybrid_forward(p_visual, local, glob, masks, self.cfg, fusion_mode=self.fusion_mode,
                              masking_block=self.masking_block)


def fusion_masking_block(cfg) -> int:
    from ..models.clip.fusion import last_layer_index

    return min(cfg.guidance.masking_block, last_layer_index(cfg.clip))


def _without_examples(program: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """Drop the example inputs, which ``torch.export.save`` would write beside
    the graph: here they are the weights (1.3 GB at ViT-H), and a program,
    like the reference's StableHLO, takes its weights as inputs."""
    program.example_inputs = None
    return program


def export_encoder(cfg, encoder_params, device) -> torch.export.ExportedProgram:
    """The SAM encoder stage traced on ``device`` at one [1, img, img, 3] f32 image."""
    image = torch.zeros((1, cfg.sam.img_size, cfg.sam.img_size, 3), device=device)
    return _without_examples(torch.export.export(SamEncoder(cfg.sam), (encoder_params, image)))


def export_fusion(cfg, visual_params, proposals: int, device) -> torch.export.ExportedProgram:
    """The fusion stage traced on ``device`` at P = ``proposals`` crops and masks."""
    S = cfg.clip.image_size
    local, glob = (torch.zeros((proposals, S, S, 3), device=device) for _ in range(2))  # two inputs, not one twice
    masks = torch.zeros((proposals, S, S), device=device)
    module = HybridFusion(cfg.clip, cfg.fusion_mode, fusion_masking_block(cfg))
    return _without_examples(torch.export.export(module, (visual_params, local, glob, masks)))


def kernel_nodes(program: torch.export.ExportedProgram) -> dict:
    """{operator name: count} of the ``torch.ops.hybridgl`` nodes of a graph."""
    counts: dict = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", None) == "hybridgl":
            name = node.target._schema.name.split("::", 1)[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def load_exported(path) -> torch.export.ExportedProgram:
    """A program written by this tool, with the operators it names registered."""
    import hybridgl_tpu_torch  # noqa: F401  (registers torch.ops.hybridgl.*)

    return torch.export.load(path)


def random_weights(cfg, device):
    """(prepared SAM encoder params, CLIP visual params) from seed 0 in ``cfg.compute_dtype``."""
    from ..core.params import cast_tree, init_clip, init_sam
    from ..models.sam.image_encoder import prepare_sam_params

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    sam = cast_tree(init_sam(gen, cfg.sam), dtype)
    clip = cast_tree(init_clip(gen, cfg.clip), dtype)
    return prepare_sam_params({"encoder": sam["encoder"]}, cfg.sam)["encoder"], clip["visual"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default="exported")
    p.add_argument("--sam", default="vit_b")
    p.add_argument("--clip", default="ViT-B/16")
    p.add_argument("--proposals", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..core.config import PipelineConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("export_serving: no CUDA card (pass --device cpu to export for the CPU)", file=sys.stderr)
        raise SystemExit(2)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = PipelineConfig(clip_model=args.clip, sam_model=args.sam)
    encoder_params, visual_params = random_weights(cfg, device)
    for name, program in (("sam_encoder", export_encoder(cfg, encoder_params, device)),
                          ("hybrid_fusion", export_fusion(cfg, visual_params, args.proposals, device))):
        path = os.path.join(args.out_dir, f"{name}.pt2")
        torch.export.save(program, path)
        print(f"{name.replace('_', ' ')} -> {path} ({os.path.getsize(path) / 1e6:.1f} MB; "
              f"kernel nodes {kernel_nodes(program)})")


if __name__ == "__main__":
    main()
