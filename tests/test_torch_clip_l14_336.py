"""CLIP ViT-L/14@336 as the G2L scorer, on the CPU: the preset's sizes, the
CLI's tower-derived defaults, the resize coordinates that a 24 x 24 mask grid
samples (fault F10: an exact source row stays exact), and the port against
the benchmark's plain float32 reference (``benchmark/benchref/``) at a tiny
tower shaped like this one: patch 14, text width, vision width and joint
embedding all different, G2L from block depth - 3, GEM on a grid interpolated
from the tower's."""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

from hybridgl_tpu_torch.cli.main import build_config, default_argument_parser
from hybridgl_tpu_torch.core.config import ClipConfig, GemConfig, clip_preset
from hybridgl_tpu_torch.kernels.resize import _src_coords, resize_bilinear
from hybridgl_tpu_torch.models.clip.fusion import calculate_score, hybrid_forward, make_cls_bias, resize_masks_to_grid
from hybridgl_tpu_torch.models.clip.text import encode_text
from hybridgl_tpu_torch.models.gem.gem import gem_image_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "benchmark"), REPO]

from benchlib.weights import clip_tree, seeded_model  # noqa: E402
from benchref.clip import CLIP, g2l_forward, gem_features  # noqa: E402
from benchref.spec import clip_spec  # noqa: E402


def test_preset_sizes():
    c = clip_preset("ViT-L/14@336")
    assert (c.image_size, c.patch_size, c.grid, c.num_patches, c.seq_len) == (336, 14, 24, 576, 577)
    assert (c.vision_width, c.vision_layers, c.vision_heads, c.vision_width // c.vision_heads) == (1024, 24, 16, 64)
    assert (c.text_width, c.text_layers, c.text_heads, c.context_length, c.vocab_size) == (768, 12, 12, 77, 49408)
    assert c.embed_dim == 768
    assert c == ClipConfig(**{**vars(clip_preset("ViT-L/14")), "image_size": 336})  # ViT-L/14 at 336 px


@pytest.mark.parametrize("model,crop,block", [("ViT-B/16", 224, 9), ("ViT-B/32", 224, 9), ("ViT-L/14", 224, 21),
                                              ("ViT-L/14@336", 336, 21)])
def test_cli_derives_crop_and_masking_block_from_the_tower(model, crop, block):
    parse = default_argument_parser().parse_args
    cfg = build_config(parse(["--dataset", "refcoco", "--clip_model", model]))
    assert (cfg.crop_size, cfg.guidance.masking_block, cfg.gem.img_size) == (crop, block, 448)
    assert cfg.clip == clip_preset(model)
    cfg = build_config(parse(["--dataset", "refcoco", "--clip_model", model, "--crop_size", "280",
                              "--masking_block", "5", "--gem_img_size", "336"]))
    assert (cfg.crop_size, cfg.guidance.masking_block, cfg.gem.img_size) == (280, 5, 336)


def test_cli_keeps_vit_b16_defaults():
    from hybridgl_tpu_torch.core.config import PipelineConfig

    cfg = build_config(default_argument_parser().parse_args(["--dataset", "refcoco"]))
    assert cfg == PipelineConfig(clip_model="ViT-B/16")
    assert (cfg.crop_size, cfg.guidance.masking_block, cfg.gem) == (224, 9, GemConfig())


@pytest.mark.parametrize("src,out,row,exact", [(454, 14, 3, 113), (526, 14, 10, 394), (424, 24, 13, 238)])
def test_exact_source_rows_stay_exact(src, out, row, exact):
    """((2 i + 1) src - out) / (2 out): PhraseCut's 454 px side on ViT-B/16's
    14 x 14 grid, refcoco-occupancy's 526 px, and a COCO side of 424 on this
    tower's 24 x 24 grid (the product form gave 112.99999, 394.00003 and
    237.99998), also with the side a device scalar."""
    for size in (src, torch.tensor(src)):
        c = _src_coords(out, size, "cpu")
        assert float(c[row]) == exact
        want = torch.tensor([(2 * i + 1) * src / (2 * out) - 0.5 for i in range(out)], dtype=torch.float64)
        assert torch.allclose(c.double(), want.clamp(0, src - 1), rtol=0, atol=1e-4)


def test_a_patch_off_the_mask_stays_shut():
    """A mask that ends at source row 113 of a 454-row frame covers grid row
    3 of 14 exactly on its boundary: the row before takes no weight from the
    next row, so the CLS bias opens no patch the reference keeps shut."""
    m = torch.zeros((1, 454, 30))
    m[0, 114:, :] = 1.0  # rows 0..113 off
    grid = resize_masks_to_grid(m, 14)
    assert float(grid[0, 3].abs().max()) == 0.0  # samples row 113 alone, exactly
    allowed = make_cls_bias(grid)[0, 1:].reshape(14, 14) == 0
    assert not allowed[:4].any() and allowed[4:].all()
    x = resize_bilinear(m[0, :, :, None], (14, 14))[..., 0]
    assert torch.equal(x, grid[0])


# a tiny tower shaped like ViT-L/14@336: patch 14, 10 tokens (a 3 x 3 grid), text width 48 != vision width 64 !=
# joint embedding 32, G2L from block 1 of 4 (depth - 3), GEM at 56 px (4 x 4, interpolated from 3 x 3)
TINY = dict(image_size=42, patch_size=14, vision_width=64, vision_layers=4, vision_heads=4, context_length=12,
            vocab_size=100, text_width=48, text_heads=3, text_layers=2, embed_dim=32)


@pytest.fixture(scope="module")
def tiny():
    gen = torch.Generator().manual_seed(2026)
    spec = clip_spec(dict(TINY))
    model = seeded_model(CLIP, spec, gen, "cpu")
    cfg = ClipConfig(**TINY)
    assert cfg.vision_layers - 3 == 1 and len({cfg.text_width, cfg.vision_width, cfg.embed_dim}) == 3
    return SimpleNamespace(model=model, params=clip_tree(model), cfg=cfg, gen=torch.Generator().manual_seed(7))


def rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def test_g2l_features_match_the_reference(tiny):
    """The G2L features of 5 proposals on the same crops and masks (sides 40 x
    44: no source row of the 3 x 3 grid is an integer, so the reference's own
    F.interpolate rounds no sample onto a boundary). Tolerance 1e-4 relative:
    both run float32; the port sums its products, LayerNorms and softmax in
    other orders (the fused glue's plain versions, K6's plain version), which
    moves features by ~1e-6 relative through 4 blocks."""
    P, S = 5, TINY["image_size"]
    local = torch.randn((P, 3, S, S), generator=tiny.gen)
    glob = torch.randn((P, 3, S, S), generator=tiny.gen)
    masks = (torch.rand((P, 40, 44), generator=tiny.gen) > 0.5).float()
    masks[0] = 0.0
    masks[0, 10:30, 5:20] = 1.0
    want = g2l_forward(tiny.model, local, glob, masks, masking_block=1)
    got = hybrid_forward(tiny.params["visual"], local.permute(0, 2, 3, 1), glob.permute(0, 2, 3, 1), masks, tiny.cfg,
                         fusion_mode="G2L", masking_block=1)
    assert got.shape == (P, TINY["embed_dim"])
    assert rel(got, want) < 1e-4


def test_gem_patch_features_match_the_reference(tiny):
    """GEM's patch features at 56 px (a 4 x 4 grid, the positional table
    interpolated from 3 x 3), depth 2: tolerance 1e-4 relative, as above."""
    img = torch.randn((2, 3, 56, 56), generator=tiny.gen)
    want = gem_features(tiny.model, img, depth=2, iters=1)
    got, _, G = gem_image_features(tiny.params["visual"], img.permute(0, 2, 3, 1), tiny.cfg, GemConfig(img_size=56, depth=2))
    assert G == 4 and got.shape == want.shape == (2, 16, TINY["embed_dim"])
    assert rel(got, want) < 1e-4


def test_sentence_scores_match_the_reference(tiny):
    """The CLIP scores of 3 sentences (the reference's r = 0.5 ensemble of the
    sentence and its noun phrase) over 5 proposals' G2L features: the text
    tower at width 48 against the reference's, then the scaled cosines.
    Tolerance 1e-4 relative on the text features and on the scores (logits
    ~1e1): float32 both, sums in other orders."""
    tokens = torch.randint(1, TINY["vocab_size"] - 1, (6, TINY["context_length"]), generator=tiny.gen)
    tokens[:, 7:] = 0
    tokens[:, 6] = TINY["vocab_size"] - 1  # the end-of-text id, the highest, pools each row
    want_t = tiny.model.encode_text(tokens)
    got_t = encode_text(tiny.params["text"], tokens.int(), tiny.cfg)
    assert rel(got_t, want_t) < 1e-4
    feats = torch.randn((5, TINY["embed_dim"]), generator=tiny.gen)
    ens = lambda t: 0.5 * t[0::2] + 0.5 * t[1::2]  # noqa: E731
    got = calculate_score(feats, ens(got_t), tiny.params["logit_scale"])
    im = feats / feats.norm(dim=1, keepdim=True)
    tx = ens(want_t)
    want = tiny.model.logit_scale.exp() * im @ (tx / tx.norm(dim=1, keepdim=True)).t()
    assert got.shape == (5, 3) and rel(got, want) < 1e-4


@pytest.mark.parametrize("tower,launches", [
    ((12, 9, 7, 12), None),  # ViT-B/16: the counts chip_smoke holds the card to
    ((24, 21, 7, 12), {"clip_attention": 27, "qkv_heads": 27 + 24, "merge_heads": 27, "bias_quick_gelu": 63,
                       "layer_norm": 9, "residual_layer_norm": 121, "inject_layer_norm": 3, "residual_add": 12,
                       "gem_attention": 24}),
])
def test_clip_launches_an_image(tower, launches):
    """K6 and G1-G7 one RefCOCO image launches (the feature graph and the
    sentence graph once each), as a function of the tower: ViT-B/16's are the
    counts chip_smoke holds the card to; ViT-L/14@336's 27 K6 launches are 21
    trunk blocks on the fused 2P batch and 3 tail blocks on each stream."""
    import chip_smoke
    from hybridgl_tpu_torch.tools.check_kernels import clip_launches_per_image, g2l_launches

    got = clip_launches_per_image(*tower)
    if launches is None:
        assert g2l_launches(12, 9) == chip_smoke.G2L_NODES
        launches = dict(chip_smoke.GLUE_LAUNCHES_PER_IMAGE, clip_attention=chip_smoke.G2L_NODES["clip_attention"],
                        gem_attention=chip_smoke.GEM_ATTENTION_LAUNCHES_PER_IMAGE)
        assert chip_smoke.K6_LAUNCHES_PER_MODE["G2L"] == 15
    assert got == launches
