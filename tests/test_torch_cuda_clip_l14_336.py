"""CLIP ViT-L/14@336 as the G2L scorer on the card: the feature stage's CUDA
graph (``pipeline/score_graph.py``) at the published widths (577-token
streams, 24 blocks, G2L from block 21, GEM at 448 px: 1,025 tokens), bucket
8, bf16, against the benchmark's float32 reference (``benchmark/benchref/``)
on the same seeded weights, image and masks; every G2L block's attention
launched as K6 on the tensor cores, none on the plain path. Marked ``cuda``;
skips where no CUDA card is present."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core.config import ClipConfig, GemConfig, GuidanceConfig, PipelineConfig
from hybridgl_tpu_torch.kernels import launch_counts, tc_launch_counts
from hybridgl_tpu_torch.models.sam.amg import Proposals
from hybridgl_tpu_torch.pipeline.score_graph import ScoreGraph
from hybridgl_tpu_torch.tools.check_kernels import clip_launches_per_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))

from benchlib.weights import cast, clip_tree, seeded_model  # noqa: E402
from benchref.clip import CLIP  # noqa: E402
from benchref.score import fusion_features, gem_patch_features  # noqa: E402
from benchref.spec import clip_spec  # noqa: E402

pytestmark = pytest.mark.cuda

C, H, W, P, LIVE = 640, 424, 640, 8, 6  # a COCO-sized image whose 424 rows put grid row 13 on source row 238


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_feature_graph_at_published_widths_matches_the_reference(dev):
    """Tolerances, the benchmark's limits of the same numbers at ViT-B/16
    (``benchmark/limits/refcoco-occupancy.json``): each live proposal's G2L
    feature within 0.03 relative on average (bf16 through 24 blocks against
    float32: ~1-2%; the float8 control reads ~0.08), each GEM patch feature
    (unit rows) within 0.03."""
    with open(os.path.join(REPO, "benchmark", "configs", "refcoco-samh-clipl14-336.json")) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = seeded_model(CLIP, clip_spec(spec["clip"]), torch.Generator(device=dev).manual_seed(336), dev)
    clip_cfg = ClipConfig(**spec["clip"])
    assert clip_cfg.seq_len == 577
    cfg = PipelineConfig(clip_config=clip_cfg, canonical_size=C, crop_size=spec["crop_size"],
                         gem=GemConfig(**spec["gem"]), guidance=GuidanceConfig(**spec["guidance"]))
    scorer = ScoreGraph(cfg, cast(clip_tree(model), torch.bfloat16), dev)

    rng = np.random.default_rng(7)
    image = np.zeros((C, C, 3), np.uint8)
    image[:H, :W] = rng.integers(0, 255, (H, W, 3), np.uint8)
    masks = np.zeros((P, C, C), bool)
    boxes = np.zeros((P, 4), np.float32)
    for i in range(LIVE):
        y0, x0 = rng.integers(0, H // 2), rng.integers(0, W // 2)
        y1, x1 = y0 + rng.integers(20, H // 2), x0 + rng.integers(20, W // 2)
        masks[i, y0:y1, x0:x1] = True
        boxes[i] = [x0, y0, x1 - 1, y1 - 1]
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    z = t(np.zeros(P, np.float32))
    props = Proposals(t(masks), t(boxes), z, z, t(np.zeros((P, 2), np.float32)), t(masks.sum((-2, -1)).astype(np.float32)),
                      t(np.arange(P) < LIVE), num=LIVE, overflow=0)

    scorer.features(props, image, (H, W))  # the capture
    before, tc_before = launch_counts(), tc_launch_counts()
    feats, gem = scorer.features(props, image, (H, W))  # a replay
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    g2l = clip_launches_per_image(clip_cfg.vision_layers, cfg.guidance.masking_block, cfg.gem.depth, clip_cfg.text_layers)
    assert launched["clip_attention"] == g2l["clip_attention"] == 21 + 2 * 3  # every G2L block call: K6, no plain path
    assert tc_launch_counts()["clip_attention"] - tc_before["clip_attention"] == 27  # all on the tensor cores
    for name in ("qkv_heads", "merge_heads", "inject_layer_norm"):
        assert launched[name] == g2l[name], name

    img = torch.from_numpy(image[:H, :W].copy()).to(dev)
    live = torch.from_numpy(masks[:LIVE, :H, :W].copy()).to(dev)
    with torch.no_grad():
        want = fusion_features(model, img, live, spec)
        want_gem = gem_patch_features(model, img, spec["gem"])
    err = ((feats[:LIVE].float() - want).norm(dim=-1) / want.norm(dim=-1))
    assert float(err.mean()) < 0.03, err.tolist()
    assert gem.shape == want_gem.shape == (32 * 32, clip_cfg.embed_dim)
    assert float((gem.float() - want_gem).norm(dim=-1).max()) < 0.03
