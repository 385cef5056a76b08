"""The proposal stage's CUDA graph on the card (``pipeline/stage_graph.py``):
one capture a configuration across image sizes, each replay bit-equal to the
eager stage on the same inputs with the eager image's launch counts, a
replayed bundle that outlives the next replay, and ``run_dataset`` through
the graph equal to ``run_image``. Small f32 configurations (the single-crop
and multicrop ones of ``chip_smoke.py``'s small-input phase, and a ragged
one whose point grid does not fill its last chunk). Marked ``cuda``; each
test skips where no CUDA card is present."""

import dataclasses

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core.config import AmgConfig, GemConfig, PipelineConfig, SamConfig, clip_preset
from hybridgl_tpu_torch.core.params import init_clip, init_sam, tree_map
from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts
from hybridgl_tpu_torch.lang import HeuristicParser
from hybridgl_tpu_torch.models.sam import amg
from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline, ImageSample, materialize_results
from hybridgl_tpu_torch.pipeline.stage_graph import StageGraph
from hybridgl_tpu_torch.tools.dryrun import TinyVocabTokenizer

pytestmark = pytest.mark.cuda

S, C = 512, 128
SAM_CFG = SamConfig(
    img_size=S, encoder_width=64, encoder_depth=2, encoder_heads=2, encoder_global_idx=(1,),
    window_size=8, prompt_dim=32, decoder_heads=2, decoder_mlp_dim=64, iou_head_hidden=32, mask_in_chans=8,
)
SINGLE = AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                   min_mask_region_area=40, max_proposals=8)
MULTICROP = dataclasses.replace(SINGLE, crop_n_layers=1, crop_n_points_downscale_factor=2, max_proposals=16,
                                max_candidates_per_crop=16)
RAGGED = dataclasses.replace(SINGLE, points_per_side=5)  # 25 points in chunks of 8: the last chunk is padded
CONFIGS = {"single_crop": SINGLE, "multicrop": MULTICROP, "ragged": RAGGED}
SIZES = [(96, 128), (128, 80), (40, 128)]  # landscape, portrait, one side below half the canonical frame


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(dev):
    g = torch.Generator().manual_seed(3)
    sam_p, clip_p = init_sam(g, SAM_CFG), init_clip(g, clip_preset("test-tiny"))
    for blk in sam_p["encoder"]["blocks"]:  # nonzero rel-pos so the bias matters
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.2
    move = lambda _, t: t.to(dev)  # noqa: E731
    return tree_map(move, sam_p), tree_map(move, clip_p)


def _config(amg_cfg):
    clip_cfg = clip_preset("test-tiny")
    cfg = PipelineConfig(clip_config=clip_cfg, sam_config=SAM_CFG, canonical_size=C, crop_size=clip_cfg.image_size,
                         amg=amg_cfg, gem=GemConfig(img_size=32, depth=2))
    return cfg.replace(guidance=cfg.guidance.__class__(masking_block=1))


def _sample(seed, h, w):
    rng = np.random.default_rng(seed)
    rh, rw = S * h // max(h, w), S * w // max(h, w)
    img = np.zeros((S, S, 3), np.uint8)
    img[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((C, C, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    gt = np.zeros((C, C), bool)
    gt[10 : h // 2, 20 : w // 2] = True
    return ImageSample(img, rh, rw, imgc, h, w, gt, ["the red cup on the left", "dog under the table"])


def _assert_same_bundle(got, want):
    for name in amg.Proposals._fields:  # num and overflow are ints once the runner has read them
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_capture_replays_every_size_bit_equal_to_eager(dev, name):
    """Three image sizes through one StageGraph: one capture; each replay's
    bundle equal, every field bit for bit, to the eager stage on the same
    inputs; the launches a replay adds equal the eager stage's."""
    sam_p, _ = _params(dev)
    stage = StageGraph(_config(CONFIGS[name]), sam_p, dev)
    for seed, (h, w) in enumerate(SIZES):
        reset_launch_counts()
        got = stage.launch(_sample(seed, h, w))
        replayed = launch_counts()
        reset_launch_counts()
        want = stage.eager()
        eager = launch_counts()
        torch.cuda.synchronize()
        assert stage.captures == 1
        assert replayed == eager and replayed["nms"] >= 1 and replayed["pass1_stats_half"] >= 1
        _assert_same_bundle(got, want)
    assert stage.nodes > 0 and stage.pool_bytes > 0 and stage.capture_ms > 0 and stage.instantiate_ms > 0


def test_a_replayed_bundle_outlives_the_next_replay(dev):
    """A bundle's tensors are its own: the next image's replay rewrites the
    graph's buffers, not the bundle handed out before it."""
    sam_p, _ = _params(dev)
    stage = StageGraph(_config(SINGLE), sam_p, dev)
    first = stage.launch(_sample(0, *SIZES[0]))
    kept = amg.Proposals(*(t.clone() for t in first))
    second = stage.launch(_sample(1, *SIZES[2]))
    torch.cuda.synchronize()
    _assert_same_bundle(first, kept)
    assert not torch.equal(first.masks, second.masks)
    assert all(getattr(first, f).data_ptr() != getattr(stage.outputs, f).data_ptr() for f in amg.Proposals._fields)


@pytest.mark.parametrize("name", ["single_crop", "multicrop"])
def test_run_dataset_through_the_graph_equals_run_image(dev, name):
    """Images of three sizes: run_dataset (image i+1's replay queued before
    image i's cleanup and scoring) gives run_image's bundles, selections,
    IoUs and accumulators, and the pipeline captured its stage once."""
    sam_p, clip_p = _params(dev)
    pipe = HybridGLPipeline(_config(CONFIGS[name]), sam_p, clip_p, HeuristicParser(), TinyVocabTokenizer(), device=dev)
    samples = [_sample(seed, h, w) for seed, (h, w) in enumerate(SIZES)]
    want_state, got_state = pipe.init_state(), pipe.init_state()
    want = []
    for s in samples:
        want.append((materialize_results(pipe.run_image(s, want_state)), pipe.last_proposals))
    got = list(pipe.run_dataset(iter(samples), got_state, yield_props=True))
    assert pipe.stage.captures == 1
    for (_, results, props), (want_results, want_props) in zip(got, want):
        assert materialize_results(results) == want_results
        _assert_same_bundle(props, want_props)
    for a, b in ((got_state.pure, want_state.pure), (got_state.final, want_state.final)):
        assert [float(v) for v in a] == [float(v) for v in b]
