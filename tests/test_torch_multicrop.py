"""The port's multicrop AMG (PhraseCut configuration, crop_n_layers = 1)
against the JAX package on CPU, f32, same weights: crop boxes, the crop cut
(place_region), generate_proposals_multicrop at test-tiny, and run_image
with a multicrop pipeline. The JAX side runs its Pallas kernels in
interpret mode; the port runs the kernels' plain versions (pass 2 goes
through the decoder's per-prompt route, K7 and K8).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import AmgConfig, GemConfig, PipelineConfig, sam_preset
from hybridgl_tpu.core.params import init_clip, init_sam
from hybridgl_tpu.kernels.resize import place_region as jax_place_region
from hybridgl_tpu.lang import HeuristicParser
from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu.pipeline import runner as jrunner
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.kernels.resize import place_region
from hybridgl_tpu_torch.lang import HeuristicParser as PortHeuristicParser
from hybridgl_tpu_torch.models.sam import amg
from hybridgl_tpu_torch.pipeline import runner

from test_torch_pipeline import WordTokenizer, make_sample
from test_torch_sam import jax_tree, noisy_params
from torch_port_config import to_port
from torch_ref import tiny_clip_config
from torch_ref_sam import tiny_sam_config

AMG_MC = AmgConfig(
    points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0, stability_score_thresh=0.0,
    crop_n_layers=1, crop_n_points_downscale_factor=2, min_mask_region_area=0,
    max_proposals=16, max_candidates_per_crop=16,
)


@pytest.mark.parametrize("hw", [(480, 640), (640, 427), (333, 500), (64, 64)])
def test_crop_boxes_match_jax(hw):
    ratio = 512 / 1500
    want = jamg._crop_boxes_layer1(*hw, ratio)
    got = amg._crop_boxes_layer1(*hw, ratio)
    assert got == [tuple(float(v) for v in box) for box in want]


@pytest.mark.parametrize("case", [
    # (src_hw, out_frame, dst_origin, dst_hw, src_origin, fill)
    ((20, 30), (64, 64), (0, 0), (43, 64), (5, 9), 0.0),  # a crop cut + long-side resize
    ((13, 17), (40, 48), (6, 11), (25, 30), (0, 0), -1e4),  # an uncrop into a padded frame
    ((31, 29), (24, 24), (0, 0), (20, 19), (1, 0), 0.0),  # a downscale
])
def test_place_region_matches_jax(case):
    src_hw, out_frame, dst_origin, dst_hw, src_origin, fill = case
    img = np.random.default_rng(4).integers(0, 255, (40, 44, 3), np.uint8)
    want = jax_place_region(jnp.asarray(img).astype(jnp.float32), src_hw, out_frame, dst_origin, dst_hw,
                            fill=fill, src_origin=src_origin)
    got = place_region(torch.from_numpy(img).float(), src_hw, out_frame, dst_origin, dst_hw, fill=fill,
                       src_origin=src_origin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_generate_proposals_multicrop_matches_jax():
    """test-tiny, 5 crops, per-crop buckets of 16, P = 16: same num, valid,
    kept order, boxes, points and masks; iou within 1e-4, stability 1e-5."""
    cfg = sam_preset("test-tiny")
    params = noisy_params(cfg, 6)
    rng = np.random.default_rng(8)
    canonical, h, w, rh, rw = 32, 24, 32, 48, 64
    img = np.zeros((cfg.img_size, cfg.img_size, 3), np.uint8)
    img[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((canonical, canonical, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    want = jamg.generate_proposals_multicrop(jax_tree(params), jnp.asarray(img), rh, rw, jnp.asarray(imgc), h, w,
                                             cfg, AMG_MC, canonical)
    got = amg.generate_proposals_multicrop(from_numpy_tree(params), torch.from_numpy(img), rh, rw,
                                           torch.from_numpy(imgc), h, w, to_port(cfg), to_port(AMG_MC), canonical)
    assert got.num == int(want.num) and got.num > 0
    assert got.overflow == int(want.overflow)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.iou_preds.numpy(), np.asarray(want.iou_preds), atol=1e-4)  # kept order
    np.testing.assert_allclose(got.stability.numpy(), np.asarray(want.stability), atol=1e-5)
    np.testing.assert_array_equal(got.boxes_xyxy.numpy(), np.asarray(want.boxes_xyxy))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4)
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.areas.numpy(), np.asarray(want.areas))


def test_run_image_multicrop_matches_jax():
    """HybridGLPipeline with a PhraseCut-style config (crop_n_layers = 1,
    host cleanup on): same proposals and selections, IoUs within 1e-4."""
    clip_cfg, sam_cfg = tiny_clip_config(), tiny_sam_config()
    cfg = PipelineConfig(
        clip_config=clip_cfg, sam_config=sam_cfg, fusion_mode="G2L", canonical_size=32,
        crop_size=clip_cfg.image_size, amg=dataclasses.replace(AMG_MC, min_mask_region_area=10),
        gem=GemConfig(img_size=32, depth=2),
    )
    cfg = cfg.replace(guidance=cfg.guidance.__class__(masking_block=clip_cfg.vision_layers - 2))
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    clip_np, sam_np = to_np(init_clip(keys[0], clip_cfg)), to_np(init_sam(keys[1], sam_cfg))
    jax_pipe = jrunner.HybridGLPipeline(cfg, jax_tree(sam_np), jax_tree(clip_np), parser=HeuristicParser(),
                                        tokenizer=WordTokenizer())
    port_pipe = runner.HybridGLPipeline(to_port(cfg), from_numpy_tree(sam_np), from_numpy_tree(clip_np),
                                        parser=PortHeuristicParser(), tokenizer=WordTokenizer(), device="cpu")
    js, ts = jax_pipe.init_state(), port_pipe.init_state()
    want = jrunner.materialize_results(jax_pipe.run_image(make_sample(jrunner, 5), js))
    got = runner.materialize_results(port_pipe.run_image(make_sample(runner, 5), ts))
    props, want_props = port_pipe.last_proposals, jax_pipe.propose(make_sample(jrunner, 5))
    assert props.num == int(want_props.num) and props.num > 0
    np.testing.assert_array_equal(props.valid.numpy(), np.asarray(want_props.valid))
    np.testing.assert_array_equal(props.masks.numpy(), np.asarray(want_props.masks))
    assert [(r.pure_index, r.final_index) for r in got] == [(r.pure_index, r.final_index) for r in want]
    for a, b in zip(got, want):
        assert abs(a.pure_iou - b.pure_iou) <= 1e-4 and abs(a.final_iou - b.final_iou) <= 1e-4
    for acc_t, acc_j in ((ts.pure, js.pure), (ts.final, js.final)):
        np.testing.assert_allclose([float(v) for v in acc_t], [float(v) for v in acc_j], rtol=1e-6)
