"""End-to-end parity of the port's HybridGLPipeline with the JAX package's, on
the tiny pipeline of tests/test_pipeline_e2e.py, CPU, f32, same weights:
same proposals (after the host cleanup), same selections per sentence, IoUs
within 1e-4, equal accumulators. Also: the port imports no jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from hybridgl_tpu.core.config import AmgConfig, GemConfig, PipelineConfig
from hybridgl_tpu.core.params import init_clip, init_sam
from hybridgl_tpu.lang import HeuristicParser
from hybridgl_tpu.pipeline import runner as jrunner
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.lang import HeuristicParser as PortHeuristicParser
from hybridgl_tpu_torch.pipeline import runner

from torch_port_config import to_port
from torch_ref import tiny_clip_config
from torch_ref_sam import tiny_sam_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class WordTokenizer:
    """Deterministic stand-in for the BPE tokenizer inside the tiny vocab."""

    sot_token = 99
    eot_token = 100

    def encode(self, text):
        return [sum(map(ord, w)) % 97 + 1 for w in text.split()][:40]


def build_pipelines(fusion_mode):
    """(cfg, JAX pipeline, port pipeline) on the same tiny random weights."""
    clip_cfg, sam_cfg = tiny_clip_config(), tiny_sam_config()
    cfg = PipelineConfig(
        clip_config=clip_cfg,
        sam_config=sam_cfg,
        fusion_mode=fusion_mode,
        canonical_size=32,
        crop_size=clip_cfg.image_size,
        amg=AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
                      stability_score_thresh=0.0, max_proposals=8),
        gem=GemConfig(img_size=32, depth=2),
    )
    cfg = cfg.replace(guidance=cfg.guidance.__class__(masking_block=clip_cfg.vision_layers - 2))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    clip_np, sam_np = to_np(init_clip(keys[0], clip_cfg)), to_np(init_sam(keys[1], sam_cfg))
    rng = np.random.default_rng(0)
    for blk in sam_np["encoder"]["blocks"]:  # nonzero rel-pos so the bias matters
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = (rng.standard_normal(blk["attn"][key].shape) * 0.2).astype(np.float32)
    jax_pipe = jrunner.HybridGLPipeline(
        cfg, jax.tree_util.tree_map(jax.numpy.asarray, sam_np), jax.tree_util.tree_map(jax.numpy.asarray, clip_np),
        parser=HeuristicParser(), tokenizer=WordTokenizer(),
    )
    port_pipe = runner.HybridGLPipeline(
        to_port(cfg), from_numpy_tree(sam_np), from_numpy_tree(clip_np),
        parser=PortHeuristicParser(), tokenizer=WordTokenizer(), device="cpu",
    )
    return cfg, jax_pipe, port_pipe


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines("G2L")


def make_sample(module, seed, canonical=32, h=24, w=32, img=64):
    rng = np.random.default_rng(seed)
    img1024 = np.zeros((img, img, 3), np.uint8)
    rh, rw = img * h // max(h, w), img * w // max(h, w)
    img1024[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((canonical, canonical, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    gt = np.zeros((canonical, canonical), bool)
    gt[4:16, 6:20] = True
    sentences = ["the red cup on the left", "dog under the table", "the big one next to a person"]
    return module.ImageSample(img1024, rh, rw, imgc, h, w, gt, sentences)


def test_run_image_matches_jax(pipelines):
    cfg, jax_pipe, port_pipe = pipelines
    for seed in (0, 1):
        want = jax_pipe.propose(make_sample(jrunner, seed))
        got = port_pipe.propose(make_sample(runner, seed))
        assert got.num == int(want.num) and got.num > 0
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
        np.testing.assert_array_equal(got.boxes_xyxy.numpy(), np.asarray(want.boxes_xyxy))
        np.testing.assert_array_equal(got.areas.numpy(), np.asarray(want.areas))

    js, ts = jax_pipe.init_state(), port_pipe.init_state()
    for seed in (0, 1):
        want = jrunner.materialize_results(jax_pipe.run_image(make_sample(jrunner, seed), js))
        got = runner.materialize_results(port_pipe.run_image(make_sample(runner, seed), ts))
        assert [(r.pure_index, r.final_index) for r in got] == [(r.pure_index, r.final_index) for r in want]
        for a, b in zip(got, want):
            assert abs(a.pure_iou - b.pure_iou) <= 1e-4 and abs(a.final_iou - b.final_iou) <= 1e-4
    assert (ts.k1, ts.k2) == (js.k1, js.k2)
    for acc_t, acc_j in ((ts.pure, js.pure), (ts.final, js.final)):
        np.testing.assert_allclose([float(v) for v in acc_t], [float(v) for v in acc_j], rtol=1e-6)


def test_run_image_l2g_matches_jax():
    """A mode other than G2L end to end (as tests/test_pipeline_e2e.py runs
    L2G): same selections, IoUs within 1e-4, equal accumulators."""
    cfg, jax_pipe, port_pipe = build_pipelines("L2G")
    js, ts = jax_pipe.init_state(), port_pipe.init_state()
    for seed in (0, 1):
        want = jrunner.materialize_results(jax_pipe.run_image(make_sample(jrunner, seed), js))
        got = runner.materialize_results(port_pipe.run_image(make_sample(runner, seed), ts))
        assert port_pipe.last_proposals.num > 0
        assert [(r.pure_index, r.final_index) for r in got] == [(r.pure_index, r.final_index) for r in want]
        for a, b in zip(got, want):
            assert abs(a.pure_iou - b.pure_iou) <= 1e-4 and abs(a.final_iou - b.final_iou) <= 1e-4
    for acc_t, acc_j in ((ts.pure, js.pure), (ts.final, js.final)):
        np.testing.assert_allclose([float(v) for v in acc_t], [float(v) for v in acc_j], rtol=1e-6)


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py fails, printing no result line, where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card refusal")
    done = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True)
    assert done.returncode != 0
    assert '"ok"' not in done.stdout


SENTENCES = [
    "the cup on the left",
    "the dog to the right of the bench",
    "the biggest box",
    "small bird above the water",
    "person in the middle next to a car",
]


def synthetic_props(module, jnp_like):
    """16 slots, 6 live rectangle masks (one invalidated in the middle, as
    the host cleanup leaves them) in the 32x32 canonical frame of a 24x32 image."""
    P, C = 16, 32
    rects = [(2, 3, 12, 14), (5, 16, 20, 30), (0, 0, 24, 32), (10, 8, 18, 20), (14, 1, 23, 9), (3, 22, 9, 31), (6, 6, 16, 26)]
    masks = np.zeros((P, C, C), bool)
    boxes = np.zeros((P, 4), np.float32)
    for i, (y0, x0, y1, x1) in enumerate(rects):
        masks[i, y0:y1, x0:x1] = True
        boxes[i] = [x0, y0, x1 - 1, y1 - 1]
    valid = np.zeros(P, bool)
    valid[: len(rects)] = True
    valid[4] = False
    masks[4] = False
    boxes[4] = 0
    rng = np.random.default_rng(7)
    fields = dict(
        masks=masks, boxes_xyxy=boxes, iou_preds=rng.random(P).astype(np.float32) * valid,
        stability=rng.random(P).astype(np.float32) * valid, points=np.zeros((P, 2), np.float32),
        areas=masks.sum((-2, -1)).astype(np.float32), valid=valid,
    )
    fields = {k: jnp_like(v) for k, v in fields.items()}
    return module.Proposals(**fields, num=int(valid.sum()), overflow=0)


def test_score_image_matches_jax_on_synthetic_proposals(pipelines):
    """Feature + sentence stages on a multi-proposal bundle: same selections
    for sentences with relation, direction and other-noun flags."""
    from hybridgl_tpu.models.sam import amg as jamg
    from hybridgl_tpu_torch.models.sam import amg as tamg

    cfg, jax_pipe, port_pipe = pipelines
    sample_j = make_sample(jrunner, 3)._replace(sentences=SENTENCES)
    sample_t = make_sample(runner, 3)._replace(sentences=SENTENCES)
    js, ts = jax_pipe.init_state(), port_pipe.init_state()
    want = jrunner.materialize_results(
        jax_pipe._score_image(sample_j, synthetic_props(jamg, jax.numpy.asarray), js)
    )
    got = runner.materialize_results(port_pipe._score_image(sample_t, synthetic_props(tamg, torch.from_numpy), ts))
    assert [(r.pure_index, r.final_index) for r in got] == [(r.pure_index, r.final_index) for r in want]
    assert len({r.final_index for r in got}) > 1  # the bundle is not degenerate
    for a, b in zip(got, want):
        assert abs(a.pure_iou - b.pure_iou) <= 1e-4 and abs(a.final_iou - b.final_iou) <= 1e-4
    assert (ts.k1, ts.k2) == (js.k1, js.k2)
    np.testing.assert_allclose([float(v) for v in ts.final], [float(v) for v in js.final], rtol=1e-6)


@pytest.mark.parametrize("hw", [None, (36, 30)])
def test_postprocess_small_regions_matches_jax(hw):
    """Holes filled, islands dropped, duplicates suppressed, an invalid slot
    left alone: the port (native library) against the reference."""
    from hybridgl_tpu.models.sam import amg as jamg
    from hybridgl_tpu.pipeline.postprocess import postprocess_small_regions as jax_postprocess
    from hybridgl_tpu_torch.models.sam import amg as tamg
    from hybridgl_tpu_torch.pipeline.postprocess import postprocess_small_regions

    C = 40
    base = np.zeros((C, C), bool)
    base[5:25, 5:25] = True
    holed = base.copy()
    holed[10:12, 10:13] = False  # 6-px hole
    noisy = base.copy()
    noisy[33:35, 26:28] = True  # 4-px island
    strip = np.zeros((C, C), bool)
    strip[2:30, 27:29] = True  # unchanged, touches the image edge when hw is set
    rng = np.random.default_rng(4)
    speckle = rng.random((C, C)) > 0.8  # many tiny islands
    speckle[15:35, 12:30] = True
    masks = np.stack([base, holed, noisy, strip, speckle, np.zeros((C, C), bool)])
    if hw is not None:  # proposals never reach past the image (PAD_NEG logits there)
        masks[:, hw[0] :, :] = False
        masks[:, :, hw[1] :] = False
    P = len(masks)
    boxes = np.zeros((P, 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    valid = np.array([True, True, True, True, True, False])
    fields = dict(
        masks=masks, boxes_xyxy=boxes, iou_preds=np.linspace(1, 0.5, P).astype(np.float32),
        stability=np.ones(P, np.float32), points=np.zeros((P, 2), np.float32),
        areas=masks.sum((-2, -1)).astype(np.float32), valid=valid,
    )
    want, want_changed = jax_postprocess(
        jamg.Proposals(**fields, num=np.int32(5)), 10, 0.7, return_changed=True, hw=hw
    )
    got, got_changed = postprocess_small_regions(tamg.Proposals(**fields, num=5), 10, 0.7, hw=hw)
    assert got_changed == want_changed and got_changed
    assert got.num == int(want.num)
    for name in ("masks", "boxes_xyxy", "valid", "areas", "iou_preds"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name)
