"""The port's SamPredictor, box prompt and the SAM-side helpers it needs,
against the JAX package on CPU, f32, same weights and the same numpy inputs.

Mirrors tests/test_visual_prompts_predictor.py::test_sam_predictor_api for
the API and adds parity: logits max|d| < 1e-3 and equal thresholded masks for
a point, a box, and a box with points, each with and without multimask.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridgl_tpu.core.config import sam_preset
from hybridgl_tpu.kernels import masks as jmasks
from hybridgl_tpu.kernels import resize as jresize
from hybridgl_tpu.models.sam import prompt_encoder as jprompt
from hybridgl_tpu.models.sam import sam as jsam
from hybridgl_tpu.models.sam.predictor import SamPredictor as JaxSamPredictor
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.kernels import masks, resize
from hybridgl_tpu_torch.models.sam import prompt_encoder, sam
from hybridgl_tpu_torch.models.sam.decoder import _tp_for
from hybridgl_tpu_torch.models.sam.predictor import SamPredictor

from test_torch_sam import jax_tree, noisy_params
from torch_port_config import to_port

CFG = sam_preset("test-tiny")


@pytest.fixture(scope="module")
def predictors():
    params = noisy_params(CFG, 3)
    image = np.random.default_rng(5).integers(0, 255, (24, 32, 3)).astype(np.uint8)
    want = JaxSamPredictor(jax_tree(params), CFG)
    got = SamPredictor(from_numpy_tree(params), to_port(CFG))
    assert not got.is_image_set
    want.set_image(image)
    got.set_image(image)
    return want, got


def test_set_image_embedding_matches_jax(predictors):
    """One encoder pass over the same padded frame: max|d| <= 1e-4."""
    want, got = predictors
    assert got.is_image_set
    emb = got.get_image_embedding()
    assert emb.shape == (CFG.embed_grid, CFG.embed_grid, CFG.prompt_dim)
    assert np.abs(emb.numpy() - np.asarray(want.get_image_embedding())).max() <= 1e-4


PROMPTS = {
    # T tokens the decoder sees: 5 output tokens + points (+ the padding point, or the box's 2 corners)
    "point": dict(point_coords=np.array([[16.0, 12.0]]), point_labels=np.array([1.0])),
    "box": dict(box=np.array([4.0, 4.0, 28.0, 20.0])),
    "box+points": dict(point_coords=np.array([[16.0, 12.0], [6.0, 20.0]]), point_labels=np.array([1.0, 0.0]),
                       box=np.array([4.0, 4.0, 28.0, 20.0])),
}


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_predict_matches_jax(predictors, prompt, multimask):
    """Logits max|d| < 1e-3 (low-res and at the image's size), IoU
    predictions |d| < 1e-4, equal thresholded masks."""
    want, got = predictors
    kw = PROMPTS[prompt]
    m_w, iou_w, low_w = want.predict(multimask_output=multimask, **kw)
    m_g, iou_g, low_g = got.predict(multimask_output=multimask, **kw)
    M = 3 if multimask else 1
    assert m_g.shape == (M, 24, 32) and m_g.dtype == np.bool_
    assert iou_g.shape == (M,)
    assert low_g.shape == (M, 4 * CFG.embed_grid, 4 * CFG.embed_grid)
    assert np.abs(low_g - np.asarray(low_w)).max() < 1e-3
    assert np.abs(iou_g - np.asarray(iou_w)).max() < 1e-4
    np.testing.assert_array_equal(m_g, np.asarray(m_w))
    l_w = want.predict(multimask_output=multimask, return_logits=True, **kw)[0]
    l_g = got.predict(multimask_output=multimask, return_logits=True, **kw)[0]
    assert l_g.dtype == np.float32 and np.abs(l_g - np.asarray(l_w)).max() < 1e-3


def test_prompt_token_counts_choose_the_decoder_kernel():
    """One point and a box alone give T = 7 tokens (8 lanes a head: the
    tensor-core K3's shape); a box with two points gives T = 9 (16 lanes)."""
    assert _tp_for(5 + 1 + 1) == 8 and _tp_for(5 + 2) == 8 and _tp_for(5 + 2 + 2) == 16


def test_reset_image_and_top_level_export(predictors):
    import hybridgl_tpu_torch

    assert hybridgl_tpu_torch.SamPredictor is SamPredictor
    assert hybridgl_tpu_torch.PipelineConfig is not None and hybridgl_tpu_torch.HybridGLPipeline is not None
    assert callable(hybridgl_tpu_torch.tokenize)
    with pytest.raises(AttributeError):
        hybridgl_tpu_torch.no_such_name
    fresh = SamPredictor(predictors[1].params, predictors[1].cfg)
    assert fresh.device == torch.device("cpu")
    with pytest.raises(AssertionError, match="set_image"):
        fresh.predict(point_coords=np.array([[1.0, 1.0]]), point_labels=np.array([1.0]))
    fresh.set_image(np.zeros((10, 40, 3), np.uint8))
    assert fresh.is_image_set and fresh._input_hw == (CFG.img_size // 4, CFG.img_size)
    fresh.reset_image()
    assert not fresh.is_image_set


def test_embed_boxes_matches_jax():
    """Corner embeddings of 5 random boxes: max|d| <= 1e-5."""
    params = noisy_params(CFG, 1)["prompt"]
    boxes = np.random.default_rng(2).uniform(0, CFG.img_size, (5, 4)).astype(np.float32)
    want = np.asarray(jprompt.embed_boxes(jax_tree(params), jnp.asarray(boxes), CFG))
    got = prompt_encoder.embed_boxes(from_numpy_tree(params), torch.from_numpy(boxes), to_port(CFG)).numpy()
    assert got.shape == want.shape == (5, 2, CFG.prompt_dim)
    assert np.abs(got - want).max() <= 1e-5


def test_preprocess_functions_match_jax():
    rng = np.random.default_rng(3)
    for h, w in ((480, 640), (333, 500), (640, 427), (7, 1000)):
        assert sam.get_preprocess_shape(h, w, 1024) == jsam.get_preprocess_shape(h, w, 1024)
    img = rng.integers(0, 255, (40, 52, 3)).astype(np.uint8)
    want = np.asarray(jsam.preprocess(jnp.asarray(img), CFG))
    got = sam.preprocess(torch.from_numpy(img), to_port(CFG)).numpy()
    assert got.shape == want.shape == (CFG.img_size, CFG.img_size, 3)
    assert np.abs(got - want).max() <= 1e-5
    low = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    want = np.asarray(jsam.upscale_logits_to_input_frame(jnp.asarray(low), CFG))
    got = sam.upscale_logits_to_input_frame(torch.from_numpy(low), to_port(CFG)).numpy()
    assert got.shape == want.shape == (2, 3, CFG.img_size, CFG.img_size)
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("trail", [(), (3,)])
def test_resize_helpers_match_jax(trail):
    """place_valid_region and sample_region on the same maps as the JAX
    helpers, resize_bilinear_batched against the exact (float64) bilinear
    resize of the valid region: max|d| <= 1e-5. The port computes each
    half-pixel source row as ((2 i + 1) src - out) / (2 out), exact where the
    row is (fault F10), and the JAX helper's float32 product lands up to a ulp
    off, so the two differ by ~1.5e-5 here."""
    rng = np.random.default_rng(4)
    img = rng.standard_normal((30, 44) + trail).astype(np.float32)
    want = np.asarray(jresize.place_valid_region(jnp.asarray(img), (21, 37), (48, 40), (33, 28)))
    got = resize.place_valid_region(torch.from_numpy(img), (21, 37), (48, 40), (33, 28)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
    assert not got[33:].any() and not got[:, 28:].any()
    want = np.asarray(jresize.sample_region(jnp.asarray(img), (4, 9), (17, 30), (24, 20)))
    got = resize.sample_region(torch.from_numpy(img), (4, 9), (17, 30), (24, 20)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
    batch = rng.standard_normal((3, 30, 44) + trail).astype(np.float32)
    region = torch.from_numpy(batch[:, :21, :37]).double()
    region = region.permute(0, 3, 1, 2) if trail else region[:, None]
    exact = torch.nn.functional.interpolate(region, (50, 25), mode="bilinear", align_corners=False)
    want = (exact.permute(0, 2, 3, 1) if trail else exact[:, 0]).float().numpy()
    got = resize.resize_bilinear_batched(torch.from_numpy(batch), (50, 25), (21, 37)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
    u8 = rng.integers(0, 255, (30, 44) + trail).astype(np.uint8)
    want = np.asarray(jresize.sample_region(jnp.asarray(u8), (0, 0), (30, 44), (11, 13)))
    got = resize.sample_region(torch.from_numpy(u8), (0, 0), (30, 44), (11, 13)).numpy()
    assert np.abs(got - want).max() <= 1e-4


def test_mask_helpers_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 3, 20, 24)).astype(np.float32) * 2
    want = np.asarray(jmasks.stability_score(jnp.asarray(logits), 0.0, 1.0))
    got = masks.stability_score(torch.from_numpy(logits), 0.0, 1.0).numpy()
    assert got.shape == want.shape == (4, 3) and np.abs(got - want).max() <= 1e-6
    a, b = rng.random((5, 16, 16)) > 0.5, rng.random((7, 16, 16)) > 0.7
    a[1] = False  # an empty mask: union with an empty b row would be 0
    b[2] = False
    want = np.asarray(jmasks.mask_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = masks.mask_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (5, 7) and np.abs(got - want).max() <= 1e-6
    assert got[1, 2] == 0.0


@pytest.mark.parametrize("dtype,S,Cq,C,tp,GT2,shared,route", [
    (torch.bfloat16, 4096, 128, 256, 8, 64, True, "wgmma"),      # one point or a box alone: T = 7, layer 0
    (torch.bfloat16, 4096, 256, 256, 8, 64, False, "wgmma"),     # ... and the later layers
    (torch.bfloat16, 4096, 128, 256, 16, 128, True, "split"),    # a box with two points: T = 9, 16 lanes a head
    (torch.bfloat16, 4096, 256, 256, 16, 128, False, "split"),
    (torch.bfloat16, 4064, 256, 256, 8, 64, False, "cuda-core"),  # ragged S: one CUDA-core launch as before
    (torch.float32, 300, 64, 64, 16, 128, False, "cuda-core"),   # narrow widths fit in one block at 16 lanes
    (torch.float32, 16, 8, 16, 16, 32, True, "cuda-core"),       # test-tiny with a box and two points
])
def test_decoder_pass_route_by_shape(dtype, S, Cq, C, tp, GT2, shared, route):
    """Which way a CUDA call of K3 runs is decided by dtype and shape alone
    (plain Python, so it is held here): past 8 tokens a head at SAM's width
    the CUDA-core kernel runs the pass as its two halves."""
    from hybridgl_tpu_torch.kernels import decoder_pass
    from hybridgl_tpu_torch.kernels.decoder_attn import I2T, MAX_CTX, SMEM_LIMIT, T2I, variant

    heads = 8 if C == 256 else 2
    assert decoder_pass.pass_route(dtype, S, Cq, C, heads, tp, GT2, shared) == route
    if route == "split":  # both halves fit where the whole pass does not
        step = decoder_pass.split_columns(C, GT2)
        assert step == 64 and GT2 % step == 0 and step * C <= MAX_CTX
        assert variant(I2T, dtype, S, Cq, C, heads, tp, 4, not shared, not shared)[1] <= SMEM_LIMIT
        kind, smem = variant(T2I, dtype, S, C, C, 1, 8, step, False, False)
        assert kind == "wgmma" and smem <= SMEM_LIMIT
