"""The port's small extras against the JAX package on CPU: visual prompts,
the CLIP ModifiedResNet, the host-side CLIP preprocessing, the bucket helper,
the analytic FLOP model, the IoU metrics' public functions, the plain CLIP
image encoder (``vit_blocks``, ``encode_image``), ``gem_heatmap`` and
``make_attn_bias``. Inputs come from numpy seeds; each test states its
tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import AMG_PHRASECUT, AMG_REFCOCO, FUSION_MODES, GemConfig, PipelineConfig, clip_preset
from hybridgl_tpu.core.convert import normalize_state_dict
from hybridgl_tpu.core.params import init_clip as jax_init_clip
from hybridgl_tpu.eval import metrics as jmetrics
from hybridgl_tpu.models.clip import fusion as jfusion
from hybridgl_tpu.models.clip import vit as jvit
from hybridgl_tpu.models.gem import gem as jgem
from hybridgl_tpu.models.clip import preprocess as jpre
from hybridgl_tpu.models.clip import resnet as jresnet
from hybridgl_tpu.pipeline import visual_prompts as jvp
from hybridgl_tpu.utils import buckets as jbuckets
from hybridgl_tpu.utils import flops as jflops
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.eval import metrics
from hybridgl_tpu_torch.models.clip import fusion, preprocess, resnet, vit
from hybridgl_tpu_torch.models.gem import gem
from hybridgl_tpu_torch.pipeline import visual_prompts as vp
from hybridgl_tpu_torch.utils import buckets, flops

from torch_port_config import to_port


def _mask(rng, h, w):
    m = np.zeros((h, w), bool)
    y0, x0 = (int(v) for v in rng.integers(2, h // 3, 2))
    m[y0 : y0 + h // 2, x0 : x0 + w // 2] = True
    m[y0 + 2, x0 + 3] = False
    return m


def test_mask2chw_and_mask2img_match_jax():
    rng = np.random.default_rng(0)
    for h, w in ((20, 30), (33, 17)):
        m = _mask(rng, h, w)
        (cy, cx), hh, ww = vp.mask2chw(torch.from_numpy(m))
        (jcy, jcx), jhh, jww = jvp.mask2chw(jnp.asarray(m))
        assert (int(cy), int(cx), int(hh), int(ww)) == (int(jcy), int(jcx), int(jhh), int(jww))
        out = vp.mask2img(torch.from_numpy(m))
        assert out.dtype == torch.uint8
        np.testing.assert_array_equal(out.numpy(), np.asarray(jvp.mask2img(jnp.asarray(m))))


@pytest.mark.parametrize("kinds", [("blur",), ("circle",), ("black",), ("blur", "circle"), ("blur", "circle", "black")])
def test_apply_visual_prompts_matches_jax_exactly_on_uint8(kinds):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (48, 40, 3)).astype(np.uint8)
    m = _mask(rng, 48, 40)
    kw = dict(color=(255, 0, 0), thickness=1.5, blur_ksize=7)
    want = np.asarray(jvp.apply_visual_prompts(jnp.asarray(img), jnp.asarray(m), kinds, **kw))
    got = vp.apply_visual_prompts(torch.from_numpy(img), torch.from_numpy(m), kinds, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if "circle" in kinds and "black" not in kinds:
        assert (got.numpy()[..., 0] == 255).sum() > 10  # a ring was drawn


def test_gen_gauss_img_statistics():
    """A generator replaces the reference's key, so the noise bits differ:
    clipping, mean and sigma are held instead, beside the reference's own."""
    img = np.full((64, 64, 3), 128, np.uint8)
    got = vp.gen_gauss_img(torch.Generator().manual_seed(0), 2.0, 10.0, torch.from_numpy(img)).numpy()
    want = np.asarray(jvp.gen_gauss_img(jax.random.PRNGKey(0), 2.0, 10.0, jnp.asarray(img)))
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert abs(got.mean() - want.mean()) < 1.0 and abs(got.mean() - 130.0) < 1.0
    assert abs(got.std() - want.std()) < 1.0 and abs(got.std() - 10.0) < 1.0
    hard = vp.gen_gauss_img(torch.Generator().manual_seed(1), 0.0, 300.0, torch.from_numpy(img)).numpy()
    assert hard.min() == 0.0 and hard.max() == 255.0
    again = vp.gen_gauss_img(torch.Generator().manual_seed(0), 2.0, 10.0, torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, again)


@pytest.fixture(scope="module")
def tiny_rn():
    """The synthetic ModifiedResNet of tests/test_clip_resnet.py, with
    randomised BatchNorm statistics, as a normalised numpy state dict."""
    from test_clip_resnet import TinyRN

    torch.manual_seed(0)
    model = TinyRN().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    sd = {f"visual.{k}": v for k, v in model.state_dict().items()}
    sd = {k.replace(".downsample.-1", ".downsample.avg"): v for k, v in sd.items()}
    return model, normalize_state_dict(sd)


def test_convert_resnet_visual_matches_jax(tiny_rn):
    _, sd = tiny_rn
    want, layers_w, heads_w = jresnet.convert_resnet_visual(sd)
    got, layers, heads = resnet.convert_resnet_visual(sd)
    assert (list(layers), heads) == (list(layers_w), heads_w) == ([1, 1, 1, 1], 4)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(a, b)


def test_encode_image_resnet_matches_jax_and_torch(tiny_rn):
    """Same converted params, same images: max|d| <= 1e-4 against the JAX
    function, and the synthetic torch model's own forward within 5e-4."""
    model, sd = tiny_rn
    params, layers, _ = resnet.convert_resnet_visual(sd)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jresnet.encode_image_resnet(params, jnp.asarray(x), layers, model.heads))
    got = resnet.encode_image_resnet(from_numpy_tree(params), torch.from_numpy(x), layers, model.heads)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 16)
    assert np.abs(got.numpy() - want).max() <= 1e-4
    with torch.no_grad():
        ref = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=5e-4)


def test_resnet_blocks_match_jax(tiny_rn):
    """One strided bottleneck and the attention pool on their own: 1e-4."""
    _, sd = tiny_rn
    params, _, _ = resnet.convert_resnet_visual(sd)
    tp = from_numpy_tree(params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    want = np.asarray(jresnet.bottleneck(params["layer2"][0], jnp.asarray(x), 2))
    got = resnet.bottleneck(tp["layer2"][0], torch.from_numpy(x), 2).numpy()
    assert got.shape == want.shape == (2, 4, 4, 64) and np.abs(got - want).max() <= 1e-4
    x = rng.standard_normal((3, 2, 2, 256)).astype(np.float32)
    want = np.asarray(jresnet.attention_pool_2d(params["attnpool"], jnp.asarray(x), 4))
    got = resnet.attention_pool_2d(tp["attnpool"], torch.from_numpy(x), 4).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("hw,size", [((60, 90), 32), ((100, 48), 24), ((32, 32), 32)])
def test_clip_image_preprocess_equals_reference(hw, size):
    img = np.random.default_rng(4).integers(0, 255, (*hw, 3)).astype(np.uint8)
    got, want = preprocess.clip_image_preprocess(img, size), jpre.clip_image_preprocess(img, size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (preprocess.CLIP_MEAN, preprocess.CLIP_STD) == (jpre.CLIP_MEAN, jpre.CLIP_STD)


def test_next_pow2_equals_reference():
    for base in (1, 8):
        for n in range(0, 300):
            assert buckets.next_pow2(n, base) == jbuckets.next_pow2(n, base)
    assert buckets.next_pow2(3) == 4 and buckets.next_pow2(9, base=8) == 16 and buckets.next_pow2(0, base=8) == 8


def _configs():
    for name, amg, canonical in (("refcoco", AMG_REFCOCO, 640), ("phrasecut", AMG_PHRASECUT, 1024)):
        for mode in FUSION_MODES:
            yield pytest.param(
                PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16", fusion_mode=mode, canonical_size=canonical,
                               amg=dataclasses.replace(amg)), id=f"{name}-{mode}")


@pytest.mark.parametrize("cfg", list(_configs()))
def test_flops_equal_reference(cfg):
    """Every function of the FLOP model at the RefCOCO and PhraseCut
    configurations, in each fusion mode: equal to the reference's to 1e-9
    relative."""
    port = to_port(cfg)

    def same(got, want):
        assert want > 0 and abs(got - want) <= 1e-9 * want

    same(flops.vit_block_flops(4096, 196, 1280, 4.0, T_attn=4900), jflops.vit_block_flops(4096, 196, 1280, 4.0, T_attn=4900))
    same(flops.sam_encoder_flops(port.sam), jflops.sam_encoder_flops(cfg.sam))
    for n in (1, 64, 4096 + 4 * 1024):
        same(flops.sam_decode_flops(port.sam, n), jflops.sam_decode_flops(cfg.sam, n))
        same(flops.sam_decode_flops_executed(port.sam, n), jflops.sam_decode_flops_executed(cfg.sam, n))
    same(flops.clip_vit_flops(port.clip, 3), jflops.clip_vit_flops(cfg.clip, 3))
    same(flops.clip_vit_flops(port.clip, 2.5, tokens=50), jflops.clip_vit_flops(cfg.clip, 2.5, tokens=50))
    for P in (8, 64, 128):
        same(flops.clip_fusion_flops(port, P), jflops.clip_fusion_flops(cfg, P))
    same(flops.gem_flops(port), jflops.gem_flops(cfg))
    same(flops.text_flops(port, 3), jflops.text_flops(cfg, 3))
    got, want = flops.pipeline_flops_per_image(port, 64, 2), jflops.pipeline_flops_per_image(cfg, 64, 2)
    assert list(got) == list(want)
    for k in want:
        same(got[k], want[k])
    assert flops.sam_decode_flops_executed(port.sam, 64) < flops.sam_decode_flops(port.sam, 64)


def test_peak_flops_lists_only_the_port_card():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops("NVIDIA H100 PCIe") == 989e12
    assert flops.peak_flops("TPU v5 lite") is None and flops.peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert list(flops.PEAK_FLOPS_BY_DEVICE) == ["NVIDIA H100"]
    from hybridgl_tpu_torch.tools import check_kernels

    assert check_kernels.PEAK_BF16_FLOPS == flops.peak_flops(next(iter(flops.PEAK_FLOPS_BY_DEVICE)))


def _pair(rng, shape=(24, 32), p=0.4):
    return rng.random(shape) < p, rng.random(shape) < p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_update_and_report_equal_reference(seed):
    """update / update_masked (enabled and not) over six samples, the
    accumulator's oIoU and mIoU and report: the reference's f32 sums
    exactly; one empty pair (U = 0 -> IoU 0) included."""
    rng = np.random.default_rng(seed)
    jacc, tacc = jmetrics.IoUAccum.zeros(), metrics.IoUAccum.zeros()
    for k in range(6):
        pred, gt = _pair(rng) if k != 3 else (np.zeros((24, 32), bool), np.zeros((24, 32), bool))
        if k % 2:
            enabled = bool(k % 3)
            jacc = jmetrics.update_masked(jacc, jnp.asarray(pred), jnp.asarray(gt), enabled)
            tacc = metrics.update_masked(tacc, torch.from_numpy(pred), torch.from_numpy(gt), enabled)
        else:
            jiou, jacc = jmetrics.update(jacc, jnp.asarray(pred), jnp.asarray(gt))
            tiou, tacc = metrics.update(tacc, torch.from_numpy(pred), torch.from_numpy(gt))
            assert float(tiou) == float(jiou)
    assert [float(v) for v in tacc] == [float(v) for v in jacc]
    assert float(tacc.overall_iou) == float(jacc.overall_iou) and float(tacc.mean_iou) == float(jacc.mean_iou)
    assert metrics.report(tacc) == jmetrics.report(jacc)


def test_compute_iou_equals_reference():
    """The reference's Compute_IoU signature: a caller's list is extended and
    returned, a fresh list each call without one, a leading target axis squeezed."""
    rng = np.random.default_rng(4)
    mine, theirs = [0.5], [0.5]
    cum = (0.0, 0.0), (0.0, 0.0)
    for k in range(3):
        pred, gt = _pair(rng)
        target = gt[None] if k == 1 else gt
        got = metrics.compute_iou(torch.from_numpy(pred), torch.from_numpy(target), *cum[0], mean_iou=mine)
        want = jmetrics.compute_iou(pred, target, *cum[1], mean_iou=theirs)
        assert got[0] == want[0] and got[2:] == want[2:] and got[1] is mine
        cum = got[2:], want[2:]
    assert mine == theirs and len(mine) == 4
    assert metrics.compute_iou(np.ones((2, 2)), np.ones((2, 2)))[1] == [1.0]
    assert metrics.compute_iou(np.ones((2, 2)), np.zeros((2, 2)))[1] == [0.0]


def test_a_is_part_of_b_equals_reference():
    rng = np.random.default_rng(5)
    b = np.zeros((20, 20), bool)
    b[2:18, 2:18] = True
    inside = np.zeros_like(b)
    inside[3:17, 3:17] = True  # 90%+ inside, IoU 0.77
    small = np.zeros_like(b)
    small[5:8, 5:8] = True  # inside, IoU too small
    spill = np.zeros_like(b)
    spill[0:16, 0:16] = True  # more than 10% outside
    cases = [(inside, b), (small, b), (spill, b), (b, b), (np.zeros_like(b), b), (np.zeros_like(b), np.zeros_like(b))]
    cases += [_pair(rng, (20, 20), 0.7) for _ in range(4)]
    got = [metrics.a_is_part_of_b(torch.from_numpy(x), torch.from_numpy(y)) for x, y in cases]
    assert got == [jmetrics.a_is_part_of_b(x, y) for x, y in cases]
    assert got[:4] == [True, False, False, True]


@pytest.fixture(scope="module")
def tiny_clip():
    """The tiny CLIP from jax's init with noise in its zero-initialised vectors: (cfg, JAX tree, port tree)."""
    cfg = clip_preset("test-tiny")
    rng = np.random.default_rng(6)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_clip(jax.random.PRNGKey(2), cfg))
    tree = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32) if x.ndim == 1 and not x.any() else np.array(x),
        tree)
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), from_numpy_tree(tree)


@pytest.mark.parametrize("cls_only", [True, False])
def test_clip_encode_image_and_vit_blocks_equal_reference(tiny_clip, cls_only):
    """The plain CLIP image encoder and a block range, f32, to 1e-4 (the bar
    of tests/test_torch_clip_gem.py)."""
    cfg, jp, tp = tiny_clip
    img = np.random.default_rng(7).standard_normal((3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = jvit.encode_image(jp["visual"], jnp.asarray(img), cfg, cls_only=cls_only)
    got = vit.encode_image(tp["visual"], torch.from_numpy(img), to_port(cfg), cls_only=cls_only)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
    x = vit.vit_stem(tp["visual"], torch.from_numpy(img), to_port(cfg))
    jx = jvit.vit_stem(jp["visual"], jnp.asarray(img), cfg)
    got, want = vit.vit_blocks(tp["visual"], x, to_port(cfg), 1, 3), jvit.vit_blocks(jp["visual"], jx, cfg, 1, 3)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_gem_heatmap_equals_reference(tiny_clip):
    """[T, S, S] relevance maps of three phrases on a 64^2 image, f32, to 1e-4."""
    cfg, jp, tp = tiny_clip
    gem_cfg = GemConfig(img_size=64, depth=2)
    rng = np.random.default_rng(8)
    img = rng.standard_normal((64, 64, 3)).astype(np.float32)
    text = rng.standard_normal((3, cfg.embed_dim)).astype(np.float32)
    want = jgem.gem_heatmap(jp, jnp.asarray(img), jnp.asarray(text), cfg, gem_cfg)
    got = gem.gem_heatmap(tp, torch.from_numpy(img), torch.from_numpy(text), to_port(cfg), to_port(gem_cfg))
    assert got.shape == want.shape == (3, 64, 64)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_make_attn_bias_equals_reference():
    """The full CLS-row bias [P, 1, L, L] of fractional masks (one empty), exactly."""
    rng = np.random.default_rng(9)
    grid = (rng.random((4, 4, 4)) * (rng.random((4, 4, 4)) > 0.5)).astype(np.float32)
    grid[1] = 0.0
    got = fusion.make_attn_bias(torch.from_numpy(grid))
    want = np.asarray(jfusion.make_attn_bias(jnp.asarray(grid)))
    assert got.shape == want.shape == (4, 1, 17, 17) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
