"""The port's small extras against the JAX package on CPU: visual prompts,
the CLIP ModifiedResNet, the host-side CLIP preprocessing, the bucket helper
and the analytic FLOP model. Inputs come from numpy seeds; each test states
its tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import AMG_PHRASECUT, AMG_REFCOCO, FUSION_MODES, PipelineConfig
from hybridgl_tpu.core.convert import normalize_state_dict
from hybridgl_tpu.models.clip import preprocess as jpre
from hybridgl_tpu.models.clip import resnet as jresnet
from hybridgl_tpu.pipeline import visual_prompts as jvp
from hybridgl_tpu.utils import buckets as jbuckets
from hybridgl_tpu.utils import flops as jflops
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.models.clip import preprocess, resnet
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
