"""The port keeps its own copies of the JAX package's jax-free modules
(config, environment flags, expression parsers, tokenizer, RLE codec, native
region cleanup). Each copy must go on agreeing with its original, exactly:
these tests catch drift between the two."""

import dataclasses

import numpy as np
import pytest

import hybridgl_tpu.core.config as ref_config
import hybridgl_tpu_torch.core.config as port_config

from test_torch_pipeline import SENTENCES

TEXTS = SENTENCES + [
    "The LARGE brown dog,  on the left!",
    "a person's red-and-white umbrella (behind the 2nd table)",
    "café au lait &amp; crème brûlée",
    "",
]


def as_plain(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ["ViT-B/16", "ViT-B/32", "ViT-L/14", "test-tiny"])
def test_clip_presets_agree(name):
    a, b = port_config.clip_preset(name), ref_config.clip_preset(name)
    assert as_plain(a) == as_plain(b)
    assert (a.grid, a.num_patches, a.seq_len) == (b.grid, b.num_patches, b.seq_len)


@pytest.mark.parametrize("name", ["vit_b", "vit_l", "vit_h", "test-tiny"])
def test_sam_presets_agree(name):
    a, b = port_config.sam_preset(name), ref_config.sam_preset(name)
    assert as_plain(a) == as_plain(b)
    assert (a.embed_grid, a.num_mask_tokens) == (b.embed_grid, b.num_mask_tokens)


@pytest.mark.parametrize("build", [
    lambda m: m.PipelineConfig(),
    lambda m: m.PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16", fusion_mode="G2L"),
    lambda m: m.tiny_smoke_config(),
    lambda m: m.tiny_smoke_config(fusion_mode="attn_masking"),
    lambda m: m.AMG_REFCOCO,
    lambda m: m.AMG_PHRASECUT,
    lambda m: m.CompatConfig(),
    lambda m: m.GuidanceConfig(),
    lambda m: m.GemConfig(),
], ids=["default", "vit_h", "tiny", "tiny-attn", "amg-refcoco", "amg-phrasecut", "compat", "guidance", "gem"])
def test_configs_agree_field_by_field(build):
    a, b = build(port_config), build(ref_config)
    assert type(a).__name__ == type(b).__name__
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    assert as_plain(a) == as_plain(b)
    if hasattr(a, "sam"):
        assert as_plain(a.sam) == as_plain(b.sam) and as_plain(a.clip) == as_plain(b.clip)


def test_config_constants_and_fields_agree():
    assert port_config.FUSION_MODES == ref_config.FUSION_MODES
    classes = [n for n, v in vars(ref_config).items() if dataclasses.is_dataclass(v)]
    assert classes and classes == [n for n, v in vars(port_config).items() if dataclasses.is_dataclass(v)]


def test_env_flags_agree(monkeypatch):
    from hybridgl_tpu.utils import env as ref_env
    from hybridgl_tpu_torch.utils import env as port_env

    for value in (None, "", "0", "false", "OFF", "no", "1", "yes", "/some/dir"):
        if value is None:
            monkeypatch.delenv("HYBRIDGL_TEST_FLAG", raising=False)
        else:
            monkeypatch.setenv("HYBRIDGL_TEST_FLAG", value)
        for default in (False, True):
            assert port_env.env_flag("HYBRIDGL_TEST_FLAG", default=default) == \
                ref_env.env_flag("HYBRIDGL_TEST_FLAG", default=default)
        assert port_env.env_is_falsy("HYBRIDGL_TEST_FLAG") == ref_env.env_is_falsy("HYBRIDGL_TEST_FLAG")


def test_tokenizer_agrees():
    from hybridgl_tpu.models.clip import tokenizer as ref_tok
    from hybridgl_tpu_torch.models.clip import tokenizer as port_tok

    a, b = port_tok.default_tokenizer(), ref_tok.default_tokenizer()
    assert (a.sot_token, a.eot_token) == (b.sot_token, b.eot_token)
    for text in TEXTS:
        assert a.encode(text) == b.encode(text), text
    np.testing.assert_array_equal(port_tok.tokenize(TEXTS), ref_tok.tokenize(TEXTS))
    with open(port_tok.find_vocab(), "rb") as f, open(ref_tok.find_vocab(), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("rela_right_bug", [True, False])
def test_heuristic_parser_agrees(rela_right_bug):
    from hybridgl_tpu.lang import HeuristicParser as RefParser
    from hybridgl_tpu_torch.lang import HeuristicParser as PortParser

    a, b = PortParser(rela_right_bug=rela_right_bug), RefParser(rela_right_bug=rela_right_bug)
    for text in TEXTS:
        assert dataclasses.asdict(a.parse(text)) == dataclasses.asdict(b.parse(text)), text


def seeded_masks(seed, n, h, w):
    """Blobs with holes and speckle: coarse noise upsampled, plus fine noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 8 + 1, w // 8 + 1)) > 0.55
    masks = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, :h, :w]
    return masks ^ (rng.random((n, h, w)) > 0.97)


@pytest.mark.parametrize("native", [True, False])
def test_rle_codec_agrees(native, monkeypatch):
    from hybridgl_tpu.data import rle as ref_rle
    from hybridgl_tpu_torch.data import rle as port_rle

    if native:
        assert port_rle._native() is not None, "the port's native RLE codec did not build"
    else:  # the numpy path of both
        for mod in (ref_rle, port_rle):
            monkeypatch.setattr(mod, "_native_mod", None)
            monkeypatch.setattr(mod, "_native_checked", True)
    masks = list(seeded_masks(0, 4, 37, 53)) + [np.zeros((5, 7), bool), np.ones((6, 4), bool)]
    encoded = []
    for m in masks:
        a, b = port_rle.encode(m), ref_rle.encode(m)
        assert a == b
        np.testing.assert_array_equal(port_rle.decode(a), m)
        np.testing.assert_array_equal(port_rle.decode(a), ref_rle.decode(b))
        s = port_rle.compress_counts(a["counts"])
        assert s == ref_rle.compress_counts(b["counts"])
        assert port_rle.decompress_counts(s) == ref_rle.decompress_counts(s) == list(a["counts"])
        assert port_rle.area(a) == ref_rle.area(b) == int(m.sum())
        np.testing.assert_array_equal(port_rle.to_bbox(a), ref_rle.to_bbox(b))
        encoded.append(a)
    assert port_rle.iou(encoded[0], encoded[1]) == ref_rle.iou(encoded[0], encoded[1])
    assert port_rle.merge(encoded[:3]) == ref_rle.merge(encoded[:3])
    poly = [[3.0, 2.0, 30.0, 4.0, 25.0, 28.0, 5.0, 20.0]]
    np.testing.assert_array_equal(port_rle.polygon_to_mask(poly, 37, 53), ref_rle.polygon_to_mask(poly, 37, 53))


def forced_cleanup(mod, monkeypatch, *args):
    """The reference's ``cleanup_batch`` through its native library, whatever
    cv2 says (the port's always runs its own)."""
    monkeypatch.setenv("HYBRIDGL_FORCE_NATIVE_CLEANUP", "1")
    monkeypatch.delenv("HYBRIDGL_NO_NATIVE_CLEANUP", raising=False)
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_tried", False)
    out = mod.cleanup_batch(*args)
    assert out is not None, f"{mod.__name__}: the native library did not build"
    return out


@pytest.mark.parametrize("min_area,hw", [(12, (40, 48)), (40, (33, 41)), (200, (40, 48))])
def test_region_cleanup_agrees(min_area, hw, monkeypatch):
    from hybridgl_tpu.pipeline import postprocess_native as ref_native
    from hybridgl_tpu_torch.pipeline import postprocess_native as port_native

    masks = seeded_masks(3, 6, 40, 48)
    masks[:, hw[0]:, :] = False
    masks[:, :, hw[1]:] = False
    boxes = np.tile(np.float32([0, 0, hw[1], hw[0]]), (6, 1))
    valid = np.array([True, True, True, False, True, True])
    ma, mb = masks.copy(), masks.copy()
    got = port_native.cleanup_batch(ma, boxes, valid, hw, min_area)
    want = forced_cleanup(ref_native, monkeypatch, mb, boxes, valid, hw, min_area)
    np.testing.assert_array_equal(ma, mb)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].any() and not (ma == masks).all()
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a[got[0]], b[want[0]])


def test_native_libraries_build_inside_the_port():
    """The port's C++ helpers build into its own ``_build`` directory."""
    from hybridgl_tpu_torch.utils import native_build

    for source in ("rle.cpp", "region_cleanup.cpp"):
        path = native_build.build(source)
        assert path.exists() and path.parent == native_build.BUILD_DIR
        assert "hybridgl_tpu_torch" in path.parts and "hybridgl_tpu" not in path.parts
