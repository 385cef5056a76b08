"""The port's SAM (encoder, decoder, single-crop AMG) against the JAX package
on CPU, f32, same weights.

Params come from ``hybridgl_tpu.core.params.init_sam``; zero-initialised
leaves (rel-pos tables, pos_embed, biases) get numpy noise first, so the
rel-pos bias path is exercised. The JAX side runs its Pallas kernels in
interpret mode (its CPU default); the port runs the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import AmgConfig, SamConfig, sam_preset
from hybridgl_tpu.core.params import init_sam as jax_init_sam
from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu.models.sam.decoder import predict_masks as jax_predict_masks
from hybridgl_tpu.models.sam.image_encoder import encode_image as jax_encode_image
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.models.sam import amg
from hybridgl_tpu_torch.models.sam.decoder import predict_masks
from hybridgl_tpu_torch.models.sam.image_encoder import encode_image

from torch_port_config import to_port

# a geometry whose encoder reaches both kernels: grid 32 with window 8 routes
# the windowed block to K1 and the global block to K2 (test-tiny's window 3
# on grid 4 reaches neither, image_encoder.py:136, 174)
ROUTING = SamConfig(
    img_size=512, encoder_width=64, encoder_depth=2, encoder_heads=2,
    encoder_global_idx=(1,), window_size=8, prompt_dim=32,
)


def noisy_params(cfg, seed):
    """init_sam as numpy, with noise in the zero-initialised leaves."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_sam(jax.random.PRNGKey(seed), cfg))

    def noise(path, x):
        name = str(path[-1])
        if "rel_pos" in name or "pos_embed" in name or (np.all(x == 0) and x.ndim == 1):
            return (rng.standard_normal(x.shape) * 0.2).astype(np.float32)
        return np.array(x)

    return jax.tree_util.tree_map_with_path(noise, tree)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("name", ["test-tiny", "routing"])
def test_encoder_matches_jax(name):
    cfg = sam_preset("test-tiny") if name == "test-tiny" else ROUTING
    params = noisy_params(cfg, 0)
    img = np.random.default_rng(1).standard_normal((1, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    want = np.asarray(jax_encode_image(jax_tree(params["encoder"]), jnp.asarray(img), cfg))
    got = encode_image(from_numpy_tree(params["encoder"]), torch.from_numpy(img), to_port(cfg)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4


# the reference's decoder switches, which the port does not read
SWITCHES = tuple(f"HYBRIDGL_FUSED_{k}" for k in ("PASS", "I2T", "T2I", "UPSCALE"))
ROUTES = {
    "all_on": {},
    "pass_off": {"HYBRIDGL_FUSED_PASS": "0"},
    "all_off": {k: "0" for k in SWITCHES},
}


def decoder_inputs(cfg, dense, seed=3, B=4):
    """(embedding, pe, dense prompts, sparse prompts) as numpy, the dense
    prompt shared ([g, g, C]) or per prompt ([B, g, g, C])."""
    rng = np.random.default_rng(seed)
    g, C = cfg.embed_grid, cfg.prompt_dim
    emb, pe = (rng.standard_normal((g, g, C)).astype(np.float32) * 0.5 for _ in range(2))
    shape = (g, g, C) if dense == "shared" else (B, g, g, C)
    dense_p = rng.standard_normal(shape).astype(np.float32) * 0.5
    sparse = rng.standard_normal((B, 3, C)).astype(np.float32) * 0.5
    return emb, pe, dense_p, sparse


def port_predict(p_dec, cfg, emb, pe, dense_p, sparse, multimask=True):
    return predict_masks(
        from_numpy_tree(p_dec), torch.from_numpy(emb), torch.from_numpy(pe), torch.from_numpy(sparse),
        to_port(cfg), dense_prompts=torch.from_numpy(dense_p), multimask_output=multimask,
    )


@pytest.mark.parametrize("dense", ["shared", "per_prompt"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("multimask", [True, False])
def test_predict_masks_matches_jax(monkeypatch, multimask, route, dense):
    """The port's one decoder route (K3 passes + K4; K7/K8 + K4 on the
    per-prompt stream) against the reference on each of its switch routes
    (default: K3 passes + K4; FUSED_PASS=0: K7/K8 + K4; all off), with the
    dense prompt shared ([g, g, C]) or per prompt ([B, g, g, C], the
    multicrop pass-2 form). The switches are set for the JAX package, whose
    kernels run in interpret mode; the port reads none of them. Logits
    within 1e-3, IoU within 1e-4."""
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    cfg = sam_preset("test-tiny")
    p_dec = noisy_params(cfg, 2)["decoder"]
    emb, pe, dense_p, sparse = decoder_inputs(cfg, dense)
    want_m, want_i = jax_predict_masks(
        jax_tree(p_dec), jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(sparse), cfg,
        dense_prompts=jnp.asarray(dense_p), multimask_output=multimask,
    )
    got_m, got_i = port_predict(p_dec, cfg, emb, pe, dense_p, sparse, multimask)
    assert got_m.shape == want_m.shape
    assert np.abs(got_m.numpy() - np.asarray(want_m)).max() <= 1e-3
    assert np.abs(got_i.numpy() - np.asarray(want_i)).max() <= 1e-4


@pytest.mark.parametrize("switch", SWITCHES)
def test_decoder_ignores_the_reference_switches(monkeypatch, switch):
    """One of the reference's decoder switches at 0 changes nothing in the
    port: the outputs are bit-equal to those with none set, and the decoder
    still calls its kernels' operators, K3 twice and K4 once on the shared
    image, K7 twice, K8 three times and K4 once on the per-prompt stream."""
    from hybridgl_tpu_torch.models.sam import decoder

    calls = {}
    for name in ("i2t_ln_then_t2i", "i2t_ln_update", "t2i_ctx", "upscale_hyper"):
        def counted(*a, _name=name, _fn=getattr(decoder, name), **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(decoder, name, counted)
    cfg = sam_preset("test-tiny")
    p_dec = noisy_params(cfg, 2)["decoder"]
    want_calls = {"shared": {"i2t_ln_then_t2i": 2, "upscale_hyper": 1},
                  "per_prompt": {"i2t_ln_update": 2, "t2i_ctx": 3, "upscale_hyper": 1}}
    for dense, want in want_calls.items():
        inputs = decoder_inputs(cfg, dense)
        for k in SWITCHES:
            monkeypatch.delenv(k, raising=False)
        want_m, want_i = port_predict(p_dec, cfg, *inputs)
        monkeypatch.setenv(switch, "0")
        calls.clear()
        got_m, got_i = port_predict(p_dec, cfg, *inputs)
        assert calls == want, dense
        assert torch.equal(got_m, want_m) and torch.equal(got_i, want_i), dense


def test_generate_proposals_matches_jax():
    """Single-crop AMG at test-tiny: same valid/num, same kept order, equal
    boxes and masks."""
    cfg = sam_preset("test-tiny")
    amg_cfg = AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
                        stability_score_thresh=0.0, max_proposals=8)
    params = noisy_params(cfg, 4)
    rng = np.random.default_rng(5)
    h, w, canonical = 24, 32, 32
    rh, rw = 48, 64
    img = np.zeros((cfg.img_size, cfg.img_size, 3), np.uint8)
    img[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    want = jamg.generate_proposals(jax_tree(params), jnp.asarray(img), rh, rw, h, w, cfg, amg_cfg, canonical)
    got = amg.generate_proposals(from_numpy_tree(params), torch.from_numpy(img), rh, rw, h, w, to_port(cfg),
                                 to_port(amg_cfg), canonical)
    assert got.num == int(want.num)
    assert got.num > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.iou_preds.numpy(), np.asarray(want.iou_preds), atol=1e-4)  # kept order
    np.testing.assert_allclose(got.stability.numpy(), np.asarray(want.stability), atol=1e-5)
    np.testing.assert_array_equal(got.boxes_xyxy.numpy(), np.asarray(want.boxes_xyxy))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.areas.numpy(), np.asarray(want.areas))
