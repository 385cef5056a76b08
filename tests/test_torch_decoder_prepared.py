"""The port's prepare_decoder_params == its raw decode path, and == the JAX
package's prepared path (the cases of tests/test_decoder_prepared.py).

Every prepared product is an exact matmul reassociation or a value computed
once instead of per chunk, so ``predict_masks`` over the prepared tree must
match the raw tree to float tolerance (f32: IoU atol 2e-5, logits atol 3e-4;
bf16: 0.05 of the logit scale), on CPU, where the kernels run their plain
versions. The port has one decoder route; each combination of the
reference's four decoder switches, set for the JAX package alone, also holds
both of the port's trees to the reference's ``predict_masks`` on that route
(logits within 1e-3, IoU within 1e-4). Weights and inputs from numpy seeds,
through ``from_numpy_tree``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.params import init_sam as jax_init_sam
from hybridgl_tpu.models.sam.decoder import predict_masks as jax_predict_masks
from hybridgl_tpu.models.sam.decoder import prepare_decoder_params as jax_prepare
from hybridgl_tpu_torch.core.params import cast_tree, from_numpy_tree
from hybridgl_tpu_torch.models.sam.decoder import predict_masks, prepare_decoder_params
from hybridgl_tpu_torch.models.sam.image_encoder import prepare_sam_params

from torch_port_config import to_port
from torch_ref_sam import tiny_sam_config

SWITCHES = ("PASS", "I2T", "T2I", "UPSCALE")


def setup(seed=0):
    cfg = tiny_sam_config()
    rng = np.random.default_rng(seed)
    p_np = jax.tree_util.tree_map(np.asarray, jax_init_sam(jax.random.PRNGKey(3), cfg)["decoder"])
    B, g, C = 5, cfg.embed_grid, cfg.prompt_dim
    emb = (rng.standard_normal((g, g, C)) * 0.5).astype(np.float32)
    pe = (rng.standard_normal((g, g, C)) * 0.5).astype(np.float32)
    sparse = (rng.standard_normal((B, 3, C)) * 0.5).astype(np.float32)
    dense = (rng.standard_normal((g, g, C)) * 0.1).astype(np.float32)
    return cfg, p_np, emb, pe, sparse, dense


def set_switches(monkeypatch, values):
    """The reference's four decoder switches (the port reads none of them)."""
    for name, v in zip(SWITCHES, values):
        monkeypatch.setenv(f"HYBRIDGL_FUSED_{name}", v)


def run(p, cfg, emb, pe, sparse, dense, **kw):
    with torch.no_grad():
        m, iou = predict_masks(p, *(torch.from_numpy(x) for x in (emb, pe, sparse)), to_port(cfg),
                               dense_prompts=torch.from_numpy(dense), **kw)
    return m.numpy(), iou.numpy()


def run_jax(p_np, cfg, emb, pe, sparse, dense, **kw):
    """The reference's predict_masks on its raw tree, on the route its switches select."""
    m, iou = jax_predict_masks(jax.tree_util.tree_map(jnp.asarray, p_np), jnp.asarray(emb), jnp.asarray(pe),
                               jnp.asarray(sparse), cfg, dense_prompts=jnp.asarray(dense), **kw)
    return np.asarray(m), np.asarray(iou)


def assert_near_jax(got, want):
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)


@pytest.mark.parametrize("switches", ["1111", "0111", "0000", "1000", "0100", "0010"])
def test_prepared_matches_raw(monkeypatch, switches):
    """The prepared tree against the raw one, and both against the reference
    on each of its routes: the fused layer passes (K3), the per-site kernels
    (K7, K8), the plain attention forms, with and without the fused tail (K4)."""
    set_switches(monkeypatch, switches)
    cfg, p_np, *inputs = setup()
    raw = from_numpy_tree(p_np)
    prep = prepare_decoder_params(raw, to_port(cfg))
    for multimask in (True, False):
        ref_m, ref_iou = run(raw, cfg, *inputs, multimask_output=multimask)
        out_m, out_iou = run(prep, cfg, *inputs, multimask_output=multimask)
        np.testing.assert_allclose(out_iou, ref_iou, atol=2e-5)
        np.testing.assert_allclose(out_m, ref_m, atol=3e-4)
        assert np.abs(ref_m).max() > 0.1
        want = run_jax(p_np, cfg, *inputs, multimask_output=multimask)
        assert_near_jax((ref_m, ref_iou), want)
        assert_near_jax((out_m, out_iou), want)


@pytest.mark.parametrize("switches", ["1111", "0000"])
def test_prepared_matches_raw_batched_dense(monkeypatch, switches):
    """Batched dense prompts take the per-prompt two-way path (layer 0 runs the
    generic sites): prepared against raw, and both against the reference."""
    set_switches(monkeypatch, switches)
    cfg, p_np, emb, pe, sparse, dense = setup(1)
    dense_b = np.broadcast_to(dense[None], (sparse.shape[0],) + dense.shape).copy()
    raw = from_numpy_tree(p_np)
    ref_m, ref_iou = run(raw, cfg, emb, pe, sparse, dense_b)
    out_m, out_iou = run(prepare_decoder_params(raw, to_port(cfg)), cfg, emb, pe, sparse, dense_b)
    np.testing.assert_allclose(out_iou, ref_iou, atol=2e-5)
    np.testing.assert_allclose(out_m, ref_m, atol=3e-4)
    want = run_jax(p_np, cfg, emb, pe, sparse, dense_b)
    assert_near_jax((ref_m, ref_iou), want)
    assert_near_jax((out_m, out_iou), want)


def test_prepared_matches_raw_bf16():
    """The serving configuration: bf16 params. The folded products are
    rounded to bf16 once more, so the bar is bf16-scale."""
    cfg, p_np, *inputs = setup(2)
    raw = cast_tree(from_numpy_tree(p_np), torch.bfloat16)
    prep = prepare_decoder_params(raw, to_port(cfg))
    assert prep["transformer"]["layers"][0]["prepared_i2t"]["so_w"].dtype == torch.bfloat16
    assert prep["transformer"]["layers"][0]["prepared_i2t"]["ln_scale"].dtype == torch.float32
    assert prep["upscale"]["prepared"]["w1"].dtype == torch.bfloat16 and prep["upscale"]["prepared"]["b1"].dtype == torch.float32
    ref_m, ref_iou = run(raw, cfg, *inputs)
    out_m, out_iou = run(prep, cfg, *inputs)
    scale = float(np.abs(ref_m).max())
    np.testing.assert_allclose(out_m / scale, ref_m / scale, atol=0.05)
    np.testing.assert_allclose(out_iou, ref_iou, atol=0.05)


@pytest.mark.parametrize("switches", ["1111", "0111"])
def test_prepared_matches_jax_prepared(monkeypatch, switches):
    """The same weights prepared by both packages, through both predict_masks
    (the reference's kernels in interpret mode, on the route its switches
    select): logits and IoU predictions within 1e-3 / 1e-4, and the shared
    products equal to 1e-5."""
    set_switches(monkeypatch, switches)
    cfg, p_np, emb, pe, sparse, dense = setup(3)
    want_tree = jax_prepare(jax.tree_util.tree_map(jnp.asarray, p_np), cfg)
    got_tree = prepare_decoder_params(from_numpy_tree(p_np), to_port(cfg))
    for site in ("prepared_t2i", "prepared_i2t"):
        a, b = got_tree["transformer"]["layers"][1][site], want_tree["transformer"]["layers"][1][site]
        for key in b:
            np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]), atol=1e-5, err_msg=f"{site}/{key}")
    np.testing.assert_array_equal(got_tree["output_tokens_prepared"].numpy(), np.asarray(want_tree["output_tokens_prepared"]))
    np.testing.assert_array_equal(got_tree["hyper_prepared"][2]["w"].numpy(), np.asarray(want_tree["hyper_prepared"][2]["w"]))
    want_m, want_iou = jax_predict_masks(want_tree, jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(sparse), cfg,
                                         dense_prompts=jnp.asarray(dense))
    got_m, got_iou = run(got_tree, cfg, emb, pe, sparse, dense)
    np.testing.assert_allclose(got_iou, np.asarray(want_iou), atol=1e-4)
    np.testing.assert_allclose(got_m, np.asarray(want_m), atol=1e-3)


def test_prepared_once_at_construction():
    """``prepare_sam_params`` adds the rel-pos tables and the decoder's
    products, keeps the raw weights, and is idempotent; the pipeline and the
    predictor call it when they are built."""
    from hybridgl_tpu_torch import SamPredictor
    from hybridgl_tpu_torch.core.config import tiny_smoke_config
    from hybridgl_tpu_torch.core.params import init_clip, init_sam
    from hybridgl_tpu_torch.lang import HeuristicParser
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline

    cfg = tiny_smoke_config()
    g = torch.Generator().manual_seed(0)
    sam_p, clip_p = init_sam(g, cfg.sam), init_clip(g, cfg.clip)
    assert "prepared_final_t2i" not in sam_p["decoder"]["transformer"]
    pipe = HybridGLPipeline(cfg, sam_p, clip_p, parser=HeuristicParser(), device="cpu")
    for params in (pipe.sam_params, SamPredictor(sam_p, cfg.sam).params):
        tf = params["decoder"]["transformer"]
        assert "prepared_final_t2i" in tf and "prepared" in params["decoder"]["upscale"]
        assert all("prepared_t2i" in layer and "prepared_i2t" in layer and "cross_t2i" in layer for layer in tf["layers"])
        attn = params["encoder"]["blocks"][0]["attn"]
        size = cfg.sam.window_size
        assert attn["rel_tab_h"].shape == (size, size, cfg.sam.encoder_width // cfg.sam.encoder_heads)
    assert "prepared_final_t2i" not in sam_p["decoder"]["transformer"]  # the caller's tree is not touched
    again = prepare_sam_params(pipe.sam_params, cfg.sam)
    assert again["decoder"] is pipe.sam_params["decoder"]
    assert again["encoder"]["blocks"][1]["attn"]["rel_tab_w"] is pipe.sam_params["encoder"]["blocks"][1]["attn"]["rel_tab_w"]
