"""The port's tensor-parallel SAM encoder (hybridgl_tpu_torch/parallel/encoder_tp.py)
over gloo on the CPU, f32: mp = 2 and 4 against the port's ``encode_image`` in
one process and against the JAX package's ``encode_image`` on the same weights
and image (atol and rtol 2e-4, the bar of tests/test_encoder_tp.py: the sums
run in another order), and ``_shard_block_params`` against the reference's
slices (equal).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.params import init_sam as jax_init_sam
from hybridgl_tpu.models.sam.image_encoder import encode_image as jax_encode_image
from hybridgl_tpu.parallel.encoder_tp import _shard_block_params as jax_shard_block_params
from hybridgl_tpu_torch.core import checkpoint
from hybridgl_tpu_torch.core.config import PipelineConfig
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.models.sam.image_encoder import encode_image, prepare_sam_params
from hybridgl_tpu_torch.parallel import launch, workers
from hybridgl_tpu_torch.parallel.encoder_tp import _shard_block_params, shard_encoder_params

from torch_port_config import to_port
from torch_ref_sam import tiny_sam_config

LIMIT = 180.0  # seconds a spawned run may take (a few seconds alone; the suite runs six workers at once)


def setup(mp):
    cfg = tiny_sam_config()
    if cfg.encoder_heads % mp:
        cfg = dataclasses.replace(cfg, encoder_heads=mp)
    enc = jax.tree_util.tree_map(np.asarray, jax_init_sam(jax.random.PRNGKey(0), cfg)["encoder"])
    rng = np.random.default_rng(mp)
    for blk in enc["blocks"]:  # nonzero rel-pos and biases, so what a shard drops or doubles shows
        for key in ("rel_pos_h", "rel_pos_w", "qkv_b", "proj_b"):
            blk["attn"][key] = (rng.standard_normal(blk["attn"][key].shape) * 0.2).astype(np.float32)
        for key in ("mlp_fc", "mlp_proj"):
            blk[key]["b"] = (rng.standard_normal(blk[key]["b"].shape) * 0.2).astype(np.float32)
    image = rng.standard_normal((1, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    return cfg, enc, image


@pytest.mark.parametrize("mp", [2, 4])
def test_encoder_tp_matches_single_process_and_reference(mp, tmp_path):
    cfg, enc, image = setup(mp)
    path = str(tmp_path / "sam.npz")
    checkpoint.save(path, {"encoder": enc})
    spec = dict(cfg=PipelineConfig(sam_config=to_port(cfg)), sam=path, mp=mp, image=image)
    out = launch.spawn_workers(workers.encoder_tp_worker, mp, (spec,), "cpu", timeout=LIMIT)
    got = out[0]["output"]
    for o in out[1:]:  # replicated over the axis
        np.testing.assert_array_equal(o["output"], got)
    with torch.no_grad():
        port = encode_image(from_numpy_tree(enc), torch.from_numpy(image), to_port(cfg)).numpy()
    want = np.asarray(jax_encode_image(jax.tree_util.tree_map(jnp.asarray, enc), jnp.asarray(image), cfg))
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, port, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_block_params_equal_reference(mp):
    """Heads taken from each of the q, k, v sections, proj_w and mlp_proj.w
    row-sharded, both biases on shard 0 only: every leaf equal to the
    reference's slice, and the shards tile the block."""
    cfg, enc, _ = setup(mp)
    bp_np = enc["blocks"][0]
    bp_t = from_numpy_tree(bp_np)
    for idx in range(mp):
        want = jax_shard_block_params(jax.tree_util.tree_map(jnp.asarray, bp_np), cfg, idx, mp)
        got = _shard_block_params(bp_t, to_port(cfg), idx, mp)
        assert sorted(got) == sorted(want) and sorted(got["attn"]) == sorted(want["attn"])
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    shards = [_shard_block_params(bp_t, to_port(cfg), i, mp) for i in range(mp)]
    assert torch.equal(sum(s["attn"]["proj_b"] for s in shards), bp_t["attn"]["proj_b"])
    assert torch.equal(torch.cat([s["mlp_proj"]["w"] for s in shards]), bp_t["mlp_proj"]["w"])
    # the prepared rel-pos tables ride along unsharded
    prepared = prepare_sam_params({"encoder": from_numpy_tree(enc)}, to_port(cfg))["encoder"]
    local = shard_encoder_params(prepared, to_port(cfg), 1, mp)
    assert local["tp_shard"] == (1, mp) and local["blocks"][0]["attn"]["rel_tab_h"] is prepared["blocks"][0]["attn"]["rel_tab_h"]
