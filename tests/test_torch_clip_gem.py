"""The port's CLIP (the six fusion modes, text encoder) and GEM against the
JAX package on CPU, f32, same weights.

The tiny CLIP has L = 17 tokens, so the reference's fusion blocks route to
its clip_attention Pallas kernel (interpret mode) and the port's to K6's
plain version. Zero-initialised biases get numpy noise first.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import GemConfig, clip_preset
from hybridgl_tpu.core.params import init_clip as jax_init_clip
from hybridgl_tpu.models.clip.fusion import hybrid_forward as jax_hybrid_forward
from hybridgl_tpu.models.clip.text import encode_text as jax_encode_text
from hybridgl_tpu.models.gem.gem import gem_image_features as jax_gem_image_features
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.models.clip.fusion import calculate_score, hybrid_forward
from hybridgl_tpu_torch.models.clip.text import encode_text
from hybridgl_tpu_torch.models.gem.gem import gem_image_features

from torch_port_config import to_port

TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    cfg = clip_preset("test-tiny")
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_clip(jax.random.PRNGKey(0), cfg))

    def noise(x):
        x = np.array(x)
        if x.ndim == 1 and np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
        return x

    tree = jax.tree_util.tree_map(noise, tree)
    return cfg, tree, jax.tree_util.tree_map(jnp.asarray, tree), from_numpy_tree(tree)


def run_both(params, fusion_mode, masking_block, compat=None):
    """(port, JAX) hybrid features for one mode on the same seeded inputs."""
    from hybridgl_tpu.core.config import CompatConfig

    cfg, _, jp, tp = params
    compat = compat or CompatConfig()
    rng = np.random.default_rng(1)
    P, S = 5, cfg.image_size
    local = rng.standard_normal((P, S, S, 3)).astype(np.float32)
    glob = rng.standard_normal((P, S, S, 3)).astype(np.float32)
    masks = rng.random((P, 48, 48)) > 0.6
    masks[3] = False  # an empty proposal: its CLS row attends only to itself
    hw = (40, 44)
    want = jax_hybrid_forward(
        jp["visual"], jnp.asarray(local), jnp.asarray(glob), jnp.asarray(masks, jnp.float32), cfg,
        fusion_mode=fusion_mode, masking_block=masking_block, compat=compat, masks_hw=hw,
    )
    got = hybrid_forward(
        tp["visual"], torch.from_numpy(local), torch.from_numpy(glob), torch.from_numpy(masks).float(),
        to_port(cfg), fusion_mode=fusion_mode, masking_block=masking_block, compat=to_port(compat), masks_hw=hw,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("masking_block", [0, 1])
def test_hybrid_forward_g2l_matches_jax(params, masking_block):
    got, want = run_both(params, "G2L", masking_block)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize(
    "fusion_mode,early_exit",
    [
        ("crop", True),
        ("token_masking", True),
        ("attn_masking", True),
        ("attn_masking", False),
        ("L2G", True),
        ("G2L", True),
        ("G2L&L2G", True),
    ],
)
def test_hybrid_forward_modes_match_jax(params, fusion_mode, early_exit):
    """Every fusion mode (attn_masking also without the reference's early
    exit) against the JAX package's, same weights and inputs."""
    from hybridgl_tpu.core.config import CompatConfig

    got, want = run_both(params, fusion_mode, 1, CompatConfig(attn_masking_early_exit=early_exit))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL


def test_hybrid_forward_unknown_mode_raises(params):
    cfg, _, _, tp = params
    x = torch.zeros((1, cfg.image_size, cfg.image_size, 3))
    with pytest.raises(ValueError, match="fusion mode"):
        hybrid_forward(tp["visual"], x, x, torch.zeros((1, 8, 8)), to_port(cfg), fusion_mode="L2G2L")


def test_encode_text_and_score_match_jax(params):
    cfg, _, jp, tp = params
    rng = np.random.default_rng(2)
    N, L = 4, cfg.context_length
    tokens = np.zeros((N, L), np.int32)
    for i, n in enumerate((3, 7, 1, L - 2)):
        tokens[i, 0] = cfg.vocab_size - 2
        tokens[i, 1 : 1 + n] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[i, 1 + n] = cfg.vocab_size - 1  # EOT: the highest id
    want = np.asarray(jax_encode_text(jp["text"], jnp.asarray(tokens), cfg))
    got = encode_text(tp["text"], torch.from_numpy(tokens), to_port(cfg)).numpy()
    assert np.abs(got - want).max() <= TOL
    feats = rng.standard_normal((6, cfg.embed_dim)).astype(np.float32)
    from hybridgl_tpu.models.clip.fusion import calculate_score as jax_calculate_score

    want_s = np.asarray(jax_calculate_score(jnp.asarray(feats), jnp.asarray(want), jp["logit_scale"]))
    got_s = calculate_score(torch.from_numpy(feats), torch.from_numpy(got), tp["logit_scale"]).numpy()
    assert np.abs(got_s - want_s).max() <= 1e-3  # logits scaled by exp(logit_scale) ~ 14


def test_gem_image_features_match_jax(params):
    cfg, _, jp, tp = params
    gem = GemConfig(img_size=64, depth=2)
    img = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want_pf, want_cls, want_g = jax_gem_image_features(jp["visual"], jnp.asarray(img), cfg, gem)
    got_pf, got_cls, got_g = gem_image_features(tp["visual"], torch.from_numpy(img), to_port(cfg), to_port(gem))
    assert got_g == want_g
    assert np.abs(got_pf.numpy() - np.asarray(want_pf)).max() <= TOL
    assert np.abs(got_cls.numpy() - np.asarray(want_cls)).max() <= TOL
