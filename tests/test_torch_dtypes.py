"""Score-dtype policy of the port (hybridgl_tpu_torch/core/dtypes.py) against the JAX package's.

Under bf16 activations the reference stores attention scores in bf16 with an
f32 softmax denominator; the port must round at the same places. The bf16
cases below feed the same numpy-seeded weights and inputs through both
packages on the CPU.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core import dtypes as jax_dtypes
from hybridgl_tpu.core.config import GemConfig, clip_preset
from hybridgl_tpu.core.params import init_clip as jax_init_clip
from hybridgl_tpu.models.clip.text import encode_text as jax_encode_text
from hybridgl_tpu.models.gem.gem import gem_image_features as jax_gem_image_features
from hybridgl_tpu_torch.core import dtypes
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.models.clip.text import encode_text
from hybridgl_tpu_torch.models.gem.gem import gem_image_features

from torch_port_config import to_port


def _to_torch(x_jax):
    """A JAX array (bf16 or f32) as a torch tensor of the same dtype, bit for bit."""
    a = np.asarray(x_jax)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_score_dtype_follows_the_flag(monkeypatch, dtype, forced):
    if forced:
        monkeypatch.setenv("HYBRIDGL_F32_SCORES", "1")
    else:
        monkeypatch.delenv("HYBRIDGL_F32_SCORES", raising=False)
    want = jax_dtypes.score_dtype(jnp.dtype(dtype))
    got = dtypes.score_dtype(getattr(torch, dtype))
    assert dtypes.force_f32_scores() == jax_dtypes.force_f32_scores() == forced
    assert str(got).split(".")[-1] == jnp.dtype(want).name
    assert got == (torch.float32 if forced or dtype == "float32" else torch.bfloat16)


@pytest.mark.parametrize("axes", [(-1,), (-2, -1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_softmax_scores_matches_jax(dtype, axes):
    """Same scores, same dtype, through both: the output keeps the score dtype and
    agrees within one rounding of it (2^-8 relative for bf16, 1e-6 for f32); a
    -inf entry (a masked key under bf16) gives exactly 0."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 6, 10)) * 4).astype(np.float32)
    x[0, 0, 0, 3] = -np.inf
    xj = jnp.asarray(x).astype(dtype)
    want = jax_dtypes.softmax_scores(xj, axes=axes)
    got = dtypes.softmax_scores(_to_torch(xj), axes=axes)
    assert str(got.dtype).split(".")[-1] == dtype
    assert got[0, 0, 0, 3] == 0
    tol = 2.0**-8 if dtype == "bfloat16" else 1e-6
    assert np.abs(_f32(got) - _f32(want)).max() <= tol * np.abs(_f32(want)).max()
    np.testing.assert_allclose(_f32(got).sum(axis=axes), 1.0, atol=2e-2 if dtype == "bfloat16" else 1e-5)


SHARPEN = 3.0


@pytest.fixture(scope="module")
def bf16_params():
    cfg = clip_preset("test-tiny")
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_clip(jax.random.PRNGKey(0), cfg))

    def noise(x):
        x = np.array(x)
        if x.ndim == 1 and np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
        return x

    tree = jax.tree_util.tree_map(noise, tree)
    # sharpen the attention: scores a few units wide, as trained weights give, where one
    # bf16 rounding of a score moves a probability by percents. At the random init's
    # near-uniform attention the score dtype would hardly show in the features
    for blocks in (tree["visual"]["blocks"], tree["text"]["blocks"]):
        for blk in blocks:
            blk["attn"]["in_proj_w"] = blk["attn"]["in_proj_w"] * SHARPEN

    def cast(path, x):
        return x if path[-1].key == "logit_scale" else jnp.asarray(x).astype(jnp.bfloat16)

    jp = jax.tree_util.tree_map_with_path(cast, tree)
    return cfg, jp, from_numpy_tree(tree, dtype=torch.bfloat16)


def _tokens(cfg, n_sentences=32):
    """Long sentences (half the context or more), so that most causal rows see many keys."""
    rng = np.random.default_rng(5)
    L = cfg.context_length
    tokens = np.zeros((n_sentences, L), np.int32)
    for i in range(n_sentences):
        n = int(rng.integers(L // 2, L - 1))
        tokens[i, 0] = cfg.vocab_size - 2
        tokens[i, 1 : 1 + n] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[i, min(1 + n, L - 1)] = cfg.vocab_size - 1  # EOT: the highest id
    return tokens


def _report(name, got, want, record_property):
    """(mean|d| / mean|want|, max|d|, cosine), printed and recorded with the test."""
    rel = float(np.abs(got - want).mean() / np.abs(want).mean())
    d, cos = float(np.abs(got - want).max()), _cos(got, want)
    for key, val in (("mean_rel_diff", rel), ("max_abs_diff", d), ("cosine", cos)):
        record_property(f"{name}_{key}", val)
    print(f"{name} bf16: mean|d|/mean|want| {rel:.5f}, max|d| {d:.5f}, cos {cos:.6f}")
    return rel, d, cos


# Tolerances. bf16 keeps 8 bits, so one rounding is 2^-8 = 0.0039 relative. With the casts
# placed as the reference places them the repaired attention functions agree bit for bit
# (test_attention_functions_round_where_jax_rounds); over the whole tiny model the packages
# still differ where XLA's and PyTorch's CPU matmuls, layer norms and reductions round a
# bf16 result differently: measured mean|d|/mean|want| 0.0070 (text), 0.0041 (GEM patches).
# With f32 scores and an f32 softmax instead (the fault these tests hold) the same inputs
# give 0.0132 and 0.0099. The bounds sit between. The CLS feature passes through the sharp
# last-block softmax once more and is held by cosine only.
BF16_TEXT_MEAN_REL = 0.010
BF16_GEM_MEAN_REL = 0.006


def test_encode_text_bf16_matches_jax(bf16_params, record_property):
    cfg, jp, tp = bf16_params
    tokens = _tokens(cfg)
    want = np.asarray(jax_encode_text(jp["text"], jnp.asarray(tokens), cfg))
    got = encode_text(tp["text"], torch.from_numpy(tokens), to_port(cfg)).numpy()
    rel, _, cos = _report("encode_text", got, want, record_property)
    assert rel <= BF16_TEXT_MEAN_REL
    assert cos >= 0.9995


def test_gem_image_features_bf16_matches_jax(bf16_params, record_property):
    cfg, jp, tp = bf16_params
    gem = GemConfig(img_size=64, depth=2)
    img = np.random.default_rng(3).standard_normal((4, 64, 64, 3)).astype(np.float32)
    want_pf, want_cls, want_g = jax_gem_image_features(jp["visual"], jnp.asarray(img), cfg, gem)
    got_pf, got_cls, got_g = gem_image_features(tp["visual"], torch.from_numpy(img), to_port(cfg), to_port(gem))
    assert got_g == want_g
    rel, _, cos = _report("gem_patch", got_pf.numpy(), np.asarray(want_pf), record_property)
    assert rel <= BF16_GEM_MEAN_REL
    assert cos >= 0.9999
    _, _, cos = _report("gem_cls", got_cls.numpy(), np.asarray(want_cls), record_property)
    assert cos >= 0.999


def test_f32_scores_flag_under_bf16_matches_jax(bf16_params, monkeypatch, record_property):
    """HYBRIDGL_F32_SCORES=1 under bf16 stores f32 scores in both packages; they still agree."""
    cfg, jp, tp = bf16_params
    tokens = _tokens(cfg)
    monkeypatch.setenv("HYBRIDGL_F32_SCORES", "1")
    want = np.asarray(jax_encode_text(jp["text"], jnp.asarray(tokens), cfg))
    got = encode_text(tp["text"], torch.from_numpy(tokens), to_port(cfg)).numpy()
    rel, _, _ = _report("encode_text_f32_scores", got, want, record_property)
    assert rel <= BF16_TEXT_MEAN_REL


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32)).astype(jnp.bfloat16)


@pytest.mark.parametrize("fn", ["self_self_attention", "std_attention", "multi_head_attention"])
def test_attention_functions_round_where_jax_rounds(fn, monkeypatch):
    """The three repaired functions on the same bf16 inputs: every cast sits where the
    reference has it, so the outputs are equal bit for bit up to the rare element where
    the l2 norm's bf16 sum rounds the other way (>= 90% equal, the rest within one bf16
    step of the largest output). With f32 scores about half the elements differ."""
    from hybridgl_tpu.models.clip import layers as jax_layers
    from hybridgl_tpu.models.clip.text import causal_bias
    from hybridgl_tpu.models.gem import gem as jax_gem
    from hybridgl_tpu_torch.models.clip import layers
    from hybridgl_tpu_torch.kernels import gem_attention as gem  # GEM's plain versions

    rng = np.random.default_rng(0)
    q, k, v = (_bf16(rng, (2, 2, 17, 16)) for _ in range(3))
    tq, tk, tv = (_to_torch(t) for t in (q, k, v))
    if fn == "self_self_attention":
        want, got = jax_gem.self_self_attention(q, k, v, 0.25, 1), gem.self_self_attention(tq, tk, tv, 0.25, 1)
    elif fn == "std_attention":
        want, got = jax_gem._std_attention(q * 0.25, k, v, 1.0), gem._std_attention(tq * 0.25, tk, tv, 1.0)
    else:
        monkeypatch.setenv("HYBRIDGL_FUSED_CLIP", "0")  # the reference's plain branch, as under a causal bias
        D = 32
        p = {"in_proj_w": _bf16(rng, (D, 3 * D), 0.2), "in_proj_b": _bf16(rng, (3 * D,), 0.1),
             "out_w": _bf16(rng, (D, D), 0.2), "out_b": _bf16(rng, (D,), 0.1)}
        x, bias = _bf16(rng, (3, 12, D)), causal_bias(12)
        want = jax_layers.multi_head_attention(p, x, 2, attn_bias=bias)
        got = layers.multi_head_attention({n: _to_torch(t) for n, t in p.items()}, _to_torch(x), 2,
                                          attn_bias=_to_torch(bias))
    assert got.dtype == torch.bfloat16
    got, want = _f32(got), _f32(want)
    assert (got == want).mean() >= 0.9
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()
