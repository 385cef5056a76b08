"""The plain versions of the port's decoder kernels (K3, K4, K7, K8) against
the JAX package's Pallas kernels on CPU, f32, same numpy inputs.

The JAX side runs its kernels in interpret mode (their CPU default); the
port's wrappers run their plain PyTorch versions on CPU tensors. S = 768 so
the JAX grids have three row tiles. Bars: keys' 2e-5 (as
tests/test_decoder_attn.py), ctx 1e-4, masks 1e-4 (the JAX kernel's erf is a
polynomial within 1.4e-5 of erf).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridgl_tpu.kernels.decoder_attn import i2t_ln_update as jax_i2t_ln_update
from hybridgl_tpu.kernels.decoder_attn_t2i import t2i_ctx as jax_t2i_ctx
from hybridgl_tpu.kernels.decoder_pass import i2t_ln_then_t2i as jax_i2t_ln_then_t2i
from hybridgl_tpu.kernels.upscale_hyper import interleave_blocked_masks, upscale_hyper_blocked
from hybridgl_tpu.models.sam.decoder import _prep_upscale
from hybridgl_tpu_torch.kernels.decoder_attn import i2t_ln_update
from hybridgl_tpu_torch.kernels.decoder_attn_t2i import t2i_ctx
from hybridgl_tpu_torch.kernels.decoder_pass import i2t_ln_then_t2i
from hybridgl_tpu_torch.kernels.upscale_hyper import upscale_hyper

S, B, C, HEADS, TP, T = 768, 3, 32, 2, 8, 7


def i2t_operands(rng, Cq, C=C, heads=HEADS, tp=TP, T=T):
    """w [B, Cq, GT], off [B, GT] (-1e30 on the padding lanes), vo, const, ln."""
    GT = heads * tp
    f = lambda *s, std=0.5: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    off = f(B, heads, tp)
    off[:, :, T:] = -1e30
    return dict(w=f(B, Cq, GT, std=0.3), off=off.reshape(B, GT), vo=f(B, GT, C), const=f(C),
                ln_scale=1.0 + f(C, std=0.1), ln_bias=f(C, std=0.1))


def both(d):
    return {k: jnp.asarray(v) for k, v in d.items()}, {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("site", ["generic", "shared"])
def test_i2t_ln_update_matches_jax(site):
    """K7 at the generic site (pe added to the per-prompt keys) and at the
    shared layer-0 site (broadcast [1, S, .] operands, Cq = 16 != C = 32)."""
    rng = np.random.default_rng(0)
    if site == "generic":
        Cq = C
        qside = (rng.standard_normal((B, S, C)) * 0.5).astype(np.float32)
        base, pe = qside, (rng.standard_normal((1, S, C)) * 0.5).astype(np.float32)
    else:
        Cq = 16
        qside = (rng.standard_normal((1, S, Cq)) * 0.5).astype(np.float32)
        base, pe = (rng.standard_normal((1, S, C)) * 0.5).astype(np.float32), None
    ops_j, ops_t = both(i2t_operands(rng, Cq))
    want = jax_i2t_ln_update(jnp.asarray(qside), jnp.asarray(base), **ops_j, heads=HEADS, tp=TP,
                             pe=None if pe is None else jnp.asarray(pe))
    got = i2t_ln_update(torch.from_numpy(qside), torch.from_numpy(base), **ops_t, heads=HEADS, tp=TP,
                        pe=None if pe is None else torch.from_numpy(pe))
    assert got.shape == (B, S, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_t2i_ctx_matches_jax(scale):
    """K8, also with scores x40, where the online softmax has to hold."""
    rng = np.random.default_rng(1)
    keys = (rng.standard_normal((B, S, C)) * 0.5).astype(np.float32)
    pe = (rng.standard_normal((1, S, C)) * 0.5).astype(np.float32)
    qw = (rng.standard_normal((B, C, HEADS * TP)) * 0.3 * scale).astype(np.float32)
    qw[:, :, TP - 1 :: TP] = 0.0  # padding columns: zero score weights
    want = np.asarray(jax_t2i_ctx(jnp.asarray(keys), jnp.asarray(pe), jnp.asarray(qw)))
    got = t2i_ctx(torch.from_numpy(keys), torch.from_numpy(pe), torch.from_numpy(qw)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shared", [True, False])
def test_i2t_ln_then_t2i_matches_jax(shared):
    """K3 in both modes: pass A (shared qside [1, S, 16] and base) and pass B
    (qside == base == the per-prompt keys, pe on the score side)."""
    rng = np.random.default_rng(2)
    Cq = 16 if shared else C
    qside = (rng.standard_normal((1 if shared else B, S, Cq)) * 0.5).astype(np.float32)
    base = (rng.standard_normal((1, S, C)) * 0.5).astype(np.float32) if shared else qside
    pe = (rng.standard_normal((1, S, C)) * 0.5).astype(np.float32)
    ops = i2t_operands(rng, Cq)
    ops["qw_next"] = (rng.standard_normal((B, C, HEADS * TP)) * 0.3).astype(np.float32)
    ops_j, ops_t = both(ops)
    wk, wc = jax_i2t_ln_then_t2i(jnp.asarray(qside), jnp.asarray(base), jnp.asarray(pe), **ops_j, heads=HEADS,
                                 tp=TP, shared_qside=shared)
    gk, gc = i2t_ln_then_t2i(torch.from_numpy(qside), torch.from_numpy(base), torch.from_numpy(pe), **ops_t,
                             heads=HEADS, tp=TP, shared_qside=shared)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("m", [3, 1])
def test_upscale_hyper_matches_jax(m):
    """K4 on operands built from the same raw deconv params: the port takes
    the reshaped deconvs directly, the JAX kernel its centred/kron-expanded
    views (decoder.py:307-329, 996-998), then interleave_blocked_masks."""
    rng = np.random.default_rng(3)
    g, Cin, c4, c8, Bu = 16, 32, 8, 4, 2
    f = lambda *s, std=0.5: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    u = {"deconv1": {"w": f(2, 2, Cin, c4, std=0.2), "b": f(c4)},
         "deconv2": {"w": f(2, 2, c4, c8, std=0.3), "b": f(c8)},
         "ln": {"scale": 1.0 + f(c4, std=0.1), "bias": f(c4, std=0.1)}}
    src = f(Bu, g * g, Cin)
    hyper = f(Bu, m, c8)
    pu = _prep_upscale({k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in u.items()}, Cin)
    hbd = np.stack([np.kron(np.eye(16, dtype=np.float32), h.T) for h in hyper])
    y = upscale_hyper_blocked(jnp.asarray(src), pu["w1"], pu["b1"], pu["ln_s"], pu["ln_b"], pu["w2bd"], pu["b2"],
                              jnp.asarray(hbd))
    want = np.asarray(interleave_blocked_masks(y, g, m))
    w1 = torch.from_numpy(u["deconv1"]["w"]).permute(2, 0, 1, 3).reshape(Cin, 4 * c4)
    w2 = torch.from_numpy(u["deconv2"]["w"]).permute(2, 0, 1, 3).reshape(c4, 4 * c8)
    got = upscale_hyper(torch.from_numpy(src), w1, torch.from_numpy(u["deconv1"]["b"]),
                        torch.from_numpy(u["ln"]["scale"]), torch.from_numpy(u["ln"]["bias"]), w2,
                        torch.from_numpy(u["deconv2"]["b"]), torch.from_numpy(hyper))
    assert got.shape == (Bu, m, 4 * g, 4 * g) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
