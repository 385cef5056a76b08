"""The decoder kernels' two CUDA variants and their oracle, on the CPU.

K3/K7/K8 and K4 each have a tensor-core (wgmma) kernel for bf16 at SAM's
widths and a CUDA-core kernel for everything else. Neither runs here; what
this file holds on the CPU is what surrounds them:

  * ``variant``: which kernel a CUDA call takes and the shared memory it
    asks for, mirrored from the C dispatch: wgmma inside the 232,448 bytes a
    block may use at the production shapes, CUDA-core for f32, for ragged S
    and for the test-tiny widths;
  * the plain versions (the kernels' only oracle on the card) against the
    JAX package's Pallas kernels in interpret mode at the production widths
    (C = 256, Cq = 128 and 256, GT = 64, c4 = 64, c8 = 32; S = 64, B = 2) in
    bf16, same numpy inputs rounded to bf16 on both sides. Bars, the kernel
    check's: attention-type outputs cos >= 0.999 and mean|d| / mean|ref| <
    0.02 (the two sides sum in another order and round keys' to bf16 once,
    so single elements differ by a bf16 ulp); K4 logits max|d| < 0.1 and
    > 99.5% sign agreement (the JAX kernel rounds a group-mean-centred w1
    and uses a polynomial erf);
  * ``upscale_hyper`` with bf16 weights gives exactly what f32 copies of the
    same values give (the wrapper hands the tensor-core kernel bf16 weights).
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
from hybridgl_tpu_torch.kernels import decoder_attn, upscale_hyper as upscale_mod
from hybridgl_tpu_torch.kernels.decoder_attn import I2T, PASS, T2I, i2t_ln_update
from hybridgl_tpu_torch.kernels.decoder_attn_t2i import t2i_ctx
from hybridgl_tpu_torch.kernels.decoder_pass import i2t_ln_then_t2i
from hybridgl_tpu_torch.kernels.upscale_hyper import upscale_hyper

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
BF16, F32 = torch.bfloat16, torch.float32
S, B, C, HEADS, TP, T = 64, 2, 256, 8, 8, 7


# (mode, dtype, S, Cq, C, heads, tp, GT2, add_pe, same_base) -> kernel
DECODER_CALLS = {
    "K3 pass A": ((PASS, BF16, 4096, 128, 256, 8, 8, 64, False, False), "wgmma"),
    "K3 pass B": ((PASS, BF16, 4096, 256, 256, 8, 8, 64, True, True), "wgmma"),
    "K3 pass B, one tile": ((PASS, BF16, 64, 256, 256, 8, 8, 64, True, True), "wgmma"),
    "K7 per-prompt": ((I2T, BF16, 4096, 256, 256, 8, 8, 4, True, True), "wgmma"),
    "K7 shared": ((I2T, BF16, 4096, 128, 256, 8, 8, 4, False, False), "wgmma"),
    "K8": ((T2I, BF16, 4096, 256, 256, 1, 8, 64, False, False), "wgmma"),
    "K3 pass B f32": ((PASS, F32, 4096, 128, 128, 8, 8, 64, True, True), "cuda-core"),
    "K3 pass A f32": ((PASS, F32, 4096, 64, 128, 8, 8, 64, False, False), "cuda-core"),
    "K3 ragged S": ((PASS, BF16, 4064, 256, 256, 8, 8, 64, True, True), "cuda-core"),
    "K3 S below a tile": ((PASS, BF16, 32, 256, 256, 8, 8, 64, True, True), "cuda-core"),
    "K3 test-tiny": ((PASS, BF16, 1024, 32, 32, 2, 8, 16, True, True), "cuda-core"),
    "K3 tp 16": ((PASS, BF16, 4096, 256, 256, 4, 16, 64, True, True), "cuda-core"),
    "K3 pe with a separate base": ((PASS, BF16, 4096, 256, 256, 8, 8, 64, True, False), "cuda-core"),
    "K7 shared at Cq 256": ((I2T, BF16, 4096, 256, 256, 8, 8, 4, False, False), "cuda-core"),
    "K8 f32": ((T2I, F32, 4096, 128, 128, 1, 8, 64, False, False), "cuda-core"),
    "K8 GT 128": ((T2I, BF16, 4096, 256, 256, 1, 8, 128, False, False), "cuda-core"),
}


@pytest.mark.parametrize("call", list(DECODER_CALLS))
def test_decoder_attn_variant(call):
    args, want = DECODER_CALLS[call]
    kind, smem = decoder_attn.variant(*args)
    assert kind == want
    assert 0 < smem <= SMEM_LIMIT


# (dtype, C, c4, c8, m) -> kernel
UPSCALE_CALLS = {
    "m 3": ((BF16, 256, 64, 32, 3), "wgmma"),
    "m 1": ((BF16, 256, 64, 32, 1), "wgmma"),
    "m 2": ((BF16, 256, 64, 32, 2), "cuda-core"),
    "f32 at half width": ((F32, 128, 32, 16, 3), "cuda-core"),
    "test-tiny": ((BF16, 32, 8, 4, 3), "cuda-core"),
}


@pytest.mark.parametrize("call", list(UPSCALE_CALLS))
def test_upscale_hyper_variant(call):
    """The variant does not depend on B: B = 64 (a pass-1 chunk) and B = 128
    (PhraseCut's pass 2) take the same kernel."""
    args, want = UPSCALE_CALLS[call]
    kind, smem = upscale_mod.variant(*args)
    assert kind == want
    assert 0 < smem <= SMEM_LIMIT


def test_f32_at_full_width_does_not_fit():
    """Why the card checks hold the CUDA-core kernels in f32 at half width:
    at C = 256 their f32 token-side operands and deconv weights exceed a
    block's shared memory, and the wrappers raise rather than launch."""
    assert decoder_attn.variant(PASS, F32, 4096, 256, 256, 8, 8, 64, True, True) == ("cuda-core", 274816)
    assert upscale_mod.variant(F32, 256, 64, 32, 3)[1] > SMEM_LIMIT


def bf16_pair(x):
    """The same values, rounded to bf16, for JAX and for the port."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(BF16)


def f32_pair(x):
    return jnp.asarray(x), torch.from_numpy(x)


def close_bf16(got, want):
    g = got.float().numpy().ravel().astype(np.float64)
    w = np.asarray(want.astype(jnp.float32)).ravel().astype(np.float64)
    assert np.isfinite(g).all()
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    rel = np.abs(g - w).mean() / np.abs(w).mean()
    assert cos >= 0.999 and rel < 0.02, (cos, rel)


def i2t_operands(rng, Cq):
    """w [B, Cq, GT] f32, off (-1e30 on the padding lane), vo bf16, const, LN."""
    GT = HEADS * TP
    f = lambda *s, std=0.5: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    off = f(B, HEADS, TP)
    off[:, :, T:] = -1e30
    ops = dict(w=f32_pair(f(B, Cq, GT, std=2 * Cq**-0.5)), off=f32_pair(off.reshape(B, GT)), vo=bf16_pair(f(B, GT, C)),
               const=f32_pair(f(C, std=0.1)), ln_scale=f32_pair(1.0 + f(C, std=0.1)), ln_bias=f32_pair(f(C, std=0.1)))
    return {k: v[0] for k, v in ops.items()}, {k: v[1] for k, v in ops.items()}


def image_streams(rng, shared):
    Cq = 128 if shared else C
    qside = bf16_pair((rng.standard_normal((1 if shared else B, S, Cq)) * 0.5).astype(np.float32))
    base = bf16_pair((rng.standard_normal((1, S, C)) * 0.5).astype(np.float32)) if shared else qside
    pe = bf16_pair((rng.standard_normal((1, S, C)) * 0.5).astype(np.float32))
    return Cq, qside, base, pe


@pytest.mark.parametrize("shared", [True, False])
def test_i2t_ln_then_t2i_plain_matches_jax_at_production_widths(shared):
    rng = np.random.default_rng(10)
    Cq, qside, base, pe = image_streams(rng, shared)
    ops_j, ops_t = i2t_operands(rng, Cq)
    qw = f32_pair((rng.standard_normal((B, C, HEADS * TP)) * 2 * C**-0.5).astype(np.float32))
    wk, wc = jax_i2t_ln_then_t2i(qside[0], base[0], pe[0], **ops_j, qw_next=qw[0], heads=HEADS, tp=TP,
                                 shared_qside=shared)
    gk, gc = i2t_ln_then_t2i(qside[1], base[1], pe[1], **ops_t, qw_next=qw[1], heads=HEADS, tp=TP,
                             shared_qside=shared)
    assert gk.dtype == BF16 and gk.shape == (B, S, C) and gc.shape == (B, HEADS * TP, C)
    close_bf16(gk, wk)
    close_bf16(gc, wc)


@pytest.mark.parametrize("shared", [True, False])
def test_i2t_ln_update_plain_matches_jax_at_production_widths(shared):
    rng = np.random.default_rng(11)
    Cq, qside, base, pe = image_streams(rng, shared)
    ops_j, ops_t = i2t_operands(rng, Cq)
    want = jax_i2t_ln_update(qside[0], base[0], **ops_j, heads=HEADS, tp=TP, pe=None if shared else pe[0])
    got = i2t_ln_update(qside[1], base[1], **ops_t, heads=HEADS, tp=TP, pe=None if shared else pe[1])
    close_bf16(got, want)


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_t2i_ctx_plain_matches_jax_at_production_widths(scale):
    rng = np.random.default_rng(12)
    keys = bf16_pair((rng.standard_normal((B, S, C)) * 0.5).astype(np.float32))
    pe = bf16_pair((rng.standard_normal((1, S, C)) * 0.5).astype(np.float32))
    qw = (rng.standard_normal((B, C, HEADS * TP)) * 2 * C**-0.5 * scale).astype(np.float32)
    qw[:, :, TP - 1 :: TP] = 0.0
    qw = f32_pair(qw)
    close_bf16(t2i_ctx(keys[1], pe[1], qw[1]), jax_t2i_ctx(keys[0], pe[0], qw[0]))


def upscale_operands(rng, m, g=8, Cin=256, c4=64, c8=32):
    f = lambda *s, std=0.5: (rng.standard_normal(s) * std).astype(np.float32)  # noqa: E731
    u = {"deconv1": {"w": f(2, 2, Cin, c4, std=Cin**-0.5), "b": f(c4, std=0.1)},
         "deconv2": {"w": f(2, 2, c4, c8, std=c4**-0.5), "b": f(c8, std=0.1)},
         "ln": {"scale": 1.0 + f(c4, std=0.1), "bias": f(c4, std=0.1)}}
    return u, f(B, g * g, Cin), f(B, m, c8)


def port_upscale_args(u, src, hyper, wdtype):
    Cin, c4 = u["deconv1"]["w"].shape[2:]
    c8 = u["deconv2"]["w"].shape[3]
    w1 = torch.from_numpy(u["deconv1"]["w"]).permute(2, 0, 1, 3).reshape(Cin, 4 * c4)
    w2 = torch.from_numpy(u["deconv2"]["w"]).permute(2, 0, 1, 3).reshape(c4, 4 * c8)
    t = torch.from_numpy
    return (t(src).to(BF16), w1.to(BF16).to(wdtype), t(u["deconv1"]["b"]), t(u["ln"]["scale"]), t(u["ln"]["bias"]),
            w2.to(BF16).to(wdtype), t(u["deconv2"]["b"]), t(hyper).to(BF16).to(wdtype))


@pytest.mark.parametrize("m", [3, 1])
def test_upscale_hyper_plain_matches_jax_at_production_widths(m):
    rng = np.random.default_rng(13)
    g = 8
    u, src, hyper = upscale_operands(rng, m, g)
    bf = jnp.bfloat16
    pu = _prep_upscale({k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in u.items()}, 256)
    hb = jnp.asarray(hyper).astype(bf)
    hbd = jnp.stack([jnp.kron(jnp.eye(16, dtype=bf), h.T) for h in hb])
    y = upscale_hyper_blocked(jnp.asarray(src).astype(bf), pu["w1"].astype(bf), pu["b1"], pu["ln_s"], pu["ln_b"],
                              pu["w2bd"].astype(bf), pu["b2"], hbd)
    want = np.asarray(interleave_blocked_masks(y, g, m)).astype(np.float32)
    got = upscale_hyper(*port_upscale_args(u, src, hyper, BF16)).numpy()
    assert got.shape == (B, m, 4 * g, 4 * g) and np.isfinite(got).all()
    assert np.abs(got - want).max() < 0.1
    assert ((got > 0) == (want > 0)).mean() > 0.995


@pytest.mark.parametrize("m", [3, 1])
def test_upscale_hyper_bf16_weights_equal_f32_copies(m):
    """Weights already rounded to bf16 give the same masks whether they
    arrive as bf16 or widened to f32: exact equality."""
    u, src, hyper = upscale_operands(np.random.default_rng(14), m)
    a = upscale_hyper(*port_upscale_args(u, src, hyper, BF16))
    b = upscale_hyper(*port_upscale_args(u, src, hyper, F32))
    assert a.dtype == F32 and torch.equal(a, b)
