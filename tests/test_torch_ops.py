"""The ten kernels as registered PyTorch operators, ``torch.ops.hybridgl.*``
(``hybridgl_tpu_torch/kernels/_ops.py``), on the CPU: for each operator
``torch.library.opcheck`` (``test_schema``: the schema's aliasing and
mutation claims hold; ``test_faketensor``: the fake implementation gives the
real outputs' shapes, strides and dtypes; ``test_autograd_registration``;
``test_aot_dispatch_dynamic``: the operator traces under AOTAutograd with
symbolic shapes, where its fake implementation can take them), the operator
equal bit for bit to its plain version and to its public wrapper, and the
fake outputs' shapes and dtypes against the real ones. Small shapes, inputs
from a numpy seed; the four attention operators also in bf16 (pass 1 runs in
its bf16 stats dtype).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from hybridgl_tpu_torch.kernels import kernel_wrappers
from hybridgl_tpu_torch.kernels.clip_attention import clip_attention, reference_clip_attention
from hybridgl_tpu_torch.kernels.decoder_attn import i2t_ln_update, reference_i2t_ln_update
from hybridgl_tpu_torch.kernels.decoder_attn_t2i import reference_t2i_ctx, t2i_ctx
from hybridgl_tpu_torch.kernels.decoder_pass import i2t_ln_then_t2i, reference_i2t_ln_then_t2i
from hybridgl_tpu_torch.kernels.flash_attention import (
    flash_attention_fused,
    flash_attention_rel_pos,
    flash_windowed_fused,
    reference_attention_rel_pos,
)
from hybridgl_tpu_torch.kernels.pass1_stats import (
    half_transform,
    pass1_stats,
    pass1_stats_half,
    reference_pass1_stats_half,
)
from hybridgl_tpu_torch.kernels.upscale_hyper import reference_upscale_hyper, upscale_hyper

OPS = torch.ops.hybridgl
NAMES = ["flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos", "clip_attention",
         "pass1_stats_half", "pass1_stats", "i2t_ln_then_t2i", "i2t_ln_update", "t2i_ctx", "upscale_hyper_blocked"]
# K4's fake output side is isqrt(g * g): a symbolic size has no integer square root
NOT_SYMBOLIC = {"upscale_hyper_blocked"}
WINDOW = [2.0, 3.0, 10.0, 12.0]


def _t(rng, *shape, dtype=torch.float32, std=0.5):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dtype)


def _decoder(rng, B=2, S=48, C=32, heads=2, tp=8, T=7, Cq=None):
    """K7's operands: w, off (-1e30 on the padding lanes), vo, const, ln."""
    Cq, GT = Cq or C, heads * tp
    off = _t(rng, B, heads, tp)
    off[:, :, T:] = -1e30
    return [_t(rng, B, Cq, GT, std=0.3), off.reshape(B, GT), _t(rng, B, GT, C), _t(rng, C),
            1.0 + _t(rng, C, std=0.1), _t(rng, C, std=0.1)]


def case(name, dtype=torch.float32, seed=0):
    """(the operator's arguments, its plain version on them, the public wrapper on them)."""
    rng = np.random.default_rng(seed)
    if name in ("flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos"):
        G, BH, hd = (3, 4, 16) if name == "flash_windowed_fused" else (4, 2, 16)
        qkv = [_t(rng, BH, G * G, hd, dtype=dtype) for _ in range(3)]
        rel = [_t(rng, BH, G * G, G) for _ in range(2)]
        if name == "flash_attention_rel_pos":
            return ((*qkv, *rel, G), lambda: reference_attention_rel_pos(*qkv, *rel, G, 1.0),
                    lambda: flash_attention_rel_pos(*qkv, *rel, G, block_q=G * G, block_k=G * G))
        wrapper = flash_windowed_fused if name == "flash_windowed_fused" else flash_attention_fused
        return ((*qkv, *rel, G, 0.25), lambda: reference_attention_rel_pos(*qkv, *rel, G, 0.25),
                lambda: wrapper(*qkv, *rel, G, 0.25))
    if name == "clip_attention":
        N, H, L, hd = 2, 2, 5, 16
        qkv = [_t(rng, N * H, L, hd, dtype=dtype) for _ in range(3)]
        bias = torch.where(torch.from_numpy(rng.random((N, L)) < 0.4), torch.finfo(torch.float32).min, 0.0)
        bias[:, 0] = 0.0
        return ((*qkv, bias, H, 0.25), lambda: reference_clip_attention(*qkv, bias, H, 0.25),
                lambda: clip_attention(*qkv, bias, H, 0.25))
    if name == "pass1_stats_half":
        tmp, Wy = _t(rng, 3, 16, 24, dtype=torch.bfloat16), _t(rng, 24, 16, dtype=torch.bfloat16)
        return ((tmp, Wy, WINDOW, 0.0, 0.5), lambda: reference_pass1_stats_half(tmp, Wy, WINDOW, 0.0, 0.5),
                lambda: pass1_stats_half(tmp, Wy, WINDOW, 0.0, 0.5))
    if name == "pass1_stats":
        low, WxT, Wy = (_t(rng, *s, dtype=torch.bfloat16) for s in ((3, 16, 12), (12, 24), (24, 16)))
        return ((low, WxT, Wy, WINDOW, 0.0, 0.5),
                lambda: reference_pass1_stats_half(half_transform(low, WxT), Wy, WINDOW, 0.0, 0.5),
                lambda: pass1_stats(low, WxT, Wy, WINDOW, 0.0, 0.5))
    if name == "i2t_ln_update":
        keys, pe = _t(rng, 2, 48, 32), _t(rng, 1, 48, 32)
        ops = _decoder(rng)
        return ((keys, keys, *ops, 2, 8, pe), lambda: reference_i2t_ln_update(keys, keys, *ops, 2, 8, pe=pe),
                lambda: i2t_ln_update(keys, keys, *ops, 2, 8, pe=pe))
    if name == "t2i_ctx":
        keys, pe, qw = _t(rng, 2, 48, 32), _t(rng, 1, 48, 32), _t(rng, 2, 32, 16, std=0.3)
        return (keys, pe, qw), lambda: reference_t2i_ctx(keys, pe, qw), lambda: t2i_ctx(keys, pe, qw)
    if name == "i2t_ln_then_t2i":
        qside, base, pe = _t(rng, 1, 48, 16), _t(rng, 1, 48, 32), _t(rng, 1, 48, 32)
        ops, qw = _decoder(rng, Cq=16), _t(rng, 2, 32, 16, std=0.3)
        args = (qside, base, pe, *ops, qw, 2, 8, True)
        return args, lambda: reference_i2t_ln_then_t2i(*args), lambda: i2t_ln_then_t2i(*args)
    assert name == "upscale_hyper_blocked"
    g, C, c4, c8, m = 5, 32, 8, 4, 3
    args = (_t(rng, 2, g * g, C), _t(rng, C, 4 * c4, std=0.2), _t(rng, c4), 1.0 + _t(rng, c4, std=0.1),
            _t(rng, c4, std=0.1), _t(rng, c4, 4 * c8, std=0.3), _t(rng, c8), _t(rng, 2, m, c8))
    return args, lambda: reference_upscale_hyper(*args), lambda: upscale_hyper(*args)


def flat(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


def pass1_outputs(stab, flags):
    """An operator's (stab, flags [2, B, C]) as the wrapper's (stab, row_any, col_any)."""
    return [stab, flags[0], flags[1]]


def test_the_ten_operators_are_registered_under_the_reference_names():
    assert set(NAMES) == set(kernel_wrappers()) and len(NAMES) == 10
    for name in NAMES:
        assert getattr(OPS, name).default.name() == f"hybridgl::{name}"


@pytest.mark.parametrize("name", NAMES)
def test_opcheck(name):
    utils = ["test_schema", "test_faketensor", "test_autograd_registration"]
    if name not in NOT_SYMBOLIC:
        utils.append("test_aot_dispatch_dynamic")
    args, _, _ = case(name)
    result = torch.library.opcheck(getattr(OPS, name).default, args, test_utils=utils)
    assert result == dict.fromkeys(utils, "SUCCESS")


@pytest.mark.parametrize("name,dtype", [(n, torch.float32) for n in NAMES] + [
    (n, torch.bfloat16) for n in NAMES[:4]])
def test_operator_equals_its_plain_version_and_its_wrapper(name, dtype):
    args, plain, wrapper = case(name, dtype)
    got = flat(getattr(OPS, name)(*args))
    if name.startswith("pass1_stats"):
        got = pass1_outputs(*got)
    for a, b, c in zip(got, flat(plain()), flat(wrapper()), strict=True):
        assert a.dtype == b.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("name", NAMES)
def test_fake_outputs_have_the_real_shapes_and_dtypes(name):
    args, _, _ = case(name)
    op = getattr(OPS, name).default
    real = flat(op(*args))
    with FakeTensorMode() as mode:
        fake = flat(op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args)))
    assert [(f.shape, f.dtype, f.device) for f in fake] == [(r.shape, r.dtype, r.device) for r in real]


def test_operators_write_into_no_input():
    """Every schema declares no mutation; the inputs are unchanged after a call."""
    for name in NAMES:
        args, _, _ = case(name)
        before = [a.clone() for a in args if isinstance(a, torch.Tensor)]
        getattr(OPS, name)(*args)
        after = [a for a in args if isinstance(a, torch.Tensor)]
        assert all(torch.equal(a, b) for a, b in zip(before, after)), name
        assert not getattr(OPS, name).default._schema.is_mutable, name


def test_a_cpu_call_counts_no_launch():
    from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    for name in NAMES:
        args, _, _ = case(name)
        getattr(OPS, name)(*args)
    assert not any(launch_counts().values())
