"""The SAM encoder block's fused glue (``hybridgl_tpu_torch/kernels/sam_glue.py``,
``csrc/sam_glue.cu``) on the CPU, where each operator runs its plain
version: each ``torch.ops.hybridgl.sam_*`` operator equal bit for bit to the
sequence of PyTorch operations the encoder ran before the glue was fused
(the LayerNorm, window partition and unpartition, bias adds, head split,
rel-pos einsums, merge, GELU and residuals, written out below as ``old``),
in bf16 and f32, on a grid that is not a multiple of the window (pad rows
zero), one that is, a global block and a head-sharded width like
``parallel/encoder_tp.py``'s; ``encode_image`` and ``_attention`` equal to
the encoder as it was written before; the launch counters; and the kernels'
device names, none of which may contain a substring by which the
benchmark's trace reader counts the port's own kernels
(``benchmark/benchlib/trace.py:own_kernel``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hybridgl_tpu_torch.core.config import SamConfig, sam_preset
from hybridgl_tpu_torch.core.params import cast_tree, init_sam
from hybridgl_tpu_torch.kernels import SAM_GLUE, kernel_wrappers, launch_counts, reset_launch_counts, sam_glue
from hybridgl_tpu_torch.models.sam import image_encoder

REPO = Path(__file__).resolve().parent.parent
OPS = torch.ops.hybridgl
DTYPES = [torch.bfloat16, torch.float32]
DTYPE_IDS = ["bf16", "f32"]
# (images, grid side, window, width, heads): a padded grid (10 -> 12), an exact one, the tiny preset's (4 -> 6)
GEOMETRIES = [(2, 10, 4, 32, 2), (1, 8, 4, 48, 3), (3, 4, 3, 32, 2)]
GEOMETRY_IDS = ["padded", "exact", "tiny"]


class old:
    """The encoder's glue as ``models/sam/image_encoder.py`` wrote it before it was fused."""

    @staticmethod
    def ln(p, x, eps=1e-6):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
        return y.to(x.dtype)

    @staticmethod
    def window_partition(x, window):
        B, H, W, C = x.shape
        pad_h = (window - H % window) % window
        pad_w = (window - W % window) % window
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        x = x.reshape(B, Hp // window, window, Wp // window, window, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)

    @staticmethod
    def window_unpartition(wins, window, pad_hw, hw):
        Hp, Wp = pad_hw
        H, W = hw
        C = wins.shape[-1]
        B = wins.shape[0] // ((Hp // window) * (Wp // window))
        x = wins.reshape(B, Hp // window, Wp // window, window, window, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        return x[:, :H, :W, :]

    @staticmethod
    def heads_and_rel(qkv, num_heads, size, Rh, Rw):
        B, S, D3 = qkv.shape
        D = D3 // 3
        hd = D // num_heads

        def heads(t):
            return t.reshape(B, S, num_heads, hd).transpose(1, 2).reshape(B * num_heads, S, hd).contiguous()

        q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
        q6 = q.float().reshape(B * num_heads, size, size, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", q6, Rh).reshape(B * num_heads, S, size)
        rel_w = torch.einsum("bhwc,wkc->bhwk", q6, Rw).reshape(B * num_heads, S, size)
        return q, k, v, rel_h.contiguous(), rel_w.contiguous()

    @staticmethod
    def attention(p_attn, x, num_heads, size):
        B, S, dt = x.shape[0], size * size, x.dtype
        qkv = x.reshape(B, S, x.shape[-1]) @ p_attn["qkv_w"].to(dt) + p_attn["qkv_b"].to(dt)
        D = qkv.shape[-1] // 3
        hd = D // num_heads
        if "rel_tab_h" in p_attn:
            Rh, Rw = p_attn["rel_tab_h"], p_attn["rel_tab_w"]
        else:
            Rh = image_encoder.get_rel_pos_table(size, p_attn["rel_pos_h"].float())
            Rw = image_encoder.get_rel_pos_table(size, p_attn["rel_pos_w"].float())
        q, k, v, rel_h, rel_w = old.heads_and_rel(qkv, num_heads, size, Rh, Rw)
        out = image_encoder.reference_attention_rel_pos(q, k, v, rel_h, rel_w, size, hd**-0.5)
        out = out.reshape(B, num_heads, S, hd).transpose(1, 2).reshape(B, S, D)
        out = out @ p_attn["proj_w"].to(dt) + p_attn["proj_b"].to(dt)
        return out.reshape(B, size, size, out.shape[-1])

    @staticmethod
    def mlp(p, x):
        dt = x.dtype
        h = x @ p["mlp_fc"]["w"].to(dt) + p["mlp_fc"]["b"].to(dt)
        h = F.gelu(h, approximate="none")
        return h @ p["mlp_proj"]["w"].to(dt) + p["mlp_proj"]["b"].to(dt)

    @staticmethod
    def block(p, x, cfg, window):
        shortcut = x
        x = old.ln(p["ln_1"], x)
        if window > 0:
            H, W = x.shape[1], x.shape[2]
            wins, pad_hw = old.window_partition(x, window)
            wins = old.attention(p["attn"], wins, cfg.encoder_heads, window)
            x = old.window_unpartition(wins, window, pad_hw, (H, W))
        else:
            x = old.attention(p["attn"], x, cfg.encoder_heads, x.shape[1])
        x = shortcut + x
        return x + old.mlp(p, old.ln(p["ln_2"], x))

    @staticmethod
    def encode_image(p, images, cfg):
        x = image_encoder.embed_patches(p, images, cfg)
        for i, bp in enumerate(p["blocks"]):
            x = old.block(bp, x, cfg, 0 if i in cfg.encoder_global_idx else cfg.window_size)
        return image_encoder.neck(p, x)


def _t(rng, *shape, dtype=torch.float32, std=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32)).to(dtype)


def _pad_hw(grid, window):
    return (-(-grid // window) * window,) * 2


def todays_and_fused(name, dtype, N, grid, window, D, H, seed=0):
    """(the operator's outputs, the old sequence's outputs) on the same inputs;
    ``window`` 0 is a global block."""
    rng = np.random.default_rng(seed)
    x = _t(rng, N, grid, grid, D, dtype=dtype, std=2.0, mean=0.5)
    ln = {"scale": _t(rng, D, std=0.1, mean=1.0, dtype=dtype), "bias": _t(rng, D, std=0.1, dtype=dtype)}
    b = _t(rng, D, std=0.5, dtype=dtype)
    size = window or grid
    B = N * (_pad_hw(grid, window)[0] // window) ** 2 if window else N
    if name == "sam_layer_norm":
        want = old.ln(ln, x)
        return OPS.sam_layer_norm(x, ln["scale"], ln["bias"], window, 1e-6), (
            old.window_partition(want, window)[0] if window else want)
    if name == "sam_qkv_heads":
        a, w, b3 = _t(rng, B, size * size, D, dtype=dtype), _t(rng, D, 3 * D, std=D**-0.5, dtype=dtype), \
            _t(rng, 3 * D, std=0.5, dtype=dtype)
        Rh, Rw = (_t(rng, size, size, D // H, std=0.2) for _ in range(2))
        y = a @ w
        return OPS.sam_qkv_heads(y, b3, Rh, Rw, H), old.heads_and_rel(a @ w + b3, H, size, Rh, Rw)
    if name == "sam_merge_heads":
        ctx = _t(rng, B * H, size * size, D // H, dtype=dtype)
        S, hd = size * size, D // H
        return OPS.sam_merge_heads(ctx, B), ctx.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, D)
    if name == "sam_residual_layer_norm":  # after the out-projection: its product in the block's layout, ln_2
        a, w = _t(rng, B, size * size, D, dtype=dtype), _t(rng, D, D, std=D**-0.5, dtype=dtype)
        out = (a @ w + b).reshape(B, size, size, D)
        if window:
            out = old.window_unpartition(out, window, _pad_hw(grid, window), (grid, grid))
        x_new = x + out
        return OPS.sam_residual_layer_norm(x, a @ w, b, ln["scale"], ln["bias"], window, 0, 1e-6), (
            x_new, old.ln(ln, x_new))
    if name == "sam_residual_add":
        a, w = _t(rng, N, grid, grid, 4 * D, dtype=dtype), _t(rng, 4 * D, D, std=(4 * D) ** -0.5, dtype=dtype)
        return OPS.sam_residual_add(x, a @ w, b), x + (a @ w + b)
    assert name == "sam_bias_gelu"
    a, w, b4 = _t(rng, N, grid, grid, D, dtype=dtype), _t(rng, D, 4 * D, std=D**-0.5, dtype=dtype), \
        _t(rng, 4 * D, std=0.5, dtype=dtype)
    return OPS.sam_bias_gelu(a @ w, b4), F.gelu(a @ w + b4, approximate="none")


def flat(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


def same(got, want, dtype):
    for g, w in zip(flat(got), flat(want), strict=True):
        assert g.dtype == w.dtype and g.dtype in (dtype, torch.float32) and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("block", ["windowed", "global"])
@pytest.mark.parametrize("N,grid,window,D,H", GEOMETRIES, ids=GEOMETRY_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", SAM_GLUE)
def test_operator_equals_the_old_sequence(name, dtype, N, grid, window, D, H, block):
    got, want = todays_and_fused(name, dtype, N, grid, window if block == "windowed" else 0, D, H)
    same(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("window", [4, 0], ids=["into_windows", "onto_the_grid"])
def test_residual_layer_norm_after_the_mlp_writes_the_next_blocks_ln_1(dtype, window):
    """The MLP's residual with the next block's ln_1, partitioned into its
    windows (pad rows zero, as F.pad after the LayerNorm) or on the grid."""
    rng = np.random.default_rng(1)
    x, h = _t(rng, 2, 10, 10, 32, dtype=dtype), _t(rng, 2, 10, 10, 128, dtype=dtype)
    w, b = _t(rng, 128, 32, std=128**-0.5, dtype=dtype), _t(rng, 32, std=0.5, dtype=dtype)
    ln = {"scale": _t(rng, 32, std=0.1, mean=1.0, dtype=dtype), "bias": _t(rng, 32, std=0.1, dtype=dtype)}
    x_new, ln_x = sam_glue.residual_layer_norm(x, h @ w, b, ln["scale"], ln["bias"], 0, window)
    want_x = x + (h @ w + b)
    want_ln = old.ln(ln, want_x)
    if window:
        want_ln = old.window_partition(want_ln, window)[0]
        wins = ln_x.reshape(2, 3, 3, 4, 4, 32)  # [image, window row, window column, row, column, D]
        assert ln_x.shape == (18, 4, 4, 32) and not wins[:, 2, :, 2:].any() and not wins[:, :, 2, :, 2:].any()
    same((x_new, ln_x), (want_x, want_ln), dtype)


@pytest.mark.parametrize("prepared", [True, False], ids=["prepared", "raw"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("cfg", [
    sam_preset("test-tiny"),  # grid 4, window 3: padded to 6; blocks 1 and 3 global
    SamConfig(img_size=160, encoder_width=48, encoder_depth=3, encoder_heads=3, encoder_global_idx=(1,),
              window_size=4, prompt_dim=16),  # grid 10 -> 12; a windowed block after the global one
    SamConfig(img_size=512, encoder_width=64, encoder_depth=2, encoder_heads=2, encoder_global_idx=(1,),
              window_size=8, prompt_dim=32),  # the K1 (window 8) and K2 (grid 32) routes
], ids=["tiny", "padded", "routing"])
def test_encode_image_equals_the_old_encoder(cfg, dtype, prepared):
    """``encode_image`` on the CPU: the chained operators (each ln_1 written
    by the kernel of the residual before it, in the block's window layout)
    change no bit against the encoder written block by block."""
    g = torch.Generator().manual_seed(2)
    params = init_sam(g, cfg)
    for blk in params["encoder"]["blocks"]:  # nonzero rel-pos and biases so they matter
        for key in ("rel_pos_h", "rel_pos_w", "qkv_b", "proj_b"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.2
    params = cast_tree(params, dtype)
    if prepared:
        params = image_encoder.prepare_sam_params(params, cfg)
    images = torch.randn((2, cfg.img_size, cfg.img_size, 3), generator=g)
    got = image_encoder.encode_image(params["encoder"], images, cfg)
    want = old.encode_image(params["encoder"], images, cfg)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("heads_local", [1, 2, 4], ids=["mp4", "mp2", "mp1"])
@pytest.mark.parametrize("size", [4, 10], ids=["window", "global"])
def test_attention_keeps_its_result_at_a_head_sharded_width(size, heads_local):
    """``_attention``, which the tensor-parallel encoder calls with a rank's
    heads (qkv column-sharded to 3 x heads_local x hd), equals the old
    attention bit for bit."""
    rng = np.random.default_rng(3)
    D, hd = 64, 16
    dl = heads_local * hd
    p = {"qkv_w": _t(rng, D, 3 * dl, std=D**-0.5), "qkv_b": _t(rng, 3 * dl, std=0.5),
         "proj_w": _t(rng, dl, D, std=dl**-0.5), "proj_b": _t(rng, D, std=0.5),
         "rel_pos_h": _t(rng, 2 * size - 1, hd, std=0.2), "rel_pos_w": _t(rng, 2 * size - 1, hd, std=0.2)}
    x = _t(rng, 3, size, size, D)
    got = image_encoder._attention(p, x, heads_local, size)
    assert torch.equal(got, old.attention(p, x, heads_local, size))


def test_windowed_shape():
    assert sam_glue.windowed_shape((1, 64, 64, 1280), 14) == (25, 14, 14, 1280)
    assert sam_glue.windowed_shape((5, 64, 64, 1280), 0) == (5, 64, 64, 1280)
    assert sam_glue.windowed_shape((2, 4, 4, 32), 3) == (8, 3, 3, 32)


def _global_kernels(source: str) -> dict:
    """{kernel name: its signature up to the parameter list's end} of every ``__global__`` function."""
    out = {}
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(([^)]*)\)", source):
        out[m.group(1)] = m.group(0)
    return out


def test_sam_glue_kernel_names_miss_the_benchmarks_own_kernels():
    """The benchmark counts the port's own kernels in a trace by substrings of
    their device names; a glue kernel matching one would be counted as
    another kernel's launch and silence ``kernels_roofline``."""
    from benchmark.benchlib.trace import own_kernel

    kernels = _global_kernels((REPO / "hybridgl_tpu_torch" / "csrc" / "sam_glue.cu").read_text())
    assert set(kernels) == {"sam_glue_rows", "sam_glue_qkv_rel", "sam_glue_merge", "sam_glue_bias_gelu"}
    for name, signature in kernels.items():
        assert own_kernel(name) is None and own_kernel(signature) is None, name
        # the device symbols as a trace shows them, template arguments and all
        for args in ("<__nv_bfloat16, 5, true, true>", "<float, 10, true, false>", "<__nv_bfloat16>", ""):
            assert own_kernel(f"void (anonymous namespace)::{name}{args}(Layout)") is None


def test_sam_glue_wrappers_count_launches_and_cpu_calls_count_none():
    """Each SAM glue wrapper is a kernel wrapper with a launch counter, reset
    with the others; a CPU call runs the plain version and counts nothing
    (on a CUDA tensor a wrapper launches or raises: no plain fallback)."""
    wrappers = kernel_wrappers()
    assert set(SAM_GLUE) <= set(wrappers)
    for name in SAM_GLUE:
        assert wrappers[name] is getattr(sam_glue, name.removeprefix("sam_"))
        wrappers[name].launches = 3
        assert not hasattr(wrappers[name], "fallbacks") and not hasattr(wrappers[name], "tc_launches")
    reset_launch_counts()
    assert not any(launch_counts().values())
    for name in SAM_GLUE:
        todays_and_fused(name, torch.bfloat16, *GEOMETRIES[0])
    cfg = sam_preset("test-tiny")
    image_encoder.encode_image(init_sam(torch.Generator().manual_seed(0), cfg)["encoder"],
                               torch.zeros((1, cfg.img_size, cfg.img_size, 3)), cfg)
    assert not any(launch_counts().values())
