"""The glue of the SAM ViT image encoder's block, fused (``csrc/sam_glue.cu``).

Replaces no TPU kernel: the JAX package leaves the elementwise work around
the encoder block's matrix products and K1/K2 to XLA, which fuses it. In the
port each of those PyTorch operations was a kernel of its own inside the
proposal graph (LayerNorm about eight f32 passes, the window pad and
permutes, four bias adds, three head copies, the f32 rel-pos einsums, exact
GELU over the 5,120-wide hidden state, two residuals): ~25-30 launches a
block. Six operators take their place, each named
``torch.ops.hybridgl.sam_<name>``:

  layer_norm           LN(x) of the [N, H, W, D] grid, written in the layout
                       of windows of ``window`` (pad rows zero) or on the grid
  qkv_heads            y + b of the qkv product as q, k, v in K1/K2's
                       [B*H, S, hd] layout, and the f32 rel-pos terms rel_h,
                       rel_w from the rounded q and the prepared tables
  merge_heads          K1/K2's [B*H, S, hd] output as [B, S, D]
  residual_layer_norm  x' = x + (y + b), y read in the layout of windows of
                       ``y_window`` (the out-projection's, or the grid), and
                       LN(x') in the layout of windows of ``window``
  residual_add         x + (y + b)                       (the last block's residual)
  bias_gelu            exact GELU(h + b)

``y`` and ``h`` are outputs of matrix products and ``b`` their biases, so
each operator ends where a product ends. A block runs five of them around
its four products and its attention kernel: ``qkv_heads``, ``merge_heads``,
``residual_layer_norm`` after the out-projection (with ln_2), ``bias_gelu``,
and ``residual_layer_norm`` after the MLP with the next block's ln_1 in that
block's layout (``residual_add`` after the last block); ``layer_norm`` once
before the first block.

Each has a plain version here, ``reference_<name>``, which is the sequence
of PyTorch operations the encoder ran before (its CPU implementation), and
a CUDA one that launches the kernel. On the card the bias adds, residuals,
window partition and unpartition, head split, merge and GELU equal the plain
sequence bit for bit: they round where PyTorch's operations round. LayerNorm
keeps the plain version's f32 steps but sums its mean and variance in a
warp's shuffle order, so an output may lie one rounding step from the plain
one; the rel-pos terms are f32 dot products summed in another order than the
plain einsums'.

The kernels take bf16 or f32 activations, every activation, bias and
LayerNorm parameter of a call in one dtype (the rel-pos tables f32), with D
a multiple of 8 up to 1280 for the row kernels, a head dim a multiple of 8,
a window or grid side up to 64, contiguous tensors and 16-byte aligned
data; the widths are read from the inputs. On a CUDA tensor each operator
launches its kernel or raises, as every kernel wrapper of the port does, and
``wrapper.launches`` counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, _ops

MAX_WIDTH = 1280  # the row kernel keeps a row in one warp's registers: 10 vectors of 16 bytes a lane
MAX_GRID = 64  # the qkv kernel's window or grid side
SMEM_FLOATS = 12288  # the qkv kernel stages a table row and a token row in 48 KB: 2 G (hd + 1) floats
DTYPES = (torch.bfloat16, torch.float32)
LN_EPS = 1e-6  # build_sam.py uses LayerNorm(eps=1e-6) throughout the encoder


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> [B*nW, win, win, C] with zero padding (image_encoder.py:243-264)."""
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(wins: torch.Tensor, window: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    C = wins.shape[-1]
    B = wins.shape[0] // ((Hp // window) * (Wp // window))
    x = wins.reshape(B, Hp // window, Wp // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def windowed_shape(shape, window: int):
    """The shape of an [N, H, W, D] grid in the layout of windows of ``window`` (0: the grid's own)."""
    N, H, W, D = shape
    if not window:
        return (N, H, W, D)
    return (N * (-(-H // window)) * (-(-W // window)), window, window, D)


def reference_layer_norm(x, scale, bias, window: int = 0, eps: float = LN_EPS):
    """LayerNorm over the last axis, computed in f32, returned in x's dtype;
    partitioned into windows of ``window`` after it (0: none)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = ((x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)
    return window_partition(y, window)[0] if window else y


def reference_qkv_heads(y, b, rel_tab_h, rel_tab_w, num_heads: int):
    """y + b as q, k, v [B*H, S, hd], and the two rank-G bias terms from the
    unscaled q in f32: rel_h[b, (qh, qw), kh] = q[b, qh, qw] . Rh[qh, kh],
    likewise rel_w (``rel_tab_*``: [G, G, hd] f32, S = G^2)."""
    B, S, D3 = y.shape
    D = D3 // 3
    hd = D // num_heads
    G = rel_tab_h.shape[0]
    qkv = y + b

    def heads(t):  # [B, S, D] -> [B*H, S, hd]
        return t.reshape(B, S, num_heads, hd).transpose(1, 2).reshape(B * num_heads, S, hd).contiguous()

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    q6 = q.float().reshape(B * num_heads, G, G, hd)
    rel_h = torch.einsum("bhwc,hkc->bhwk", q6, rel_tab_h).reshape(B * num_heads, S, G)
    rel_w = torch.einsum("bhwc,wkc->bhwk", q6, rel_tab_w).reshape(B * num_heads, S, G)
    return q, k, v, rel_h.contiguous(), rel_w.contiguous()


def reference_merge_heads(ctx, n: int):
    """[n*H, S, hd] -> [n, S, H*hd]."""
    NH, S, hd = ctx.shape
    H = NH // n
    return ctx.reshape(n, H, S, hd).transpose(1, 2).clone(memory_format=torch.contiguous_format).reshape(n, S, H * hd)


def reference_residual_layer_norm(x, y, b, scale, bias, y_window: int, window: int, eps: float = LN_EPS):
    """x' = x + (y + b) on x's [N, H, W, D] grid, y in the layout of windows
    of ``y_window`` (0: the grid), and LN(x') partitioned into windows of
    ``window`` (0: none)."""
    N, H, W, D = x.shape
    t = y + b
    if y_window:
        pad_hw = tuple(-(-s // y_window) * y_window for s in (H, W))
        t = window_unpartition(t.reshape(-1, y_window, y_window, D), y_window, pad_hw, (H, W))
    x = x + t.reshape(x.shape)
    return x, reference_layer_norm(x, scale, bias, window, eps)


def reference_residual_add(x, y, b):
    return x + (y + b)


def reference_bias_gelu(h, b):
    return F.gelu(h + b, approximate="none")


def _require(op: str, ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"sam_glue.{op}: {what}")


def _check(op: str, acts, vectors, floats=()):
    """Raise unless the kernels take the call: ``acts`` (activations) and
    ``vectors`` ({name: (tensor, length)}: biases, LayerNorm params) in one
    dtype, bf16 or f32, ``floats`` f32, all contiguous, on one device and
    16-byte aligned."""
    tensors = [*acts, *(t for t, _ in vectors.values())]
    dtype = acts[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"sam_glue.{op}: every tensor bf16 or every tensor f32, got {[t.dtype for t in tensors]}")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"sam_glue.{op}: the rel-pos tables f32, got {[t.dtype for t in floats]}")
    tensors += list(floats)
    _require(op, all(t.device == acts[0].device for t in tensors), "tensors on more than one device")
    for name, (t, n) in vectors.items():
        _require(op, t.shape == (n,), f"{name} of shape {tuple(t.shape)}, not ({n},)")
    _require(op, all(t.numel() for t in acts), "empty activations")
    _require(op, all(t.is_contiguous() for t in tensors), "non-contiguous tensors")
    _require(op, all(t.data_ptr() % 16 == 0 for t in tensors), "data not 16-byte aligned")


def _f32(t) -> int:
    return int(t.dtype == torch.float32)


def _check_grid(op: str, x, window: int):
    _require(op, x.dim() == 4, f"x of shape {tuple(x.shape)}: the [N, H, W, D] token grid")
    D = x.shape[-1]
    _require(op, D % 8 == 0 and 8 <= D <= MAX_WIDTH, f"width {D}: a multiple of 8 up to {MAX_WIDTH}")
    _require(op, window >= 0, f"window {window}")


def _rows(op: str, x, y, b, scale, bias, y_window: int, window: int, eps: float, want_ln: bool):
    """Launch the row kernel over x's grid; returns (x', LN) as it writes them."""
    N, H, W, D = x.shape
    x_out = torch.empty_like(x) if y is not None else None
    ln_out = torch.empty(windowed_shape(x.shape, window), dtype=x.dtype, device=x.device) if want_ln else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = _build.library().hgl_sam_rows(
        _f32(x), x.data_ptr(), ptr(y), ptr(b), ptr(scale), ptr(bias), ptr(x_out), ptr(ln_out), N, H, W, D,
        y_window, window, float(eps), _build.stream_handle(x.device))
    _build.check(code, op)
    return x_out, ln_out


def _launch_layer_norm(x, scale, bias, window: int, eps: float):
    _check_grid("layer_norm", x, window)
    D = x.shape[-1]
    _check("layer_norm", [x], {"scale": (scale, D), "bias": (bias, D)})
    out = _rows("layer_norm", x, None, None, scale, bias, 0, window, eps, True)[1]
    layer_norm.launches += 1
    return out


def _launch_residual_layer_norm(x, y, b, scale, bias, y_window: int, window: int, eps: float):
    op = "residual_layer_norm"
    _check_grid(op, x, window)
    _require(op, y_window >= 0, f"y_window {y_window}")
    D = x.shape[-1]
    want = windowed_shape(x.shape, y_window)
    _require(op, y.shape[-1] == D and y.numel() == want[0] * want[1] * want[2] * D,
             f"y of shape {tuple(y.shape)}: the rows of {want}")
    _check(op, [x, y], {"b": (b, D), "scale": (scale, D), "bias": (bias, D)})
    out = _rows(op, x, y, b, scale, bias, y_window, window, eps, True)
    residual_layer_norm.launches += 1
    return out


def _launch_residual_add(x, y, b):
    op = "residual_add"
    _check_grid(op, x, 0)
    _require(op, y.shape == x.shape, f"y of shape {tuple(y.shape)}, x {tuple(x.shape)}")
    _check(op, [x, y], {"b": (b, x.shape[-1])})
    out = _rows(op, x, y, b, None, None, 0, 0, 0.0, False)[0]
    residual_add.launches += 1
    return out


def _launch_qkv_heads(y, b, rel_tab_h, rel_tab_w, num_heads: int):
    op = "qkv_heads"
    _require(op, y.dim() == 3 and y.shape[2] % 3 == 0, f"y of shape {tuple(y.shape)}: [B, S, 3 D]")
    B, S, D3 = y.shape
    D, H = D3 // 3, num_heads
    _require(op, H >= 1 and D % H == 0 and (D // H) % 8 == 0, f"{D} not split into {H} heads of a multiple of 8")
    hd = D // H
    G = rel_tab_h.shape[0]
    _require(op, rel_tab_h.shape == (G, G, hd) and rel_tab_w.shape == (G, G, hd) and S == G * G,
             f"tables {tuple(rel_tab_h.shape)} {tuple(rel_tab_w.shape)} for S = {S}, head dim {hd}: "
             f"[G, G, hd] with S = G^2")
    _require(op, G <= MAX_GRID and 2 * G * (hd + 1) <= SMEM_FLOATS,
             f"grid side {G} at head dim {hd}: at most {MAX_GRID}, 2 G (hd + 1) <= {SMEM_FLOATS}")
    _check(op, [y], {"b": (b, D3)}, (rel_tab_h, rel_tab_w))
    q, k, v = (torch.empty((B * H, S, hd), dtype=y.dtype, device=y.device) for _ in range(3))
    rel_h, rel_w = (torch.empty((B * H, S, G), dtype=torch.float32, device=y.device) for _ in range(2))
    code = _build.library().hgl_sam_qkv_rel(
        _f32(y), y.data_ptr(), b.data_ptr(), rel_tab_h.data_ptr(), rel_tab_w.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), B, G, D, H, _build.stream_handle(y.device))
    _build.check(code, op)
    qkv_heads.launches += 1
    return q, k, v, rel_h, rel_w


def _launch_merge_heads(ctx, n: int):
    op = "merge_heads"
    _require(op, ctx.dim() == 3 and n >= 1 and ctx.shape[0] % n == 0, f"ctx of shape {tuple(ctx.shape)}, {n} streams")
    NH, S, hd = ctx.shape
    H = NH // n
    _require(op, hd % 8 == 0, f"head dim {hd}: a multiple of 8")
    _check(op, [ctx], {})
    out = torch.empty((n, S, H * hd), dtype=ctx.dtype, device=ctx.device)
    code = _build.library().hgl_sam_merge_heads(_f32(ctx), ctx.data_ptr(), out.data_ptr(), n, S, H * hd, H,
                                                _build.stream_handle(ctx.device))
    _build.check(code, op)
    merge_heads.launches += 1
    return out


def _launch_bias_gelu(h, b):
    op = "bias_gelu"
    F_ = h.shape[-1]
    _require(op, F_ % 8 == 0, f"width {F_}: a multiple of 8")
    _check(op, [h], {"b": (b, F_)})
    out = torch.empty_like(h)
    code = _build.library().hgl_sam_bias_gelu(_f32(h), h.data_ptr(), b.data_ptr(), out.data_ptr(), h.numel() // F_,
                                              F_, _build.stream_handle(h.device))
    _build.check(code, op)
    bias_gelu.launches += 1
    return out


def _like(x, *_):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _fake_layer_norm(x, scale, bias, window, eps):
    return x.new_empty(windowed_shape(x.shape, window))


def _fake_residual_layer_norm(x, y, b, scale, bias, y_window, window, eps):
    return _like(x), x.new_empty(windowed_shape(x.shape, window))


def _fake_qkv_heads(y, b, rel_tab_h, rel_tab_w, num_heads):
    B, S, D3 = y.shape
    BH, G = B * num_heads, rel_tab_h.shape[0]
    heads = tuple(y.new_empty((BH, S, D3 // 3 // num_heads)) for _ in range(3))
    return (*heads, *(y.new_empty((BH, S, G), dtype=torch.float32) for _ in range(2)))


def _fake_merge(ctx, n):
    NH, S, hd = ctx.shape
    return ctx.new_empty((n, S, NH // n * hd))


_ln = _ops.define("sam_layer_norm(Tensor x, Tensor scale, Tensor bias, int window, float eps) -> Tensor",
                  reference_layer_norm, _launch_layer_norm, _fake_layer_norm)
_heads = _ops.define(
    "sam_qkv_heads(Tensor y, Tensor b, Tensor rel_tab_h, Tensor rel_tab_w, int num_heads) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    reference_qkv_heads, _launch_qkv_heads, _fake_qkv_heads)
_merge = _ops.define("sam_merge_heads(Tensor ctx, int n) -> Tensor", reference_merge_heads, _launch_merge_heads,
                     _fake_merge)
_res_ln = _ops.define(
    "sam_residual_layer_norm(Tensor x, Tensor y, Tensor b, Tensor scale, Tensor bias, int y_window, int window, "
    "float eps) -> (Tensor, Tensor)",
    reference_residual_layer_norm, _launch_residual_layer_norm, _fake_residual_layer_norm)
_res = _ops.define("sam_residual_add(Tensor x, Tensor y, Tensor b) -> Tensor", reference_residual_add,
                   _launch_residual_add, _like)
_gelu = _ops.define("sam_bias_gelu(Tensor h, Tensor b) -> Tensor", reference_bias_gelu, _launch_bias_gelu, _like)


def layer_norm(x, scale, bias, window: int = 0, eps: float = LN_EPS):
    """LN(x) of the [N, H, W, D] grid in the layout of windows of ``window``
    (``torch.ops.hybridgl.sam_layer_norm``)."""
    return _ln(x, scale, bias, int(window), float(eps))


def qkv_heads(y, b, rel_tab_h, rel_tab_w, num_heads: int):
    """[B, S, 3D] qkv product + bias -> q, k, v [B*H, S, hd] and rel_h, rel_w
    [B*H, S, G] f32 (``torch.ops.hybridgl.sam_qkv_heads``)."""
    return _heads(y, b, rel_tab_h, rel_tab_w, int(num_heads))


def merge_heads(ctx, n: int):
    """[n*H, S, hd] -> [n, S, H*hd] (``torch.ops.hybridgl.sam_merge_heads``)."""
    return _merge(ctx, int(n))


def residual_layer_norm(x, y, b, scale, bias, y_window: int, window: int, eps: float = LN_EPS):
    """(x + (y + b), its LayerNorm in the layout of windows of ``window``), y
    in that of ``y_window`` (``torch.ops.hybridgl.sam_residual_layer_norm``)."""
    return _res_ln(x, y, b, scale, bias, int(y_window), int(window), float(eps))


def residual_add(x, y, b):
    """x + (y + b) (``torch.ops.hybridgl.sam_residual_add``)."""
    return _res(x, y, b)


def bias_gelu(h, b):
    """GELU(h + b), the exact erf form (``torch.ops.hybridgl.sam_bias_gelu``)."""
    return _gelu(h, b)


for _wrapper in (layer_norm, qkv_heads, merge_heads, residual_layer_norm, residual_add, bias_gelu):
    _wrapper.launches = 0
