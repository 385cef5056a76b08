"""The glue of the CLIP residual block, fused (``csrc/clip_glue.cu``).

Replaces no TPU kernel: the JAX package leaves the elementwise work around
the block's matrix products and K6 to XLA, which fuses it. In the port each
of those PyTorch operations was a kernel of its own (LayerNorm about ten f32
passes), so the feature and sentence stages spent more time in them than in
their matrix products. Seven operators take their place, each named
``torch.ops.hybridgl.<name>``:

  layer_norm           LN(x) in f32, rounded once (x may be a strided row view)
  residual_add         x + (y + b)                      (a block's last residual)
  residual_layer_norm  x' = x + (y + b) and LN(x')      (after the out-projection
                                                         and the MLP: the next LayerNorm)
  inject_layer_norm    x' = 2 token_mask(x2, m) + x and LN(x')  (G2L's injection)
  qkv_heads            y + b as q, k, v in K6's [N*H, L, hd] layout
  merge_heads          K6's [N*H, L, hd] output as [N, L, D]
  bias_quick_gelu      QuickGELU(h + b)

``y`` is the output of a matrix product and ``b`` its bias, so each
operator ends where a product ends. Each has a plain version here,
``reference_<name>``, which is the sequence of PyTorch operations the model
code ran before (its CPU implementation), and a CUDA one that launches the
kernel. On the card the bias add, residual, injection, head split, merge
and QuickGELU equal the plain sequence bit for bit: they round where
PyTorch's operations round. LayerNorm keeps the plain version's f32 steps
but sums its mean and variance in a warp's shuffle order, so an output may
lie one rounding step from the plain one.

The kernels take bf16 or f32 tensors, every tensor of a call in one dtype
(the masks of the injection f32), with D (the row width; F for the
QuickGELU rows, hd for the heads) a multiple of 8, D <= 1024 for the row
kernels, contiguous rows (the LayerNorm's at one stride apart) and 16-byte
aligned data; the widths are read from the inputs. On a CUDA tensor each
operator launches its kernel or raises, as every kernel wrapper of the
port does, and ``wrapper.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from . import _build, _ops

MAX_WIDTH = 1024  # the row kernel keeps a row in one warp's registers: 8 groups of 4 values a lane
MODES = {"layer_norm": 0, "residual_add": 1, "residual_layer_norm": 2, "inject_layer_norm": 3}
DTYPES = (torch.bfloat16, torch.float32)
LN_EPS = 1e-5


def reference_layer_norm(x, scale, bias, eps: float = LN_EPS):
    """LayerNorm in f32 regardless of the activation dtype (clip/model.py:189-195)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def reference_residual_add(x, y, b):
    return x + (y + b)


def reference_residual_layer_norm(x, y, b, scale, bias, eps: float = LN_EPS):
    x = reference_residual_add(x, y, b)
    return x, reference_layer_norm(x, scale, bias, eps)


def reference_token_mask(x, masks):
    """Patch tokens [P, 1 + g^2, D] times the fractional mask [P, g, g] (or
    [P, g^2]) rounded to x's dtype; CLS kept."""
    m = masks.reshape(x.shape[0], -1, 1).to(x.dtype)
    return torch.cat([x[:, :1, :], x[:, 1:, :] * m], dim=1)


def reference_inject_layer_norm(x, x2, masks, scale, bias, eps: float = LN_EPS):
    """G2L's injection of the token-masked global stream ``x2`` into the
    local stream ``x`` (backbone.py:227-260), then the block's first LayerNorm."""
    x = 2.0 * reference_token_mask(x2, masks) + x
    return x, reference_layer_norm(x, scale, bias, eps)


def reference_qkv_heads(y, b, num_heads: int):
    N, L, D3 = y.shape
    D, H = D3 // 3, num_heads
    hd = D // H
    qkv = y + b
    q, k, v = (t.reshape(N, L, H, hd).transpose(1, 2).reshape(N * H, L, hd).contiguous() for t in qkv.split(D, dim=-1))
    return q, k, v


def reference_merge_heads(ctx, n: int):
    NH, L, hd = ctx.shape
    H = NH // n
    return ctx.reshape(n, H, L, hd).transpose(1, 2).clone(memory_format=torch.contiguous_format).reshape(n, L, H * hd)


def reference_bias_quick_gelu(h, b):
    x = h + b
    return x * torch.sigmoid(1.702 * x)


def _row_stride(x):
    """The element stride between the rows of ``x`` read as [rows, D] with
    contiguous rows (size-1 dims skipped), or None where no one stride does."""
    if x.dim() == 0 or x.stride(-1) != 1:
        return None
    stride = expected = None
    for size, st in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != expected:
            return None
        expected = st * size
    return x.shape[-1] if stride is None else stride


def _require(op: str, ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"clip_glue.{op}: {what}")


def _check(op: str, width: int, limit: int, acts, vectors, *, contiguous=True):
    """Raise unless the kernels take the call: ``acts`` (activations) and
    ``vectors`` ({name: (tensor, length)}: biases, LayerNorm params) in one
    dtype, bf16 or f32, on one device, 16-byte aligned; a width they read in
    16-byte vectors; contiguous activations where ``contiguous``."""
    tensors = [*acts, *(t for t, _ in vectors.values())]
    dtype = acts[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"clip_glue.{op}: every tensor bf16 or every tensor f32, got {[t.dtype for t in tensors]}")
    _require(op, all(t.device == acts[0].device for t in tensors), "tensors on more than one device")
    _require(op, width % 8 == 0 and 8 <= width <= limit, f"width {width}: a multiple of 8 up to {limit}")
    for name, (t, n) in vectors.items():
        _require(op, t.shape == (n,) and t.is_contiguous(), f"{name} of shape {tuple(t.shape)}, not ({n},)")
    _require(op, all(t.numel() for t in acts), "empty activations")
    _require(op, not contiguous or all(t.is_contiguous() for t in acts), "non-contiguous activations")
    _require(op, all(t.data_ptr() % 16 == 0 for t in tensors), "data not 16-byte aligned")


def _f32(t) -> int:
    return int(t.dtype == torch.float32)


def _rows(mode: str, x, x_stride: int, y, b, m, scale, bias, eps: float, want_x: bool, want_ln: bool):
    """Launch the row kernel over x's rows; returns the outputs it writes."""
    D = x.shape[-1]
    rows = x.numel() // D
    x_out = torch.empty(x.shape, dtype=x.dtype, device=x.device) if want_x else None
    ln_out = torch.empty(x.shape, dtype=x.dtype, device=x.device) if want_ln else None
    L = x.shape[1] if mode == "inject_layer_norm" else 1
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = _build.library().hgl_clip_rows(
        MODES[mode], _f32(x), x.data_ptr(), x_stride, ptr(y), ptr(b), ptr(m), ptr(scale), ptr(bias), ptr(x_out),
        ptr(ln_out), rows, D, L, float(eps), _build.stream_handle(x.device))
    _build.check(code, mode)
    return x_out, ln_out


def _launch_layer_norm(x, scale, bias, eps: float):
    D, stride = x.shape[-1], _row_stride(x)
    _check("layer_norm", D, MAX_WIDTH, [x], {"scale": (scale, D), "bias": (bias, D)}, contiguous=False)
    _require("layer_norm", stride is not None and stride * x.element_size() % 16 == 0,
             f"rows of shape {tuple(x.shape)} and strides {x.stride()} not one 16-byte multiple apart")
    out = _rows("layer_norm", x, stride, None, None, None, scale, bias, eps, False, True)[1]
    layer_norm.launches += 1
    return out


def _check_residual(op, x, y, b, ln=()):
    D = x.shape[-1]
    _require(op, y.shape == x.shape, f"y of shape {tuple(y.shape)}, x {tuple(x.shape)}")
    _check(op, D, MAX_WIDTH, [x, y], {"b": (b, D), **{k: (t, D) for k, t in zip(("scale", "bias"), ln)}})


def _launch_residual_add(x, y, b):
    _check_residual("residual_add", x, y, b)
    out = _rows("residual_add", x, x.shape[-1], y, b, None, None, None, 0.0, True, False)[0]
    residual_add.launches += 1
    return out


def _launch_residual_layer_norm(x, y, b, scale, bias, eps: float):
    _check_residual("residual_layer_norm", x, y, b, (scale, bias))
    out = _rows("residual_layer_norm", x, x.shape[-1], y, b, None, scale, bias, eps, True, True)
    residual_layer_norm.launches += 1
    return out


def _launch_inject_layer_norm(x, x2, masks, scale, bias, eps: float):
    op, D = "inject_layer_norm", x.shape[-1]
    _require(op, x.dim() == 3 and x.shape[1] >= 2 and x2.shape == x.shape,
             f"x of shape {tuple(x.shape)}, x2 {tuple(x2.shape)}: [P, 1 + g^2, D] both")
    m = masks.reshape(masks.shape[0], -1)
    _require(op, m.shape == (x.shape[0], x.shape[1] - 1) and m.dtype == torch.float32 and m.is_contiguous()
             and m.device == x.device, f"masks of shape {tuple(masks.shape)} and dtype {masks.dtype}: "
             f"[P, g, g] f32 contiguous on x's device")
    _check(op, D, MAX_WIDTH, [x, x2], {"scale": (scale, D), "bias": (bias, D)})
    out = _rows(op, x, D, x2, None, m, scale, bias, eps, True, True)
    inject_layer_norm.launches += 1
    return out


def _launch_qkv_heads(y, b, num_heads: int):
    op = "qkv_heads"
    _require(op, y.dim() == 3 and y.shape[2] % 3 == 0, f"y of shape {tuple(y.shape)}: [N, L, 3 D]")
    N, L, D3 = y.shape
    D, H = D3 // 3, num_heads
    _require(op, H >= 1 and D % H == 0, f"{D} not split into {H} heads")
    _check(op, D // H, D3, [y], {"b": (b, D3)})
    q, k, v = (torch.empty((N * H, L, D // H), dtype=y.dtype, device=y.device) for _ in range(3))
    code = _build.library().hgl_clip_qkv_heads(_f32(y), y.data_ptr(), b.data_ptr(), q.data_ptr(), k.data_ptr(),
                                               v.data_ptr(), N, L, D, H, _build.stream_handle(y.device))
    _build.check(code, op)
    qkv_heads.launches += 1
    return q, k, v


def _launch_merge_heads(ctx, n: int):
    op = "merge_heads"
    _require(op, ctx.dim() == 3 and n >= 1 and ctx.shape[0] % n == 0, f"ctx of shape {tuple(ctx.shape)}, {n} streams")
    NH, L, hd = ctx.shape
    H = NH // n
    _check(op, hd, hd, [ctx], {})
    out = torch.empty((n, L, H * hd), dtype=ctx.dtype, device=ctx.device)
    code = _build.library().hgl_clip_merge_heads(_f32(ctx), ctx.data_ptr(), out.data_ptr(), n, L, H * hd, H,
                                                 _build.stream_handle(ctx.device))
    _build.check(code, op)
    merge_heads.launches += 1
    return out


def _launch_bias_quick_gelu(h, b):
    F = h.shape[-1]
    _check("bias_quick_gelu", F, F, [h], {"b": (b, F)})
    out = torch.empty_like(h)
    code = _build.library().hgl_clip_bias_quick_gelu(_f32(h), h.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                     h.numel() // F, F, _build.stream_handle(h.device))
    _build.check(code, "bias_quick_gelu")
    bias_quick_gelu.launches += 1
    return out


def _like(x, *_):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _pair(x, *_):
    return _like(x), _like(x)


def _fake_heads(y, b, num_heads):
    N, L, D3 = y.shape
    shape = (N * num_heads, L, D3 // 3 // num_heads)
    return tuple(y.new_empty(shape) for _ in range(3))


def _fake_merge(ctx, n):
    NH, L, hd = ctx.shape
    return ctx.new_empty((n, L, NH // n * hd))


_ln = _ops.define("layer_norm(Tensor x, Tensor scale, Tensor bias, float eps) -> Tensor",
                  reference_layer_norm, _launch_layer_norm, _like)
_res = _ops.define("residual_add(Tensor x, Tensor y, Tensor b) -> Tensor",
                   reference_residual_add, _launch_residual_add, _like)
_res_ln = _ops.define(
    "residual_layer_norm(Tensor x, Tensor y, Tensor b, Tensor scale, Tensor bias, float eps) -> (Tensor, Tensor)",
    reference_residual_layer_norm, _launch_residual_layer_norm, _pair)
_inject = _ops.define(
    "inject_layer_norm(Tensor x, Tensor x2, Tensor masks, Tensor scale, Tensor bias, float eps) -> (Tensor, Tensor)",
    reference_inject_layer_norm, _launch_inject_layer_norm, _pair)
_heads = _ops.define("qkv_heads(Tensor y, Tensor b, int num_heads) -> (Tensor, Tensor, Tensor)",
                     reference_qkv_heads, _launch_qkv_heads, _fake_heads)
_merge = _ops.define("merge_heads(Tensor ctx, int n) -> Tensor", reference_merge_heads, _launch_merge_heads,
                     _fake_merge)
_gelu = _ops.define("bias_quick_gelu(Tensor h, Tensor b) -> Tensor", reference_bias_quick_gelu,
                    _launch_bias_quick_gelu, _like)


def layer_norm(x, scale, bias, eps: float = LN_EPS):
    """LN(x) over the last dim (``torch.ops.hybridgl.layer_norm``)."""
    return _ln(x, scale, bias, float(eps))


def residual_add(x, y, b):
    """x + (y + b) (``torch.ops.hybridgl.residual_add``)."""
    return _res(x, y, b)


def residual_layer_norm(x, y, b, scale, bias, eps: float = LN_EPS):
    """(x + (y + b), its LayerNorm) (``torch.ops.hybridgl.residual_layer_norm``)."""
    return _res_ln(x, y, b, scale, bias, float(eps))


def inject_layer_norm(x, x2, masks, scale, bias, eps: float = LN_EPS):
    """(2 token_mask(x2, masks) + x, its LayerNorm) (``torch.ops.hybridgl.inject_layer_norm``)."""
    return _inject(x, x2, masks, scale, bias, float(eps))


def qkv_heads(y, b, num_heads: int):
    """[N, L, 3D] in-projection output + bias -> q, k, v [N*H, L, hd] (``torch.ops.hybridgl.qkv_heads``)."""
    return _heads(y, b, int(num_heads))


def merge_heads(ctx, n: int):
    """[N*H, L, hd] -> [N, L, H*hd] (``torch.ops.hybridgl.merge_heads``)."""
    return _merge(ctx, int(n))


def bias_quick_gelu(h, b):
    """QuickGELU(h + b) (``torch.ops.hybridgl.bias_quick_gelu``)."""
    return _gelu(h, b)


for _wrapper in (layer_norm, residual_add, residual_layer_norm, inject_layer_norm, qkv_heads, merge_heads,
                 bias_quick_gelu):
    _wrapper.launches = 0
