"""Bilinear sampling / resize primitives (port of hybridgl_tpu/kernels/resize.py).

Same conventions as the reference: half-pixel source coordinates without
antialiasing (torch ``F.interpolate(mode='bilinear', align_corners=False)``)
for the gather forms, and dense weight matrices for the antialiased and the
composed two-stage resizes. The source or destination extent of a padded
frame may be a per-image number, so one code path serves every image size.
The weight-matrix math is ported as written; ``F.interpolate`` is not used.
"""

from __future__ import annotations

import torch


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _src_coords(out_size: int, src_size, device, dtype=torch.float32):
    i = torch.arange(out_size, dtype=dtype, device=device)
    src = torch.as_tensor(src_size, dtype=dtype, device=device)
    c = (i + 0.5) * (src / out_size) - 0.5
    return torch.clamp(c, min=torch.zeros((), dtype=dtype, device=device), max=src - 1.0)


def resize_bilinear(img: torch.Tensor, out_hw, src_hw=None, axis: int = 0) -> torch.Tensor:
    """Bilinear resize of axes (axis, axis+1) of ``img``; only the valid
    ``src_hw`` = (h, w) corner is sampled when given (reference :31)."""
    H, W = img.shape[axis], img.shape[axis + 1]
    oh, ow = out_hw
    src_h, src_w = (H, W) if src_hw is None else src_hw
    dev = img.device
    cy = _src_coords(oh, src_h, dev)
    cx = _src_coords(ow, src_w, dev)
    y0 = torch.floor(cy).long()
    x0 = torch.floor(cx).long()
    y1 = torch.clamp(y0 + 1, max=int(src_h) - 1)
    x1 = torch.clamp(x0 + 1, max=int(src_w) - 1)
    floating = img.is_floating_point()
    wdt = img.dtype if floating else torch.float32
    wy = (cy - y0).to(wdt)
    wx = (cx - x0).to(wdt)
    compute = img if floating else img.float()

    top = compute.index_select(axis, y0)
    bot = compute.index_select(axis, y1)
    trail = (1,) * (img.ndim - axis - 2)
    wxb = wx.reshape((1,) * axis + (1, ow) + trail)

    def lerp_rows(rows):
        left = rows.index_select(axis + 1, x0)
        right = rows.index_select(axis + 1, x1)
        return left + (right - left) * wxb

    top = lerp_rows(top)
    bot = lerp_rows(bot)
    wyb = wy.reshape((1,) * axis + (oh, 1) + trail)
    return top + (bot - top) * wyb


def resize_bilinear_batched(imgs: torch.Tensor, out_hw, src_hw=None) -> torch.Tensor:
    """:func:`resize_bilinear` over a leading batch axis ([N, H, W, ...])."""
    return resize_bilinear(imgs, out_hw, src_hw, axis=1)


def place_valid_region(img: torch.Tensor, src_hw, out_frame, dst_hw) -> torch.Tensor:
    """Resize img[:src_h, :src_w] to (dst_h, dst_w) at the origin of a
    zero-padded (OH, OW) frame (reference :91): :func:`place_region` with
    both origins at (0, 0)."""
    return place_region(img, src_hw, out_frame, (0, 0), dst_hw)


def sample_region(img: torch.Tensor, src_origin, src_hw, out_hw) -> torch.Tensor:
    """Bilinear-resize img[y0:y0+sh, x0:x0+sw] to (OH, OW) (reference :142)."""
    dev = img.device

    def coords(n, o, s):
        o, s = _f32(o, dev), _f32(s, dev)
        i = torch.arange(n, dtype=torch.float32, device=dev)
        c = o + torch.minimum(torch.clamp((i + 0.5) * (s / n) - 0.5, min=0.0), s - 1.0)
        lo = torch.floor(c).long()
        return lo, torch.minimum(lo + 1, (o + s).long() - 1), c - lo

    ylo, yhi, wy = coords(out_hw[0], src_origin[0], src_hw[0])
    xlo, xhi, wx = coords(out_hw[1], src_origin[1], src_hw[1])
    compute = img if img.is_floating_point() else img.float()
    trail = (1,) * (img.ndim - 2)
    wxb = wx.reshape((1, out_hw[1]) + trail)

    def lerp_rows(rows):
        left = rows.index_select(1, xlo)
        return left + (rows.index_select(1, xhi) - left) * wxb

    top = lerp_rows(compute.index_select(0, ylo))
    bot = lerp_rows(compute.index_select(0, yhi))
    return top + (bot - top) * wy.reshape((out_hw[0], 1) + trail)


def place_region(img: torch.Tensor, src_hw, out_frame, dst_origin, dst_hw, fill=0.0, src_origin=(0, 0)):
    """Resize img[sy0:sy0+sh, sx0:sx0+sw] to (dh, dw) placed at (y0, x0) of a
    fill-padded (OH, OW) frame (reference :187): multicrop AMG cuts each crop
    from the canonical frame and long-side-resizes it with this."""
    OH, OW = out_frame
    dev = img.device
    y0, x0, dh, dw, sh, sw, sy0, sx0 = (
        _f32(v, dev) for v in (*dst_origin, *dst_hw, *src_hw, *src_origin)
    )

    def coords(n, o, d, s, so):
        i = torch.arange(n, dtype=torch.float32, device=dev)
        c = so + torch.minimum(torch.clamp((i - o + 0.5) * (s / d) - 0.5, min=0.0), s - 1.0)
        lo = torch.floor(c).long()
        hi = torch.minimum(lo + 1, (so + s).long() - 1)
        return i, lo, hi, c - lo

    i, ylo, yhi, wy = coords(OH, y0, dh, sh, sy0)
    j, xlo, xhi, wx = coords(OW, x0, dw, sw, sx0)
    compute = img if img.is_floating_point() else img.float()
    trail = (1,) * (img.ndim - 2)
    wxb = wx.reshape((1, OW) + trail)

    def lerp_rows(rows):
        left = rows.index_select(1, xlo)
        return left + (rows.index_select(1, xhi) - left) * wxb

    top = lerp_rows(compute.index_select(0, ylo))
    bot = lerp_rows(compute.index_select(0, yhi))
    out = top + (bot - top) * wy.reshape((OH, 1) + trail)
    inside = ((i >= y0) & (i < y0 + dh))[:, None] & ((j >= x0) & (j < x0 + dw))[None, :]
    return torch.where(inside.reshape((OH, OW) + trail), out, torch.as_tensor(fill, dtype=out.dtype, device=dev))


def _resample_weights(out_frame: int, in_frame: int, in_extent, out_extent, antialias: bool, device):
    """Dense [out_frame, in_frame] 1-D resampling matrix (reference :247)."""
    i = torch.arange(out_frame, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(in_frame, dtype=torch.float32, device=device)[None, :]
    in_e = _f32(in_extent, device)
    out_e = _f32(out_extent, device)
    scale = in_e / out_e
    filt_scale = torch.clamp(scale, min=1.0) if antialias else _f32(1.0, device)
    center = (i + 0.5) * scale
    x = (j + 0.5 - center) / filt_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    w = torch.where(j < in_e, w, 0.0)
    w = torch.where(i < out_e, w, 0.0)
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)


def resize_antialias(img: torch.Tensor, out_hw, antialias: bool = True) -> torch.Tensor:
    """torchvision ``Resize(antialias=True)``-exact resize of [H, W(, C)] (reference :281)."""
    return place_valid_region_antialias(img, out_hw, out_hw, antialias)


def place_valid_region_antialias(img: torch.Tensor, out_frame, dst_hw, antialias: bool = True):
    """Antialiased resize of a full [H, W(, C)] map into the (dst_h, dst_w)
    corner of a zero-padded frame (reference :297)."""
    H, W = img.shape[0], img.shape[1]
    OH, OW = out_frame
    wy = _resample_weights(OH, H, H, dst_hw[0], antialias, img.device)
    wx = _resample_weights(OW, W, W, dst_hw[1], antialias, img.device)
    compute = img if img.is_floating_point() else img.float()
    if compute.ndim == 2:
        return wy @ compute @ wx.T
    return torch.einsum("oh,hwc,pw->opc", wy, compute, wx)


def _composed_axis_weights(out_frame: int, n_src: int, mid_frame: int, mid_extent, dst_origin, dst_extent, device="cpu"):
    """Dense [out_frame, n_src] matrix composing the two-stage bilinear chain
    along one axis: n_src -> mid_frame full-frame upscale, then the first
    mid_extent samples -> a dst_extent window at dst_origin (reference :320;
    the composition is exact)."""
    mid_e = _f32(mid_extent, device)
    i = torch.arange(out_frame, dtype=torch.float32, device=device)
    c2 = (i - _f32(dst_origin, device) + 0.5) * (mid_e / _f32(dst_extent, device)) - 0.5
    c2 = torch.minimum(torch.clamp(c2, min=0.0), mid_e - 1.0)
    f = torch.floor(c2)
    wy = (c2 - f)[:, None]
    j = torch.arange(n_src, dtype=torch.float32, device=device)[None, :]
    scale1 = n_src / mid_frame
    rows = torch.zeros((out_frame, n_src), dtype=torch.float32, device=device)
    for tap, w in ((f, 1.0 - wy), (torch.minimum(f + 1.0, mid_e - 1.0), wy)):
        g = torch.clamp((tap + 0.5) * scale1 - 0.5, min=0.0, max=n_src - 1.0)[:, None]
        gf = torch.floor(g)
        wg = g - gf
        rows = rows + w * (torch.where(j == gf, 1.0 - wg, 0.0) + torch.where(j == gf + 1.0, wg, 0.0))
    return rows


def place_two_stage(low, mid_frame: int, mid_hw, out_frame, dst_origin, dst_hw, fill=0.0):
    """[B, n, n] low-res maps -> [B, OH, OW]: upscale to the mid frame, crop
    its valid (rh, rw) corner and place it as a (dh, dw) window at
    dst_origin, as two batched matmuls (reference :370)."""
    OH, OW = out_frame
    dev = low.device
    Wy = _composed_axis_weights(OH, low.shape[-2], mid_frame, mid_hw[0], dst_origin[0], dst_hw[0], dev)
    Wx = _composed_axis_weights(OW, low.shape[-1], mid_frame, mid_hw[1], dst_origin[1], dst_hw[1], dev)
    compute = low if low.is_floating_point() else low.float()
    tmp = torch.einsum("brc,pc->brp", compute, Wx)
    out = torch.einsum("or,brp->bop", Wy, tmp)
    i = torch.arange(OH, dtype=torch.float32, device=dev)
    j = torch.arange(OW, dtype=torch.float32, device=dev)
    y0 = _f32(dst_origin[0], dev)
    x0 = _f32(dst_origin[1], dev)
    inside = (
        ((i >= y0) & (i < y0 + _f32(dst_hw[0], dev)))[:, None]
        & ((j >= x0) & (j < x0 + _f32(dst_hw[1], dev)))[None, :]
    )
    return torch.where(inside[None], out, torch.as_tensor(fill, dtype=out.dtype, device=dev))


def valid_mask(frame, hw, device="cpu") -> torch.Tensor:
    """Boolean [H, W] mask of the valid (h, w) corner of a padded frame."""
    H, W = frame
    i = torch.arange(H, device=device)[:, None]
    j = torch.arange(W, device=device)[None, :]
    return (i < int(hw[0])) & (j < int(hw[1]))
