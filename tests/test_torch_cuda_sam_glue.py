"""The SAM encoder block's fused glue (``csrc/sam_glue.cu``, ``kernels/sam_glue.py``)
on the card against its plain version, the PyTorch operations it replaces
run on the same CUDA tensors. Marked ``cuda``; each test skips where no CUDA
card is present. Run on a machine with a card:

    python -m pytest tests/test_torch_cuda_sam_glue.py -m cuda -q

Shapes: ViT-H's blocks (D = 1280, 16 heads of 80, window 14 over the 64 x 64
grid padded to 70 x 70: 25 windows of 196 an image; the global 4096 x 1280
grid; the 4096 x 5120 hidden state) at one and five images, in bf16 as the
main path runs them, and the small f32 geometries the card's parity checks
run (D = 64, 2 heads of 32, window 8 over a 32 grid; D = 32, 2 heads of 16,
window 3 over a 4 grid padded to 6).

The bias adds, residuals, window partition (pad rows zero) and unpartition,
head split, merge and GELU equal the plain sequence bit for bit; LayerNorm
lies within one rounding step (``tools/check_kernels.py:glue_matches``), at
most 1e-3 of the bf16 outputs a step away; the rel-pos terms within f32
rounding of the plain einsums (``sam_glue_matches``). A call the kernels do
not take raises. End to end, ViT-H's ``encode_image`` at full width in bf16
launches each operator its exact count (one ln_1, then five a block) and
lies within the encoder's bar of the same encoder with the glue patched to
its plain versions.
"""

import pytest
import torch

from hybridgl_tpu_torch.kernels import SAM_GLUE, kernel_wrappers, launch_counts, sam_glue
from hybridgl_tpu_torch.tools.check_kernels import sam_glue_matches

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
# (images, width, heads, window, grid side, dtype)
GEOMETRIES = [(1, 1280, 16, 14, 64, BF16), (5, 1280, 16, 14, 64, BF16), (2, 64, 2, 8, 32, F32), (3, 32, 2, 3, 4, F32),
              (1, 1280, 16, 14, 64, F32)]
GEOMETRY_IDS = ["vit_h", "vit_h_5_images", "small_f32", "tiny_padded_f32", "vit_h_f32"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _r(g, *shape, std=1.0, mean=0.0, dtype=BF16):
    return (torch.randn(shape, generator=g, device=g.device) * std + mean).to(dtype)


def _ln(g, D, dtype):
    return _r(g, D, std=0.1, mean=1.0, dtype=dtype), _r(g, D, std=0.1, dtype=dtype)


def held(name, got, want):
    got, want = ([t] if isinstance(t, torch.Tensor) else list(t) for t in (got, want))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert sam_glue_matches(name, i, a, b), (name, i, float((a.float() - b.float()).abs().max()))
        if a.dtype == BF16 and name.endswith("layer_norm"):
            assert int((a != b).sum()) <= 1e-3 * a.numel()


class Counted:
    """The launches a block of calls adds to one wrapper."""

    def __init__(self, name):
        self.fn = kernel_wrappers()[name]

    def __enter__(self):
        self.before = self.fn.launches
        return self

    def __exit__(self, *exc):
        self.added = self.fn.launches - self.before


def _nw(grid, win):
    return (-(-grid // win)) ** 2


@pytest.mark.parametrize("window", [14, 0], ids=["windows", "grid"])
@pytest.mark.parametrize("N,D,H,win,grid,dtype", GEOMETRIES, ids=GEOMETRY_IDS)
def test_layer_norm_into_windows(dev, N, D, H, win, grid, dtype, window):
    """ln_1 of the first block: the grid's LayerNorm written into the window
    layout, pad rows zero (F.pad after the LayerNorm), or on the grid."""
    window = win if window else 0
    g = torch.Generator(device=dev).manual_seed(1)
    x = _r(g, N, grid, grid, D, std=2.0, mean=0.5, dtype=dtype)
    scale, bias = _ln(g, D, dtype)
    with Counted("sam_layer_norm") as c:
        got = sam_glue.layer_norm(x, scale, bias, window)
    want = sam_glue.reference_layer_norm(x, scale, bias, window)
    torch.cuda.synchronize()
    held("sam_layer_norm", got, want)
    if window and grid % window:
        pad = got.reshape(N, _nw(grid, window), window * window, D)[:, -1, -1]  # the last window's last row
        assert not pad.any()
    assert c.added == 1


@pytest.mark.parametrize("block", ["windowed", "global"])
@pytest.mark.parametrize("N,D,H,win,grid,dtype", GEOMETRIES, ids=GEOMETRY_IDS)
def test_qkv_heads_and_rel_terms(dev, N, D, H, win, grid, dtype, block):
    """The qkv product + bias as K1/K2's q, k, v (bit for bit) and the two
    f32 rel-pos terms from the rounded q (f32 rounding)."""
    g = torch.Generator(device=dev).manual_seed(2)
    G = win if block == "windowed" else grid
    B = N * _nw(grid, win) if block == "windowed" else N
    y, b = _r(g, B, G * G, 3 * D, dtype=dtype), _r(g, 3 * D, std=0.5, dtype=dtype)
    tab_h, tab_w = (torch.randn((G, G, D // H), generator=g, device=dev) * 0.2 for _ in range(2))
    with Counted("sam_qkv_heads") as c:
        got = sam_glue.qkv_heads(y, b, tab_h, tab_w, H)
    want = sam_glue.reference_qkv_heads(y, b, tab_h, tab_w, H)
    torch.cuda.synchronize()
    held("sam_qkv_heads", got, want)
    assert c.added == 1


@pytest.mark.parametrize("N,D,H,win,grid,dtype", GEOMETRIES, ids=GEOMETRY_IDS)
def test_merge_heads(dev, N, D, H, win, grid, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    B = N * _nw(grid, win)
    ctx = _r(g, B * H, win * win, D // H, dtype=dtype)
    with Counted("sam_merge_heads") as c:
        got = sam_glue.merge_heads(ctx, B)
    held("sam_merge_heads", got, sam_glue.reference_merge_heads(ctx, B))
    assert c.added == 1


@pytest.mark.parametrize("route", ["out_projection_from_windows", "global_out_projection", "mlp_into_windows",
                                   "mlp_onto_grid"])
@pytest.mark.parametrize("N,D,H,win,grid,dtype", GEOMETRIES, ids=GEOMETRY_IDS)
def test_residual_layer_norm(dev, N, D, H, win, grid, dtype, route):
    """x + (y + b) on the grid with y read from the out-projection's window
    layout (unpartition and crop) or the grid, and the LayerNorm written on
    the grid (ln_2) or into the next block's windows (ln_1)."""
    g = torch.Generator(device=dev).manual_seed(4)
    x, b = _r(g, N, grid, grid, D, dtype=dtype), _r(g, D, std=0.5, dtype=dtype)
    scale, bias = _ln(g, D, dtype)
    y_window, window = {"out_projection_from_windows": (win, 0), "global_out_projection": (0, 0),
                        "mlp_into_windows": (0, win), "mlp_onto_grid": (0, 0)}[route]
    y_shape = {"out_projection_from_windows": (N * _nw(grid, win), win * win, D),
               "global_out_projection": (N, grid * grid, D)}.get(route, (N, grid, grid, D))
    y = _r(g, *y_shape, std=2.0, dtype=dtype)
    with Counted("sam_residual_layer_norm") as c:
        got = sam_glue.residual_layer_norm(x, y, b, scale, bias, y_window, window)
    want = sam_glue.reference_residual_layer_norm(x, y, b, scale, bias, y_window, window)
    torch.cuda.synchronize()
    held("sam_residual_layer_norm", got, want)
    assert c.added == 1


@pytest.mark.parametrize("N,D,H,win,grid,dtype", GEOMETRIES, ids=GEOMETRY_IDS)
def test_residual_add_and_bias_gelu(dev, N, D, H, win, grid, dtype):
    """The last block's residual and the MLP's bias + exact GELU over the
    4 D-wide hidden state."""
    g = torch.Generator(device=dev).manual_seed(5)
    x, y, b = _r(g, N, grid, grid, D, dtype=dtype), _r(g, N, grid, grid, D, std=3.0, dtype=dtype), _r(g, D, dtype=dtype)
    h, b4 = _r(g, N, grid, grid, 4 * D, std=3.0, dtype=dtype), _r(g, 4 * D, std=0.5, dtype=dtype)
    with Counted("sam_residual_add") as c1, Counted("sam_bias_gelu") as c2:
        got_x, got_h = sam_glue.residual_add(x, y, b), sam_glue.bias_gelu(h, b4)
    torch.cuda.synchronize()
    held("sam_residual_add", got_x, sam_glue.reference_residual_add(x, y, b))
    held("sam_bias_gelu", got_h, sam_glue.reference_bias_gelu(h, b4))
    assert c1.added == c2.added == 1


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    x, b = _r(g, 1, 8, 8, 64), _r(g, 64)
    scale, bias = _ln(g, 64, BF16)
    tab, big = torch.zeros((8, 8, 32), device=dev), torch.zeros((128, 128, 32), device=dev)
    bad = [
        lambda: sam_glue.layer_norm(x.float(), scale, bias, 4),                       # mixed dtypes
        lambda: sam_glue.layer_norm(x.half(), scale.half(), bias.half(), 4),          # fp16
        lambda: sam_glue.layer_norm(_r(g, 1, 8, 8, 1288), _r(g, 1288), _r(g, 1288), 4),  # wider than 1280
        lambda: sam_glue.layer_norm(x[..., :60], scale[:60], bias[:60], 4),           # width not a multiple of 8
        lambda: sam_glue.layer_norm(x.transpose(1, 2), scale, bias, 4),               # not contiguous
        lambda: sam_glue.layer_norm(x.reshape(64, 64), scale, bias, 4),               # not a grid
        lambda: sam_glue.residual_layer_norm(x, _r(g, 1, 8, 8, 64), b, scale, bias, 3, 0),  # y not in 3-windows
        lambda: sam_glue.residual_add(x, _r(g, 1, 8, 4, 64), b),                      # shapes differ
        lambda: sam_glue.qkv_heads(_r(g, 2, 64, 192), _r(g, 192), tab.bfloat16(), tab.bfloat16(), 2),  # bf16 tables
        lambda: sam_glue.qkv_heads(_r(g, 2, 60, 192), _r(g, 192), tab, tab, 2),       # S not G^2
        lambda: sam_glue.qkv_heads(_r(g, 2, 64, 192), _r(g, 192), tab, tab, 3),       # heads do not split 64
        lambda: sam_glue.qkv_heads(_r(g, 1, 128 * 128, 192), _r(g, 192), big, big, 2),  # grid side over 64
        lambda: sam_glue.merge_heads(_r(g, 6, 16, 32), 4),                            # streams do not divide
        lambda: sam_glue.bias_gelu(_r(g, 4, 12), _r(g, 12)),                          # width not a multiple of 8
        lambda: sam_glue.bias_gelu(_r(g, 4, 16), _r(g, 8)),                           # bias of another width
    ]
    before = launch_counts()
    for i, call in enumerate(bad):
        with pytest.raises((TypeError, ValueError)):
            call()
            pytest.fail(f"case {i} launched")
    assert launch_counts() == before


def test_encode_image_vit_h_counts_and_matches_the_plain_glue(dev, monkeypatch):
    """ViT-H at full width in bf16: one ln_1 and five glue launches a block,
    exactly (``chip_smoke.SAM_GLUE_LAUNCHES_PER_IMAGE``); the embedding within
    the encoder's bar (cos > 0.999) of the same encoder, same weights, with
    the six operators patched to their plain versions."""
    import chip_smoke
    from hybridgl_tpu_torch.core.config import sam_preset
    from hybridgl_tpu_torch.core.params import cast_tree, init_sam
    from hybridgl_tpu_torch.models.sam import image_encoder
    from hybridgl_tpu_torch.models.sam.image_encoder import encode_image, prepare_sam_params

    cfg = sam_preset("vit_h")
    gen = torch.Generator().manual_seed(0)
    params = init_sam(gen, cfg)
    for blk in params["encoder"]["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=gen) * 0.2
    enc = prepare_sam_params({"encoder": cast_tree(params["encoder"], BF16)}, cfg)["encoder"]
    enc = torch.utils._pytree.tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, enc)
    image = torch.randn((1, cfg.img_size, cfg.img_size, 3), generator=gen).to(dev)
    before = launch_counts()
    with torch.no_grad():
        fused = encode_image(enc, image, cfg)
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in launch_counts().items() if k in SAM_GLUE}
    assert added == chip_smoke.SAM_GLUE_LAUNCHES_PER_IMAGE
    plain = {name: getattr(sam_glue, f"reference_{name}") for name in
             ("layer_norm", "qkv_heads", "merge_heads", "residual_layer_norm", "residual_add", "bias_gelu")}
    for name, fn in plain.items():
        monkeypatch.setattr(image_encoder.sam_glue, name, fn)
    with torch.no_grad():
        want = encode_image(enc, image, cfg)
    f, w = fused.float().flatten(), want.float().flatten()
    cos = float(f @ w / (f.norm() * w.norm()))
    assert torch.isfinite(f).all() and cos > 0.999, cos
