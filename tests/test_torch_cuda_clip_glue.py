"""The CLIP block's fused glue (``csrc/clip_glue.cu``, ``kernels/clip_glue.py``)
on the card against its plain version, the PyTorch operations it replaces
run on the same CUDA tensors. Marked ``cuda``; each test skips where no CUDA
card is present. Run on a machine with a card:

    python -m pytest tests/test_torch_cuda_clip_glue.py -m cuda -q

Shapes: ViT-B/16's trunk at proposal buckets 8 and 64 (16 and 128 streams of
197 tokens, D = 768, 12 heads, MLP 3072), the text tower (77-token rows,
D = 512, 8 heads, MLP 2048) and GEM (785 tokens of 768), in bf16 as the main
path runs them and in f32.

The bias add, residual (the last block's residual alone included), G2L
injection (fractional masks, empty patches and the CLS row), head split,
merge and QuickGELU equal the plain sequence bit for bit: they round where
PyTorch's operations round. LayerNorm sums its mean and variance in a warp's
shuffle order, not in PyTorch's reduction order, and is held within one
rounding step of the plain output (``tools/check_kernels.py:glue_matches``),
with at most 1e-3 of the bf16 outputs a step away. A call the kernels do not
take raises. End to end, ViT-B/16 at full width with random weights: the G2L
features of ``fusion_features`` at bucket 32 and the text tower's features in
bf16, fused and with the seven operators patched to their plain versions,
are both held against the same model code in f32 with the plain versions
(TF32 off), under one limit set from both readings.
"""

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.kernels import GLUE, clip_glue, kernel_wrappers, launch_counts
from hybridgl_tpu_torch.tools.check_kernels import glue_matches

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
DTYPES = [BF16, F32]
DTYPE_IDS = ["bf16", "f32"]
# (streams, tokens, width, heads): the trunk at buckets 8 and 64, the text tower, GEM
ROWS = [(16, 197, 768, 12), (128, 197, 768, 12), (30, 77, 512, 8), (1, 785, 768, 12)]
ROW_IDS = ["trunk_bucket8", "trunk_bucket64", "text_tower", "gem"]
# the relative feature error against the f32 plain path that the bf16
# features of ViT-B/16 stay under, fused and plain: 1.5 times the larger
# reading of the two summation orders on the H100 (G2L at bucket 32: fused
# 0.00933, plain 0.00931; the text tower: 0.01010 both)
FEATURE_LIMIT = {"g2l": 0.014, "text": 0.015}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _r(g, *shape, std=1.0, mean=0.0, dtype=BF16):
    return (torch.randn(shape, generator=g, device=g.device) * std + mean).to(dtype)


def _ln(g, D, dtype=BF16):
    return _r(g, D, std=0.1, mean=1.0, dtype=dtype), _r(g, D, std=0.1, dtype=dtype)


def exact(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


def near(got, want):
    """A LayerNorm output: within one rounding step, and few steps away in bf16."""
    assert glue_matches("layer_norm", got, want)
    if got.dtype == BF16:
        assert int((got != want).sum()) <= 1e-3 * got.numel()


class Counted:
    """The launches a block of calls adds to one wrapper."""

    def __init__(self, name):
        self.fn = kernel_wrappers()[name]

    def __enter__(self):
        self.before = self.fn.launches
        return self

    def __exit__(self, *exc):
        self.added = self.fn.launches - self.before


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N,L,D,H", ROWS, ids=ROW_IDS)
def test_residual_layer_norm(dev, N, L, D, H, dtype):
    """After the out-projection and the MLP: x + (y + b) and its LayerNorm."""
    g = torch.Generator(device=dev).manual_seed(1)
    x, a = _r(g, N, L, D, dtype=dtype), _r(g, N, L, D, dtype=dtype)
    w, b = _r(g, D, D, std=D**-0.5, dtype=dtype), _r(g, D, std=0.5, dtype=dtype)
    y = a @ w
    scale, bias = _ln(g, D, dtype)
    with Counted("residual_layer_norm") as c:
        x_new, ln = clip_glue.residual_layer_norm(x, y, b, scale, bias)
    want_x, want_ln = clip_glue.reference_residual_layer_norm(x, y, b, scale, bias)
    torch.cuda.synchronize()
    exact(x_new, want_x)
    near(ln, want_ln)
    assert c.added == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N,L,D,H", ROWS, ids=ROW_IDS)
def test_residual_add_the_last_blocks_form(dev, N, L, D, H, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    x, y, b = _r(g, N, L, D, dtype=dtype), _r(g, N, L, D, std=3.0, dtype=dtype), _r(g, D, std=0.5, dtype=dtype)
    with Counted("residual_add") as c:
        got = clip_glue.residual_add(x, y, b)
    exact(got, clip_glue.reference_residual_add(x, y, b))
    assert c.added == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N,L,D,H", ROWS + [(8, 197, 768, 12), (3, 77, 512, 8), (2, 197, 1024, 16), (5, 17, 64, 4)],
                         ids=ROW_IDS + ["bucket4", "text_3rows", "width1024", "tiny"])
def test_layer_norm_contiguous_and_cls_rows(dev, N, L, D, H, dtype):
    """The stem's ln_pre on whole streams and ln_post on the CLS rows, a
    strided view of N rows."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = _r(g, N, L, D, std=2.0, mean=0.5, dtype=dtype)
    scale, bias = _ln(g, D, dtype)
    for view in (x, x[:, 0, :], x[:, :1]):
        with Counted("layer_norm") as c:
            got = clip_glue.layer_norm(view, scale, bias)
        near(got, clip_glue.reference_layer_norm(view, scale, bias))
        assert c.added == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N,L,D,H", ROWS[:2], ids=ROW_IDS[:2])
def test_inject_layer_norm(dev, N, L, D, H, dtype):
    """G2L's injection and its ln_1: fractional masks with empty patches on
    the patch rows, the CLS row unmasked."""
    g = torch.Generator(device=dev).manual_seed(4)
    x, x2 = _r(g, N, L, D, dtype=dtype), _r(g, N, L, D, dtype=dtype)
    grid = int(round((L - 1) ** 0.5))
    m = torch.rand((N, grid, grid), generator=g, device=dev)
    m[m < 0.4] = 0.0
    m[0] = 1.0  # a whole proposal
    scale, bias = _ln(g, D, dtype)
    with Counted("inject_layer_norm") as c:
        x_new, ln = clip_glue.inject_layer_norm(x, x2, m, scale, bias)
    want_x, want_ln = clip_glue.reference_inject_layer_norm(x, x2, m, scale, bias)
    torch.cuda.synchronize()
    exact(x_new, want_x)
    near(ln, want_ln)
    exact(x_new[:, 0], (x[:, 0].float() + 2.0 * x2[:, 0].float()).to(dtype))
    assert c.added == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N,L,D,H", ROWS[:3], ids=ROW_IDS[:3])
def test_qkv_heads_and_merge(dev, N, L, D, H, dtype):
    """The in-projection's bias and head split into K6's layout, and K6's
    output merged back, exactly; K6 between them as the block runs it."""
    from hybridgl_tpu_torch.kernels.clip_attention import clip_attention

    g = torch.Generator(device=dev).manual_seed(5)
    a, w, b = _r(g, N, L, D, dtype=dtype), _r(g, D, 3 * D, std=D**-0.5, dtype=dtype), _r(g, 3 * D, std=0.5, dtype=dtype)
    y = a @ w
    with Counted("qkv_heads") as c:
        q, k, v = clip_glue.qkv_heads(y, b, H)
    for got, want in zip((q, k, v), clip_glue.reference_qkv_heads(y, b, H), strict=True):
        exact(got, want)
    assert c.added == 1
    ctx = clip_attention(q, k, v, None, H, (D // H) ** -0.5)
    with Counted("merge_heads") as c:
        got = clip_glue.merge_heads(ctx, N)
    exact(got, clip_glue.reference_merge_heads(ctx, N))
    assert c.added == 1


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("N,L,D,H", ROWS, ids=ROW_IDS)
def test_bias_quick_gelu(dev, N, L, D, H, dtype):
    """The MLP's bias and QuickGELU, each step rounded as PyTorch's ops round."""
    g = torch.Generator(device=dev).manual_seed(6)
    h, b = _r(g, N, L, 4 * D, std=3.0, dtype=dtype), _r(g, 4 * D, std=0.5, dtype=dtype)
    with Counted("bias_quick_gelu") as c:
        got = clip_glue.bias_quick_gelu(h, b)
    exact(got, clip_glue.reference_bias_quick_gelu(h, b))
    assert c.added == 1


def test_refused_calls_raise(dev):
    """A dtype the kernels lack, dtypes mixed in one call, a width that is no
    multiple of 8, rows the LayerNorm kernel cannot read at one stride, a
    non-contiguous activation and a head dim of 6 raise and launch nothing."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = _r(g, 4, 9, 768)
    cases = [("layer_norm", (x.half(), *(t.half() for t in _ln(g, 768)), 1e-5), TypeError),
             ("residual_layer_norm", (x, x, _r(g, 768), *_ln(g, 768, F32), 1e-5), TypeError),
             ("layer_norm", (_r(g, 4, 9, 12), *_ln(g, 12), 1e-5), ValueError),
             ("layer_norm", (x[:, 1:, :], *_ln(g, 768), 1e-5), ValueError),
             ("residual_add", (x.transpose(0, 1), x.transpose(0, 1), _r(g, 768)), ValueError),
             ("bias_quick_gelu", (_r(g, 4, 9, 12), _r(g, 12)), ValueError),
             ("qkv_heads", (_r(g, 2, 9, 3 * 60), _r(g, 3 * 60), 10), ValueError)]
    for name, args, error in cases:
        with Counted(name) as c, pytest.raises(error, match=f"clip_glue.{name}"):
            getattr(clip_glue, name)(*args)
        assert c.added == 0, name


@pytest.mark.parametrize("name", GLUE)
def test_operator_is_the_direct_launch(dev, name):
    """torch.ops.hybridgl.<name> on CUDA tensors dispatches to the wrapper's launch."""
    from hybridgl_tpu_torch.kernels import _ops

    g = torch.Generator(device=dev).manual_seed(8)
    N, L, D, H = 4, 197, 768, 12
    x, y = _r(g, N, L, D), _r(g, N, L, D)
    ln = _ln(g, D)
    args = {"layer_norm": (x, *ln, 1e-5), "residual_add": (x, y, _r(g, D)),
            "residual_layer_norm": (x, y, _r(g, D), *ln, 1e-5),
            "inject_layer_norm": (x, y, torch.rand((N, L - 1), generator=g, device=dev), *ln, 1e-5),
            "qkv_heads": (_r(g, N, L, 3 * D), _r(g, 3 * D), H), "merge_heads": (_r(g, N * H, L, D // H), N),
            "bias_quick_gelu": (_r(g, N, L, 4 * D), _r(g, 4 * D))}[name]
    with Counted(name) as c:
        got = getattr(torch.ops.hybridgl, name).default(*args)
    want = _ops.REGISTERED[name].cuda(*args)
    torch.cuda.synchronize()
    got, want = ([x] if isinstance(x, torch.Tensor) else list(x) for x in (got, want))
    assert len(got) == len(want) and all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, want))
    assert c.added == 1


def _feature_error(got, want):
    return float(((got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)).mean())


def _vit_b16(dev):
    """ViT-B/16's pipeline config and random f32 weights on the card."""
    from hybridgl_tpu_torch.core.config import PipelineConfig
    from hybridgl_tpu_torch.core.params import init_clip

    cfg = PipelineConfig(clip_model="ViT-B/16", fusion_mode="G2L")
    return cfg, init_clip(torch.Generator(device=dev).manual_seed(0), cfg.clip)


def _readings(monkeypatch, run, params32):
    """(fused bf16, plain bf16, f32 plain) outputs of ``run(params)``: the
    same model code with its glue fused, and with the seven operators
    patched to their plain versions (PyTorch's summation order)."""
    from hybridgl_tpu_torch.core.params import cast_tree

    params16 = cast_tree(params32, BF16)
    before = launch_counts()
    with torch.inference_mode():
        fused = run(params16)
        launched = {k: v - before[k] for k, v in launch_counts().items() if k in GLUE}
        with monkeypatch.context() as m:
            for name in GLUE:
                m.setattr(clip_glue, name, getattr(clip_glue, f"reference_{name}"))
            plain16, want = run(params16), run(params32)
    torch.cuda.synchronize()
    return fused, plain16, want, launched


def test_fusion_features_fused_against_plain_at_bucket_32(dev, monkeypatch):
    """The feature stage's G2L features at bucket 32 (64 streams through the
    trunk), ViT-B/16 at full width: fused bf16 and plain bf16 against f32."""
    from hybridgl_tpu_torch.pipeline.scoring import fusion_features

    cfg, params = _vit_b16(dev)
    rng = np.random.default_rng(9)
    C, (h, w), P = cfg.canonical_size, (480, 640), 32
    image = torch.from_numpy(rng.integers(0, 255, (C, C, 3), np.uint8)).to(dev)
    masks = torch.zeros((P, C, C), dtype=torch.bool)
    for i in range(P):
        y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
        masks[i, y0 : y0 + rng.integers(20, h - y0), x0 : x0 + rng.integers(20, w - x0)] = True
    masks = masks.to(dev)
    fused, plain16, want, launched = _readings(monkeypatch, lambda p: fusion_features(cfg, p, masks, image, (h, w)),
                                               params)
    e_fused, e_plain = _feature_error(fused, want), _feature_error(plain16, want)
    print(f"G2L features at bucket 32 against f32: fused {e_fused:.6f}, plain bf16 {e_plain:.6f}, "
          f"fused against plain bf16 {_feature_error(fused, plain16):.6f}")
    assert torch.isfinite(fused).all() and fused.shape == want.shape == (P, cfg.clip.embed_dim)
    assert e_fused <= FEATURE_LIMIT["g2l"] and e_plain <= FEATURE_LIMIT["g2l"]
    assert all(launched[k] > 0 for k in GLUE)


def test_text_tower_fused_against_plain(dev, monkeypatch):
    """The sentence stage's text tower at full width (12 blocks of 512 on
    77-token rows, the causal-bias route): fused bf16 and plain bf16 against f32."""
    from hybridgl_tpu_torch.models.clip.text import encode_text

    cfg, params = _vit_b16(dev)
    g = torch.Generator(device=dev).manual_seed(10)
    tokens = torch.randint(1, cfg.clip.vocab_size - 1, (20, cfg.clip.context_length), generator=g, device=dev)
    tokens[:, 40] = cfg.clip.vocab_size - 1  # the end-of-text token, the highest id
    fused, plain16, want, launched = _readings(monkeypatch, lambda p: encode_text(p["text"], tokens, cfg.clip), params)
    e_fused, e_plain = _feature_error(fused, want), _feature_error(plain16, want)
    print(f"text features against f32: fused {e_fused:.6f}, plain bf16 {e_plain:.6f}, "
          f"fused against plain bf16 {_feature_error(fused, plain16):.6f}")
    assert e_fused <= FEATURE_LIMIT["text"] and e_plain <= FEATURE_LIMIT["text"]
    assert all(launched[k] > 0 for k in ("layer_norm", "residual_layer_norm", "bias_quick_gelu"))
