"""GEM's attention operator (``hybridgl_tpu_torch/kernels/gem_attention.py``) on the CPU.

The operator's CPU implementation is the plain path GEM ran before it had a
kernel, moved unchanged: it equals that path (copied below as it stood in
``models/gem/gem.py``) bit for bit, at GEM's 785 tokens and at short and
ragged lengths, one and two iterations, the default and an explicit
temperature, f32 and bf16. ``gem_image_features`` sends every block's
attention through the operator, the ensemble in the last ``depth`` blocks.
The kernels' device symbols, the names a profiler trace gives them, match no
key of the benchmark's own-kernel table (whose roofline model does not count
them). The card check's bar on the ensemble (``tools/check_kernels.py``:
``ensemble_score_error`` under ``ENSEMBLE_BAR``) fails planted faults at
GEM's two towers and passes a bf16 rounding of the right answer, and the
check's library yardstick computes the same function.
"""

import functools
import os
import re
import sys

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core.config import ClipConfig, GemConfig
from hybridgl_tpu_torch.core.dtypes import score_dtype, softmax_scores
from hybridgl_tpu_torch.core.params import init_clip
from hybridgl_tpu_torch.kernels import gem_attention as mod
from hybridgl_tpu_torch.models.gem import gem
from hybridgl_tpu_torch.tools.check_kernels import ENSEMBLE_BAR, _gem_library, ensemble_score_error

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the plain path as models/gem/gem.py ran it before the operator
def _l2norm(t, eps=1e-6):
    return t / torch.clamp(torch.sqrt((t * t).sum(dim=-1, keepdim=True)), min=eps)


def _scores(a, b, scale, sdt):
    return (scale * torch.matmul(a.float(), b.float().transpose(-1, -2))).to(sdt)


def _self_self_attention(q, k, v, temp, iters):
    sdt = score_dtype(q.dtype)
    outs = []
    for t in (q, k, v):
        tn = _l2norm(t)
        attn = None
        for _ in range(max(iters, 1)):
            attn = softmax_scores(_scores(tn, tn, temp, sdt)).to(t.dtype)
            tn = _l2norm(torch.matmul(attn, tn))
        outs.append(torch.matmul(attn, v))
    return (outs[0] + outs[1] + outs[2]) / 3.0


def _std_attention(q, k, v, scale):
    attn = softmax_scores(_scores(q, k, scale, score_dtype(q.dtype))).to(v.dtype)
    return torch.matmul(attn, v)


def _merge_heads(t):
    N, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(N, L, H * hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("temp", [None, 0.7], ids=["temp_default", "temp_explicit"])
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("L", [17, 65, 785])
def test_cpu_operator_equals_the_plain_path_bit_for_bit(L, iters, temp, dtype):
    N, H, hd = 2, 2, 16
    rng = np.random.default_rng(L + iters)
    q, k, v = (torch.from_numpy(rng.standard_normal((N, H, L, hd)).astype(np.float32)).to(dtype) for _ in range(3))
    scale = hd**-0.5
    t = hd**-0.5 if temp is None else temp  # gem_image_features' default
    heads = lambda x: x.reshape(N * H, L, hd)  # noqa: E731  (qkv_heads' layout)
    got = torch.ops.hybridgl.gem_attention(heads(q), heads(k), heads(v), N, scale, t, iters, True)
    assert got.shape == (2, N, L, H * hd) and got.dtype == dtype
    assert torch.equal(got[0], _merge_heads(_std_attention(q * scale, k, v, 1.0)))
    assert torch.equal(got[1], _merge_heads(_self_self_attention(q, k, v, t, iters)))
    trunk = mod.gem_attention(heads(q), heads(k), heads(v), N, scale, t, iters, False)
    assert trunk.shape == (1, N, L, H * hd) and torch.equal(trunk[0], got[0])
    assert mod.gem_attention.launches == mod.gem_attention.tc_launches == 0  # nothing launched on the CPU


@pytest.mark.parametrize("layers,depth", [(12, 7), (24, 7)], ids=["vit_b16_depth", "vit_l14_336_depth"])
def test_every_block_of_gem_runs_the_operator(monkeypatch, layers, depth):
    """12 + 7 calls at ViT-B/16's depth, 24 + 7 at ViT-L/14@336's: one a
    block, the ensemble beside the trunk in the last ``depth``; one head
    split a block (no merge: the operator writes the heads merged)."""
    from hybridgl_tpu_torch.kernels import clip_glue

    cfg = ClipConfig(image_size=32, patch_size=8, vision_width=32, vision_layers=layers, vision_heads=2,
                     context_length=8, vocab_size=50, text_width=16, text_heads=2, text_layers=1, embed_dim=16)
    params = init_clip(torch.Generator().manual_seed(0), cfg)
    calls, splits = [], []
    real, real_split = gem.gem_attention, clip_glue.qkv_heads

    def counted(q, k, v, n, scale, temp, iters, ensemble):
        calls.append((tuple(q.shape), n, ensemble))
        return real(q, k, v, n, scale, temp, iters, ensemble)

    def counted_split(*args):
        splits.append(1)
        return real_split(*args)

    monkeypatch.setattr(gem, "gem_attention", counted)
    monkeypatch.setattr(clip_glue, "qkv_heads", counted_split)
    img = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 40, 40, 3)).astype(np.float32))
    feats, _, G = gem.gem_image_features(params["visual"], img, cfg, GemConfig(img_size=40, depth=depth))
    assert G == 5 and feats.shape == (1, 25, 16) and torch.isfinite(feats).all()
    assert len(calls) == len(splits) == layers
    assert [e for _, _, e in calls] == [False] * (layers - depth) + [True] * depth
    assert all(shape == (2, 26, 16) and n == 1 for shape, n, _ in calls)


def test_kernel_symbols_are_outside_the_benchmarks_own_kernel_table():
    """The names ``KERNEL_SYMBOLS`` exports are the ``__global__`` functions of
    ``csrc/gem_attention.cu``, and no key of ``benchlib/trace.py:OWN_KERNELS``
    matches any of them as a trace names it (its own-kernel count and the
    roofline model would otherwise disagree)."""
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from benchlib.trace import OWN_KERNELS, own_kernel

    with open(os.path.join(REPO, "hybridgl_tpu_torch", "csrc", "gem_attention.cu")) as f:
        source = f.read()
    defined = set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", source))
    assert defined == set(mod.KERNEL_SYMBOLS)
    for sym in mod.KERNEL_SYMBOLS:
        for name in (f"void (anonymous namespace)::{sym}<64>((anonymous namespace)::Args)",
                     f"void (anonymous namespace)::{sym}<__nv_bfloat16, 80>(__nv_bfloat16 const*, float)"):
            assert own_kernel(name) is None, (name, [key for key, _ in OWN_KERNELS if key in name])


def test_variant_by_dtype_and_head_dim():
    assert [mod.variant(torch.bfloat16, hd) for hd in (16, 32, 64, 80)] == ["cuda-core", "cuda-core", "wgmma", "wgmma"]
    assert mod.variant(torch.float32, 64) == "cuda-core"


def _ensemble(streams, v, temp):
    """A wrong ensemble's output in f32 (one stream, [H, L, hd] each): the
    mean over ``streams`` of softmax(temp n(t) n(t)^T) v, heads merged."""
    outs = [torch.softmax(temp * _l2norm(t.float()) @ _l2norm(t.float()).transpose(-1, -2), -1) @ v.float()
            for t in streams]
    return _merge_heads((sum(outs) / len(outs))[None])


@functools.lru_cache(maxsize=2)
def _tower(H, L):
    """bf16 q, k, v [H, L, 64] and the plain ensemble in f32 at temperature hd^-0.5."""
    g = torch.Generator().manual_seed(H * L)
    q, k, v = (torch.randn((H, L, 64), generator=g).bfloat16() for _ in range(3))
    want = mod.reference_gem_attention(q.float(), k.float(), v.float(), 1, 0.125, 0.125, 1, True)[1]
    return q, k, v, want


TOWERS = pytest.mark.parametrize("H,L", [(12, 785), (16, 1025)], ids=["vit_b16_448", "vit_l14_336_448"])


@TOWERS
@pytest.mark.parametrize("fault", ["uniform scores", "q three times", "q dropped", "k dropped", "v dropped",
                                   "temp halved", "temp doubled"])
def test_ensemble_bar_fails_planted_faults(H, L, fault):
    """A kernel whose ensemble ignores its scores, repeats or drops a stream
    or takes another temperature moves the whole output little (cos >=
    0.999, mean|d|/mean|plain| 0.0115-0.0267, about the attention bar's
    0.02) and fails the bar on the part the scores decide (0.45 or more
    against 0.2)."""
    q, k, v, want = _tower(H, L)
    bad = {"uniform scores": lambda: _merge_heads(v.float().mean(1, keepdim=True).expand(H, L, 64)[None]),
           "q three times": lambda: _ensemble((q, q, q), v, 0.125),
           "q dropped": lambda: _ensemble((k, v), v, 0.125),
           "k dropped": lambda: _ensemble((q, v), v, 0.125),
           "v dropped": lambda: _ensemble((q, k), v, 0.125),
           "temp halved": lambda: _ensemble((q, k, v), v, 0.0625),
           "temp doubled": lambda: _ensemble((q, k, v), v, 0.25)}[fault]().bfloat16()
    assert ensemble_score_error(bad, want, v, 1) >= ENSEMBLE_BAR * 2
    g, w = bad.float().flatten(), want.flatten()
    assert float(g @ w / (g.norm() * w.norm())) >= 0.999 and float((g - w).abs().mean() / w.abs().mean()) < 0.03


@TOWERS
def test_ensemble_bar_passes_the_right_answer_in_bf16(H, L):
    """The f32 answer rounded to bf16 (what an exact kernel writes) reads
    ~0.055 and the plain bf16 path, which rounds its scores to bf16, ~0.11."""
    q, k, v, want = _tower(H, L)
    assert ensemble_score_error(want.bfloat16(), want, v, 1) < ENSEMBLE_BAR / 3
    plain = mod.reference_gem_attention(q, k, v, 1, 0.125, 0.125, 1, True)[1]
    assert ensemble_score_error(plain, want, v, 1) < ENSEMBLE_BAR * 0.6


@pytest.mark.parametrize("ensemble", [True, False], ids=["trunk+ensemble", "trunk"])
def test_library_yardstick_computes_gems_attention(ensemble):
    """check_kernels' library yardstick (two scaled_dot_product_attention
    calls, the unit rows, a mean) equals the plain version in f32 to
    rounding, at two temperatures."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((3, 70, 32), generator=g) for _ in range(3))
    for scale, temp in ((32**-0.5, 32**-0.5), (0.2, 1.5)):
        got = _gem_library(q, k, v, scale, temp, ensemble)
        want = mod.reference_gem_attention(q, k, v, 1, scale, temp, 1, ensemble)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@TOWERS
def test_ensemble_bar_at_two_iterations(H, L):
    """At temperature 1 (where the card check runs two iterations) the f32
    answer rounded to bf16 passes and the one-iteration answer, a kernel
    that skipped the update pass, fails. At hd^-0.5 the second pass's rows
    are alike to ~1e-4 and even the rounded answer reads over the bar."""
    q, k, v, _ = _tower(H, L)
    want, once = (mod.reference_gem_attention(q.float(), k.float(), v.float(), 1, 0.125, 1.0, it, True)[1]
                  for it in (2, 1))
    assert ensemble_score_error(want.bfloat16(), want, v, 1) < ENSEMBLE_BAR / 3
    assert ensemble_score_error(once.bfloat16(), want, v, 1) >= ENSEMBLE_BAR * 2
    flat = mod.reference_gem_attention(q.float(), k.float(), v.float(), 1, 0.125, 0.125, 2, True)[1]
    assert ensemble_score_error(flat.bfloat16(), flat, v, 1) > ENSEMBLE_BAR
