"""GEM's attention kernels (``csrc/gem_attention.cu``) on the card against the
plain version in f32 on the same inputs: the tensor-core kernel (bf16, hd 64
and 80) at GEM's two towers ([12, 785, 64] and [16, 1025, 64]) and at the
lengths around a key tile (1, 63, 64, 65, 129), the CUDA-core kernel (f32,
and bf16 at hd 16 and 32); the trunk alone and with the ensemble, one and
two iterations; under CUDA-graph capture as the feature graph runs it; no
[L, L] score tensor allocated. Bars as K6's: bf16 cos >= 0.999 and
mean|d| / mean|plain| < 0.02 over the whole output and over the ensemble
alone; f32 max|d| <= 1e-4. The ensemble also under the card check's bar on
the part its scores decide (``check_kernels.ENSEMBLE_BAR``), which the
attention bar cannot see at GEM's temperature. Marked ``cuda``; skips where
no CUDA card is present."""

import pytest
import torch

from hybridgl_tpu_torch.kernels.gem_attention import gem_attention, reference_gem_attention, variant
from hybridgl_tpu_torch.tools.check_kernels import ENSEMBLE_BAR, ensemble_score_error

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, N, H, L, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((N * H, L, hd), generator=g, device=dev).to(dtype) for _ in range(3))


def _bar(got, want, dtype):
    g, w = got.float().flatten(), want.float().flatten()
    assert torch.isfinite(g).all()
    if dtype == torch.float32:
        assert float((g - w).abs().max()) <= 1e-4
    else:
        assert float(g @ w / (g.norm() * w.norm())) >= 0.999
        assert float((g - w).abs().mean() / w.abs().mean()) < 0.02


def _check(dev, N, H, L, hd, dtype, ensemble, iters, temp=None, seed=0):
    q, k, v = _inputs(dev, N, H, L, hd, dtype, seed)
    scale = hd**-0.5
    temp = scale if temp is None else temp
    before = (gem_attention.launches, gem_attention.tc_launches)
    got = gem_attention(q, k, v, N, scale, temp, iters, ensemble)
    torch.cuda.synchronize()
    on_tc = variant(dtype, hd) == "wgmma"
    assert (gem_attention.launches, gem_attention.tc_launches) == (before[0] + 1, before[1] + on_tc)
    want = reference_gem_attention(q.float(), k.float(), v.float(), N, scale, temp, iters, ensemble)
    assert got.shape == want.shape == ((2 if ensemble else 1), N, L, H * hd) and got.dtype == dtype
    _bar(got, want, dtype)
    if ensemble:  # the ensemble alone: the trunk's larger values would hide it in the whole
        _bar(got[1], want[1], dtype)
        if L > 1:  # at one key the output is its uniform part
            assert ensemble_score_error(got[1], want[1], v, N) < ENSEMBLE_BAR
    return got


@pytest.mark.parametrize("ensemble", [True, False], ids=["trunk+ensemble", "trunk"])
@pytest.mark.parametrize("H,L", [(12, 785), (16, 1025)], ids=["vit_b16_448", "vit_l14_336_448"])
def test_tensor_core_kernel_at_gems_towers(dev, H, L, ensemble):
    _check(dev, 1, H, L, 64, torch.bfloat16, ensemble, 1)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 129])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernels_around_a_key_tile(dev, dtype, L, iters):
    """Keys past L in the last tile (zero-filled, scored -inf), query tiles
    of one row, two streams; the trunk alone too."""
    _check(dev, 2, 3, L, 64, dtype, True, iters, temp=0.9, seed=L)
    _check(dev, 2, 3, L, 64, dtype, False, iters, seed=L + 1)


@pytest.mark.parametrize("hd,dtype", [(80, torch.bfloat16), (16, torch.bfloat16), (32, torch.bfloat16),
                                      (16, torch.float32), (80, torch.float32)])
def test_other_head_dims(dev, hd, dtype):
    _check(dev, 2, 2, 200, hd, dtype, True, 1, seed=hd)
    _check(dev, 1, 2, 97, hd, dtype, True, 2, temp=1.3, seed=hd + 1)


def test_equal_under_cuda_graph_capture(dev):
    """Captured with the ensemble beside the trunk and replayed on new inputs
    copied into the captured ones, as the feature graph runs it: the replay
    equals an eager call bit for bit."""
    q, k, v = _inputs(dev, 1, 12, 785, 64, torch.bfloat16, 5)
    scale = 64**-0.5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gem_attention(q, k, v, 1, scale, scale, 1, True)  # the library built and loaded off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gem_attention(q, k, v, 1, scale, scale, 1, True)
    for seed in (6, 7):
        for dst, src in zip((q, k, v), _inputs(dev, 1, 12, 785, 64, torch.bfloat16, seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gem_attention(q, k, v, 1, scale, scale, 1, True))


def test_no_score_tensor_is_allocated(dev):
    """At [16, 1025, 64] the call allocates its output and the three unit
    streams (~10.5 MB), less than one [16, 1025, 1025] bf16 score tensor."""
    q, k, v = _inputs(dev, 1, 16, 1025, 64, torch.bfloat16, 8)
    gem_attention(q, k, v, 1, 0.125, 0.125, 1, True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = gem_attention(q, k, v, 1, 0.125, 0.125, 1, True)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert grew < 16 * 1025 * 1025 * 2, grew
    assert out.shape == (2, 1, 1025, 1024)


def test_refuses_what_no_kernel_takes(dev):
    q, k, v = _inputs(dev, 1, 2, 40, 64, torch.bfloat16, 9)
    with pytest.raises(ValueError, match="head dim"):
        gem_attention(*(t[..., :48].contiguous() for t in (q, k, v)), 1, 0.1, 0.1, 1, True)
    with pytest.raises(ValueError, match="> 0"):
        gem_attention(q, k, v, 1, 0.1, -1.0, 1, True)
    with pytest.raises(TypeError):
        gem_attention(q, k, v.float(), 1, 0.1, 0.1, 1, True)
    with pytest.raises(ValueError, match="contiguous"):
        gem_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 1, 0.1, 0.1, 1, True)
