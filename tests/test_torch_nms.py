"""The port's NMS (``hybridgl_tpu_torch/kernels/nms.py``: the wrapper over
``torch.ops.hybridgl.nms``, whose CPU implementation is the plain version of
``csrc/nms.cu``) against the reference's ``hybridgl_tpu.kernels.nms.nms``
on the CPU, held EXACTLY equal: ``order``, ``keep_sorted`` and ``num_kept``.

Inputs come from a numpy seed and go to both packages as f32. Cases: random
boxes (float and integer coordinates, tied scores, invalid rows) at N = 1,
63, 64, 192, 1,280 and 3,072 with thresholds 0.5 and 0.7; all boxes
identical (one kept); pairwise disjoint boxes (all kept); zero-area boxes
(union 0, IoU 0); and pairs whose f32 IoU equals f32(threshold) exactly
(kept: the comparison is strict) beside the nearest pairs above and below
it, found by a seeded search over small integer boxes. Then the plain
bitmask against the reference's ``box_iou_matrix`` and
``kept_in_score_order`` after the sweep. The kernel itself runs on the card
only (``tests/test_torch_cuda_kernels.py``); the refusals of its CUDA
implementation come before any launch and are held here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridgl_tpu.kernels import masks as jmasks
from hybridgl_tpu.kernels import nms as jnms
from hybridgl_tpu_torch.kernels import _ops
from hybridgl_tpu_torch.kernels import nms as tnms


def random_boxes(rng, N, integer):
    """N boxes at a density that leaves many overlaps at either threshold."""
    side = 12.0 * np.sqrt(max(N, 1) / 64.0) + 8.0
    xy = rng.random((N, 2)) * side
    wh = 2.0 + rng.random((N, 2)) * 20.0
    boxes = np.concatenate([xy, xy + wh], axis=1)
    return (np.floor(boxes) if integer else boxes).astype(np.float32)


def both(boxes, scores, thr, valid=None):
    """(reference result, port result) on the same numpy inputs."""
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    jr = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, jv)
    tr = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr, tv)
    return jr, tr


def assert_same(jr, tr):
    np.testing.assert_array_equal(tr.order.numpy(), np.asarray(jr.order))
    np.testing.assert_array_equal(tr.keep_sorted.numpy(), np.asarray(jr.keep_sorted))
    # the count stays a device scalar, as the reference's: nothing is read back
    assert isinstance(tr.num_kept, torch.Tensor) and tr.num_kept.shape == () and tr.num_kept.dtype == torch.int32
    assert int(tr.num_kept) == int(jr.num_kept)


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("N", [1, 63, 64, 192, 1280, 3072])
def test_random_boxes_match_the_reference(N, thr):
    rng = np.random.default_rng(N)
    boxes = random_boxes(rng, N, integer=N % 2 == 0)
    scores = (rng.integers(0, 40, N) / 40.0).astype(np.float32)  # ties: the stable order decides
    valid = rng.random(N) > 0.2
    jr, tr = both(boxes, scores, thr, valid)
    assert_same(jr, tr)
    if N >= 192:  # the sweep really suppressed something, and kept something
        assert 0 < int(tr.num_kept) < int(valid.sum())


def test_identical_boxes_keep_one():
    boxes = np.tile(np.float32([[10, 20, 60, 90]]), (100, 1))
    scores = np.random.default_rng(1).random(100).astype(np.float32)
    jr, tr = both(boxes, scores, 0.7)
    assert_same(jr, tr)
    assert int(tr.num_kept) == 1 and tr.order[0] == int(np.argmax(scores))


def test_disjoint_boxes_keep_all():
    g = np.arange(12, dtype=np.float32) * 10
    x, y = np.meshgrid(g, g)
    boxes = np.stack([x.ravel(), y.ravel(), x.ravel() + 9, y.ravel() + 9], 1).astype(np.float32)
    scores = np.random.default_rng(2).random(len(boxes)).astype(np.float32)
    jr, tr = both(boxes, scores, 0.5)
    assert_same(jr, tr)
    assert int(tr.num_kept) == len(boxes)


def test_zero_area_boxes_suppress_nothing():
    """Points and lines: the union of two equal ones is 0, so their IoU is 0."""
    rng = np.random.default_rng(3)
    pts = np.floor(rng.random((30, 2)) * 5).astype(np.float32)
    points = np.concatenate([pts, pts], 1)  # x1 == x2, y1 == y2
    lines = np.concatenate([pts, pts + np.float32([4, 0])], 1)  # height 0
    boxes = np.concatenate([points, points, lines, lines]).astype(np.float32)
    scores = rng.random(len(boxes)).astype(np.float32)
    jr, tr = both(boxes, scores, 0.5)
    assert_same(jr, tr)
    assert int(tr.num_kept) == len(boxes)


def f32_iou(a, b):
    """The IoU of two boxes as box_iou_matrix rounds it, one f32 operation at a time."""
    f = np.float32
    area_a = f(a[2] - a[0]) * f(a[3] - a[1])
    area_b = f(b[2] - b[0]) * f(b[3] - b[1])
    w = max(min(a[2], b[2]) - max(a[0], b[0]), f(0))
    h = max(min(a[3], b[3]) - max(a[1], b[1]), f(0))
    inter = f(w) * f(h)
    union = f(area_a + area_b) - inter
    return f(inter / union) if union > 0 else f(0)


def threshold_pairs(thr):
    """From a seeded search over integer boxes in [0, 16]^2: the pairs whose
    f32 IoU is exactly f32(thr), and the nearest pair on each side of it."""
    rng = np.random.default_rng(4)
    t = np.float32(thr)
    ties, below, above = [], None, None
    for _ in range(20000):
        x0, y0 = rng.integers(0, 8, 2)
        a = np.float32([x0, y0, x0 + rng.integers(1, 9), y0 + rng.integers(1, 9)])
        dx, dy = rng.integers(-2, 3, 2)
        b = np.float32([a[0] + dx, a[1] + dy, a[2] + dx + rng.integers(-2, 3), a[3] + dy + rng.integers(-2, 3)])
        if b[2] <= b[0] or b[3] <= b[1]:
            continue
        iou = f32_iou(a, b)
        if iou == t:
            ties.append((a, b))
        elif iou < t and (below is None or iou > below[0]):
            below = (iou, a, b)
        elif iou > t and (above is None or iou < above[0]):
            above = (iou, a, b)
    return ties[:8], below, above


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_iou_equal_to_the_threshold_does_not_suppress(thr):
    ties, below, above = threshold_pairs(thr)
    assert ties and below and above
    pairs = ties + [below[1:], above[1:]]
    # each pair alone in its own corner of the plane; the first box of a pair scores higher
    boxes = np.concatenate([np.stack([a, b]) + np.float32(100 * k) for k, (a, b) in enumerate(pairs)])
    scores = np.float32([2 - 0.01 * k for k in range(len(pairs)) for _ in (0, 1)]) - np.float32([0, 1] * len(pairs))
    jr, tr = both(boxes.astype(np.float32), scores, thr)
    assert_same(jr, tr)
    keep = np.zeros(len(boxes), bool)
    keep[tr.order.numpy()] = tr.keep_sorted.numpy()
    second = keep[1::2]
    assert second[: len(ties)].all()  # IoU == f32(thr): not > thr
    assert second[len(ties)] and not second[len(ties) + 1]  # just below: kept; just above: suppressed


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_plain_bitmask_is_the_reference_iou_over_the_threshold(thr):
    rng = np.random.default_rng(5)
    boxes = random_boxes(rng, 200, integer=True)
    want = (np.asarray(jmasks.box_iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes))) > thr) & np.triu(
        np.ones((200, 200), bool), 1)
    got = tnms.suppression_matrix(torch.from_numpy(boxes), thr)
    assert got.dtype == torch.bool and 0 < int(got.sum()) < 200 * 199 // 2
    np.testing.assert_array_equal(got.numpy(), want)


def test_kept_in_score_order_after_the_sweep():
    rng = np.random.default_rng(6)
    boxes = random_boxes(rng, 192, integer=True)
    scores = rng.random(192).astype(np.float32)
    valid = rng.random(192) > 0.3
    jr, tr = both(boxes, scores, 0.7, valid)
    assert_same(jr, tr)
    for max_out in (16, 64, 192):
        jk, jv = jnms.kept_in_score_order(jr, max_out)
        tk, tv = tnms.kept_in_score_order(tr, max_out)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_a_cpu_call_runs_the_plain_version_and_counts_nothing():
    tnms.nms.launches = 0
    boxes = torch.from_numpy(random_boxes(np.random.default_rng(7), 64, integer=False))
    res = tnms.nms(boxes, torch.rand(64), 0.7)
    keep, num = tnms.reference_nms_sorted(boxes[res.order], torch.ones(64, dtype=torch.bool), 0.7)
    assert torch.equal(res.keep_sorted, keep) and torch.equal(res.num_kept, num) and num.dtype == torch.int32
    assert tnms.nms.launches == 0


@pytest.mark.parametrize("bad", ["f64 boxes", "[N, 5] boxes", "int valid", "short valid", "N = 0", "strided boxes"])
def test_the_cuda_implementation_refuses_before_launching(bad):
    """The operator's CUDA implementation checks its inputs before it builds
    or launches anything, so its refusals show on CPU tensors too."""
    boxes, valid = torch.zeros((8, 4)), torch.ones(8, dtype=torch.bool)
    if bad == "f64 boxes":
        boxes = boxes.double()
    elif bad == "[N, 5] boxes":
        boxes = torch.zeros((8, 5))
    elif bad == "int valid":
        valid = valid.int()
    elif bad == "short valid":
        valid = valid[:7]
    elif bad == "N = 0":
        boxes, valid = boxes[:0], valid[:0]
    else:
        boxes = torch.zeros((8, 8))[:, ::2]
    with pytest.raises(ValueError, match="nms"):
        _ops.REGISTERED["nms"].cuda(boxes, valid, 0.7)
