"""The proposal stage's hand-off to the host (``pipeline/handoff.py``, the host
cleanup of ``pipeline/runner.py``) against the JAX package on CPU.

* the packed masks equal ``jnp.packbits(axis=-1)``'s bytes;
* the port's ``HybridGLPipeline._cleanup_host`` gives exactly the bundle of
  the reference's ``HybridGLPipeline._cleanup_host`` (masks, boxes, valid,
  num, areas) on synthetic bundles: 0, 1, 8, 9, 37 and P rows up to the last
  live one, validity that is not a prefix, dead slots with pixels, holes and
  islands one pixel either side of ``min_mask_region_area``; a bundle that
  the cleanup leaves as it is comes back as the same tensors;
* ``generate_proposals`` and ``generate_proposals_multicrop`` make no host
  read (a dispatch mode counts scalar reads and ``nonzero``) and still give
  the reference's bundle; NMS's count is a tensor;
* the helpers that ``tools/device_time.py`` measures the hand-off with (the
  device's busy time, the copies by kind).
"""

import collections
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from hybridgl_tpu.core.config import AmgConfig, PipelineConfig, sam_preset
from hybridgl_tpu.kernels import nms as jnms
from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu.pipeline import postprocess as jpost
from hybridgl_tpu.pipeline import runner as jrunner
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.kernels import nms as tnms
from hybridgl_tpu_torch.models.sam import amg as tamg
from hybridgl_tpu_torch.pipeline import handoff, postprocess, runner
from test_torch_multicrop import AMG_MC
from test_torch_sam import jax_tree, noisy_params
from torch_port_config import to_port

P, C, HW, MIN_AREA = 64, 64, (56, 60), 12
CFG = PipelineConfig(canonical_size=C, amg=AmgConfig(min_mask_region_area=MIN_AREA))


@pytest.mark.parametrize("C_", [640, 1024, 100])
def test_packed_bytes_equal_jnp_packbits(C_):
    """RefCOCO's and PhraseCut's frames, and a width that is no multiple of 8;
    unpacking gives the masks back."""
    masks = np.random.default_rng(C_).random((3, 17, C_)) > 0.5
    got = handoff.pack_masks(torch.from_numpy(masks))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.packbits(jnp.asarray(masks), axis=-1)))
    assert torch.equal(handoff.unpack_masks(got, C_), torch.from_numpy(masks))


def _rows_with_holes_and_islands(rng, n_live):
    """[P, C, C] masks and [P] validity: rectangles in the (h, w) corner with a
    one-pixel-wide hole and a separate one-pixel-high island, each of
    MIN_AREA - 1 (cleaned away) or MIN_AREA + 1 pixels (kept) or absent; about
    a third of the slots below the last live one dead, with pixels."""
    h, w = HW
    masks = np.zeros((P, C, C), bool)
    valid = np.zeros(P, bool)
    sizes = (None, MIN_AREA - 1, MIN_AREA + 1)
    for i in range(n_live):
        y0, x0 = int(rng.integers(0, h - 14)), int(rng.integers(0, w - 20))
        hh, ww = int(rng.integers(8, 14)), int(rng.integers(16, 20))
        masks[i, y0 : y0 + hh, x0 : x0 + ww] = True
        hole, island = sizes[i % 3], sizes[(i // 3) % 3]
        if hole:
            masks[i, y0 + hh // 2, x0 + 1 : x0 + 1 + hole] = False
        if island:
            rows = [y for y in range(h) if y < y0 - 1 or y > y0 + hh]
            y = rows[int(rng.integers(0, len(rows)))]
            masks[i, y, 0:island] = True
        valid[i] = i == n_live - 1 or rng.random() > 0.3
    return masks, valid


def _disjoint_squares(n_live):
    """Squares on a grid: nothing to clean, no duplicate to suppress."""
    masks = np.zeros((P, C, C), bool)
    for i in range(n_live):
        y, x = divmod(i, 3)
        masks[i, 2 + 18 * y : 16 + 18 * y, 2 + 18 * x : 16 + 18 * x] = True
    return masks, np.arange(P) < n_live


def _bundles(masks, valid, seed):
    """The same bundle for both packages: (reference Proposals and its
    packed / head / aux buffers, port Proposals with device-style scalars)."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((P, 4), np.float32)
    for i in np.nonzero(valid)[0]:
        ys, xs = np.nonzero(masks[i])
        boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    f32 = lambda a: (a * valid.reshape((P,) + (1,) * (a.ndim - 1))).astype(np.float32)  # noqa: E731
    fields = dict(boxes_xyxy=boxes, iou_preds=f32(rng.random(P)), stability=f32(rng.random(P)),
                  points=f32(rng.random((P, 2)) * 50), areas=masks.sum((-2, -1)).astype(np.float32))
    num = int(valid.sum())
    packed = jnp.asarray(np.packbits(masks, axis=-1))
    aux = jnp.asarray(np.concatenate([fields["boxes_xyxy"].ravel(), fields["iou_preds"], fields["stability"],
                                      fields["points"].ravel(), fields["areas"]]))
    ref = jamg.Proposals(masks=jnp.asarray(masks), valid=valid, num=np.int32(num), overflow=0, **fields)
    port = tamg.Proposals(masks=torch.from_numpy(masks), valid=torch.from_numpy(valid),
                          num=torch.tensor(num, dtype=torch.int32), overflow=torch.tensor(0, dtype=torch.int32),
                          **{k: torch.from_numpy(v) for k, v in fields.items()})
    return (ref, packed, packed[: jrunner._PACKED_HEAD], aux), port


def _cleanup_both(masks, valid, seed, monkeypatch):
    """(reference result, its input, port result, port input, rows the port unpacked)."""
    (ref, packed, head, aux), port = _bundles(masks, valid, seed)
    want = jrunner.HybridGLPipeline._cleanup_host(SimpleNamespace(cfg=CFG), ref, HW, packed, head, aux)
    fetched = []
    fetch = runner.fetch_rows
    monkeypatch.setattr(runner, "fetch_rows", lambda h, n: fetched.append(n) or fetch(h, n))
    got = runner.HybridGLPipeline._cleanup_host(SimpleNamespace(cfg=to_port(CFG), device=torch.device("cpu")), port, HW)
    return want, ref, got, port, fetched


def _assert_equal(got, want):
    for name in ("masks", "boxes_xyxy", "valid", "areas"):
        g = getattr(got, name)
        np.testing.assert_array_equal(g.numpy() if isinstance(g, torch.Tensor) else g, np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert isinstance(got.num, int) and got.num == int(want.num)


@pytest.mark.parametrize("n_live", [0, 1, 8, 9, 37, P])
def test_host_cleanup_equals_the_reference(n_live, monkeypatch):
    """Holes and islands around min_mask_region_area, dead slots below the last
    live one: the reference's bundle exactly, from the live rows alone (the
    head prefetched at dispatch up to 8, a bucket of 16 or 64 rows past it)."""
    masks, valid = _rows_with_holes_and_islands(np.random.default_rng(n_live), n_live)
    want, _, got, port, fetched = _cleanup_both(masks, valid, n_live, monkeypatch)
    _assert_equal(got, want)
    assert fetched == ([n_live] if n_live else [])
    if n_live >= 8:  # the cleanup had something to do, and rows past the last live one are empty
        assert got.masks is not port.masks and not torch.equal(got.masks, port.masks)
        assert not got.masks[n_live:].any()


def test_host_cleanup_of_a_clean_bundle_returns_its_tensors(monkeypatch):
    """Nothing to fill, remove or suppress: the bundle's own tensors come
    back (no upload), as the reference returns its device arrays."""
    masks, valid = _disjoint_squares(9)
    want, ref, got, port, fetched = _cleanup_both(masks, valid, 9, monkeypatch)
    assert want is ref
    _assert_equal(got, want)
    assert all(getattr(got, f) is getattr(port, f) for f in tamg.Proposals._fields[:7])
    assert fetched == [9]


def test_hand_off_buffers(monkeypatch):
    """The dispatch side on the CPU: the head, aux and meta buffers, and
    fetch_rows taking the head up to 8 live rows and the packed rows past it."""
    masks, valid = _rows_with_holes_and_islands(np.random.default_rng(3), 37)
    (_, packed, _, aux), port = _bundles(masks, valid, 3)
    h = handoff.hand_off(port, pack=True)
    assert h.ready is None and h.head.shape == (handoff.PACKED_HEAD, C, C // 8)
    np.testing.assert_array_equal(h.head.numpy(), np.asarray(packed[: handoff.PACKED_HEAD]))
    np.testing.assert_array_equal(h.aux.numpy(), np.asarray(aux))
    np.testing.assert_array_equal(h.meta.numpy(), np.concatenate([[valid.sum(), 0], valid]).astype(np.int32))
    props, live = handoff.receive(h)
    assert (props.num, props.overflow) == (int(valid.sum()), 0) and np.array_equal(live, valid)
    np.testing.assert_array_equal(handoff.fetch_rows(h, 37), np.asarray(packed[:37]))
    headless = h._replace(packed=None)  # up to 8 rows the head alone serves
    np.testing.assert_array_equal(handoff.fetch_rows(headless, 8), np.asarray(packed[:8]))
    bare = handoff.hand_off(port, pack=False)
    assert bare.packed is None and bare.head is None and bare.aux is None
    np.testing.assert_array_equal(bare.meta.numpy(), h.meta.numpy())


@pytest.mark.parametrize("inplace", [False, True])
def test_postprocess_inplace_masks(inplace):
    """``inplace_masks`` cleans the given array itself and gives the same
    bundle as the copy, as the reference's argument does."""
    masks, valid = _rows_with_holes_and_islands(np.random.default_rng(5), 12)
    (ref, *_), port = _bundles(masks, valid, 5)
    host = tamg.Proposals(*(t.numpy().copy() if isinstance(t, torch.Tensor) else t for t in port))
    host = host._replace(num=int(host.num), overflow=0)
    before = host.masks.copy()
    got, changed = postprocess.postprocess_small_regions(host, MIN_AREA, 0.7, hw=HW, inplace_masks=inplace)
    want = jpost.postprocess_small_regions(ref._replace(masks=masks.copy()), MIN_AREA, 0.7, hw=HW,
                                           inplace_masks=inplace)
    assert changed
    for name in ("masks", "boxes_xyxy", "valid", "areas"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
    assert (got.masks is host.masks) == inplace
    assert np.array_equal(host.masks, before) != inplace


class _HostReads(TorchDispatchMode):
    """Counts the operations that read a tensor's values on the host."""

    READS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero", "aten::nonzero_static", "aten::is_nonzero",
             "aten::equal")

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.READS:
            self.seen[func._schema.name] += 1
        return func(*args, **(kwargs or {}))


def test_the_read_counter_sees_reads():
    """The counter below is not vacuous: int(), bool() and nonzero register."""
    with _HostReads() as reads:
        t = torch.arange(4)
        int(t.sum()), bool(t.any()), torch.nonzero(t)
    assert sum(reads.seen.values()) >= 3


@pytest.mark.parametrize("multicrop", [False, True])
def test_the_proposal_stage_reads_nothing(multicrop):
    """The stage at test-tiny (single crop, and five crops with per-crop
    buckets) under the read counter: no scalar read and no nonzero; its
    bundle equals the reference's, its counts int32 scalars."""
    cfg = sam_preset("test-tiny")
    params = noisy_params(cfg, 6 if multicrop else 4)
    rng = np.random.default_rng(8 if multicrop else 5)
    canonical, h, w, rh, rw = 32, 24, 32, 48, 64
    img = np.zeros((cfg.img_size, cfg.img_size, 3), np.uint8)
    img[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((canonical, canonical, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    amg_cfg = AMG_MC if multicrop else dataclasses.replace(AMG_MC, crop_n_layers=0, max_proposals=8)
    tp = from_numpy_tree(params)
    with _HostReads() as reads:
        if multicrop:
            got = tamg.generate_proposals_multicrop(tp, torch.from_numpy(img), rh, rw, torch.from_numpy(imgc), h, w,
                                                    to_port(cfg), to_port(amg_cfg), canonical)
        else:
            got = tamg.generate_proposals(tp, torch.from_numpy(img), rh, rw, h, w, to_port(cfg), to_port(amg_cfg),
                                          canonical)
    assert dict(reads.seen) == {}
    if multicrop:
        want = jamg.generate_proposals_multicrop(jax_tree(params), jnp.asarray(img), rh, rw, jnp.asarray(imgc), h, w,
                                                 cfg, amg_cfg, canonical)
    else:
        want = jamg.generate_proposals(jax_tree(params), jnp.asarray(img), rh, rw, h, w, cfg, amg_cfg, canonical)
    for name in ("num", "overflow"):
        v = getattr(got, name)
        assert isinstance(v, torch.Tensor) and v.shape == () and v.dtype == torch.int32, name
        assert int(v) == int(getattr(want, name)), name
    assert int(got.num) > 0
    for name in ("valid", "masks", "boxes_xyxy", "areas"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


def test_nms_count_is_a_tensor_equal_to_the_reference():
    rng = np.random.default_rng(11)
    xy = rng.random((300, 2)).astype(np.float32) * 60
    boxes = np.concatenate([xy, xy + 4 + rng.random((300, 2)).astype(np.float32) * 20], 1)
    scores, valid = rng.random(300).astype(np.float32), rng.random(300) > 0.1
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.7, jnp.asarray(valid))
    with _HostReads() as reads:
        got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.7, torch.from_numpy(valid))
    assert dict(reads.seen) == {}
    assert isinstance(got.num_kept, torch.Tensor) and got.num_kept.dtype == torch.int32
    assert int(got.num_kept) == int(want.num_kept) and 0 < int(got.num_kept) < int(valid.sum())


def test_device_time_busy_is_the_union_of_device_intervals():
    """A copy on a side stream that overlaps a kernel counts once (us -> ms)."""
    from hybridgl_tpu_torch.tools.device_time import busy_ms

    events = [dict(ts=0.0, dur=10.0), dict(ts=5.0, dur=10.0), dict(ts=6.0, dur=2.0), dict(ts=30.0, dur=5.0)]
    assert busy_ms(events) == pytest.approx(0.020)
    assert busy_ms([]) == 0.0


def test_device_time_copies_by_kind():
    from hybridgl_tpu_torch.tools.device_time import copies_by_kind

    pinned = "Memcpy DtoH (Device -> Pinned)"
    events = [dict(cat="gpu_memcpy", name=pinned, dur=40.0, args=dict(bytes=1048576)),
              dict(cat="gpu_memcpy", name=pinned, dur=10.0, args=dict(bytes=520)),
              dict(cat="gpu_memcpy", name="Memcpy HtoD (Pageable -> Device)", dur=3.0, args={}),
              dict(cat="kernel", name="nms_sweep", dur=700.0)]
    assert copies_by_kind(events) == {
        "DtoH (Device -> Pinned)": dict(copies=2, bytes=1049096, device_ms=0.05),
        "HtoD (Pageable -> Device)": dict(copies=1, bytes=None, device_ms=0.003)}
