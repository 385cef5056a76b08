"""The port's small-region cleanup, its native host pass, against the JAX
package's cleanup on tensors (hybridgl_tpu/kernels/connected.py, what the
reference's runner runs under HYBRIDGL_CLEANUP=device) on CPU, on random and
hand-made masks as tests/test_connected.py builds them: the pass itself
(``postprocess_native.cleanup_batch``), the bundle pass with its dedup NMS
(``postprocess_small_regions``) and the runner's ``cleanup_host`` on a
hand-off. Everything is exact: cleaned masks, flags, boxes, areas, validity.

The host pass labels each mask in its box's crop window and protects the
background that touches the window's ring as the global background (the
reference's crop-window argument, hybridgl_tpu/pipeline/postprocess.py); the
pass on tensors labels the whole frame. They agree where the frame leaves
that background at least ``min_area`` pixels, as every served frame does
(640^2 and 1024^2): the frames here are 64^2, since at 2,000 px a 48^2 frame
does not."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridgl_tpu.kernels import connected as jconn
from hybridgl_tpu.kernels.resize import valid_mask as jvalid_mask
from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu_torch.core.config import tiny_smoke_config
from hybridgl_tpu_torch.models.sam import amg as tamg
from hybridgl_tpu_torch.pipeline import postprocess_native, runner
from hybridgl_tpu_torch.pipeline.postprocess import postprocess_small_regions


def hand_made(H=48, W=48):
    big = np.zeros((H, W), bool)
    big[8:40, 8:40] = True
    big[20:23, 20:23] = False  # 9-px hole
    big[2:4, 2:4] = True  # 4-px island
    pocket = np.zeros((H, W), bool)
    pocket[30:48, 5:30] = True
    pocket[40:48, 12:18] = False  # open to the bottom edge
    spiral = np.zeros((H, W), bool)  # a long thin component: many sweeps without pointer jumping
    for k in range(0, 20, 4):
        spiral[k, k : W - k] = spiral[H - 1 - k, k : W - k] = True
        spiral[k : H - k, W - 1 - k] = spiral[k + 4 : H - k, k] = True
    diag = np.eye(H, W, dtype=bool) | np.eye(H, W, k=7, dtype=bool)  # 8-connectivity only
    return [big, pocket, spiral, diag, np.zeros((H, W), bool), np.ones((H, W), bool)]


def cases(seed, H=48, W=48):
    rng = np.random.default_rng(seed)
    return [rng.random((H, W)) > t for t in (0.5, 0.55, 0.7, 0.3)] + hand_made(H, W)


def box(m):
    """The xyxy box of a mask's pixels, as the AMG gives it (zeros when empty)."""
    ys, xs = np.nonzero(m)
    return np.float32([xs.min(), ys.min(), xs.max(), ys.max()]) if ys.size else np.zeros(4, np.float32)


def host_pass(masks, hw, min_area, valid=None):
    """``postprocess_native.cleanup_batch`` on a stack of masks with their own
    boxes -> (cleaned masks, changed flags)."""
    masks = np.array(masks, bool)  # a copy: the pass cleans in place
    valid = np.ones(len(masks), bool) if valid is None else np.asarray(valid)
    changed, _, _ = postprocess_native.cleanup_batch(masks, np.stack([box(m) for m in masks]), valid, hw, min_area)
    return masks, changed


def _bundle(module, to_array, masks, P, C):
    n = len(masks)
    arr = np.zeros((P, C, C), bool)
    boxes = np.zeros((P, 4), np.float32)
    for i, m in enumerate(masks):
        arr[i] = m
        boxes[i] = box(m)
    valid = np.zeros(P, bool)
    valid[: n - 1] = True  # live slots are a prefix, as the AMG leaves them; the last mask sits in a dead slot
    fields = dict(masks=arr, boxes_xyxy=boxes * valid[:, None], iou_preds=valid.astype(np.float32),
                  stability=valid.astype(np.float32), points=np.zeros((P, 2), np.float32),
                  areas=arr.sum((-2, -1)).astype(np.float32), valid=valid)
    num = int(valid.sum())
    return module.Proposals(**{k: to_array(v) for k, v in fields.items()},
                            num=num if module is tamg else jnp.asarray(num, jnp.int32))


def _bundle_masks(seed, C, h, w):
    rng = np.random.default_rng(seed)
    base = np.zeros((C, C), bool)
    base[5:30, 5:30] = True
    noisy = base.copy()
    noisy[40:42, 40:42] = True  # a 4-px island: the cleanup makes it equal to base
    dead = np.zeros((C, C), bool)
    dead[1:4, 1:4] = True
    holey = np.zeros((C, C), bool)
    holey[30:52, 30:60] = True
    holey[40:43, 40:43] = False
    edge = np.zeros((C, C), bool)  # a pocket open at the image's bottom edge
    edge[h - 20 : h, 8:40] = True
    edge[h - 6 : h, 20:24] = False
    masks = [base, noisy, holey, edge]
    for _ in range(2):
        m = np.zeros((C, C), bool)
        m[:h, :w] = rng.random((h, w)) > 0.6
        masks.append(m)
    return masks + [dead]


def jax_pass(m, frame_valid, min_area, mode):
    mask, changed = jconn.remove_small_regions_jit(jnp.asarray(m), frame_valid, min_area, mode)
    return np.asarray(mask), bool(changed)


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("thresh", [6, 40, 2000])
def test_region_pass_matches_jax(mode, thresh):
    """Each half of the host pass against the reference's pass of that mode:
    the masks enter with the other half already done by the reference (its
    holes filled, or its small islands dropped), so what the host pass
    changes is this mode's work. Masks equal the reference's ``mode`` pass;
    flags equal the reference's whole cleanup (``cleanup_masks_jit``), which
    flags a mask whenever an island is small, also where keep-largest leaves
    it as it was."""
    H = W = 64
    frame = jnp.ones((H, W), bool)
    other = "islands" if mode == "holes" else "holes"
    ms = np.stack([jax_pass(m, frame, thresh, other)[0] for m in cases(2, H, W)])
    got, changed = host_pass(ms, (H, W), thresh)
    _, want_changed = jconn.cleanup_masks_jit(jnp.asarray(ms), jnp.ones(len(ms), bool), frame, thresh)
    np.testing.assert_array_equal(changed, np.asarray(want_changed))
    acted = 0
    for i, m in enumerate(ms):
        want, ch = jax_pass(m, frame, thresh, mode)
        np.testing.assert_array_equal(got[i], want, err_msg=f"case {i}")
        acted += ch
    assert acted, f"the {mode} pass changed none of the masks"


def test_region_pass_valid_region_matches_jax():
    """Padded-frame semantics: the padding must not bridge an edge pocket to
    the global background, and padding pixels never become mask."""
    C, h, w = 64, 40, 48
    m = np.zeros((C, C), bool)
    m[20:40, 10:40] = True
    m[32:40, 20:26] = False  # pocket open at the true bottom edge (row 39)
    got, changed = host_pass(m[None], (h, w), 100)
    frame = jvalid_mask((C, C), (h, w))
    want, want_changed = jconn.cleanup_masks_jit(jnp.asarray(m)[None], jnp.ones(1, bool), frame, 100)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert changed[0] and bool(want_changed[0])
    assert got[0, 32:40, 20:26].all() and not got[0, h:].any() and not got[0, :, w:].any()


@pytest.mark.parametrize("min_area", [12, 30])
def test_cleanup_proposals_matches_jax(min_area):
    """The whole bundle pass (cleanup + dedup NMS), through the runner's
    ``cleanup_host`` on a hand-off and through ``postprocess_small_regions``:
    equal to the reference's pass on tensors, with the in-place invalidation
    and the demotion of changed masks."""
    C, h, w, P = 64, 56, 64, 8
    cfg = tiny_smoke_config(min_mask_region_area=min_area)
    cfg = dataclasses.replace(cfg, amg=dataclasses.replace(cfg.amg, max_proposals=P))
    nms = max(cfg.amg.box_nms_thresh, cfg.amg.crop_nms_thresh)
    masks = _bundle_masks(3, C, h, w)
    want = jconn.cleanup_proposals_jit(_bundle(jamg, jnp.asarray, masks, P, C), jvalid_mask((C, C), (h, w)), min_area,
                                       nms)
    props = _bundle(tamg, torch.from_numpy, masks, P, C)
    got = runner.cleanup_host(cfg, props, (h, w), "cpu")
    assert isinstance(got.num, int) and got.num == int(want.num) and 0 < got.num < 6
    for name in ("masks", "valid", "boxes_xyxy", "areas", "iou_preds", "stability"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    host_in = tamg.Proposals(*(t.numpy() if isinstance(t, torch.Tensor) else t for t in props))
    host, changed = postprocess_small_regions(host_in, min_area, nms, hw=(h, w))
    assert changed and host.num == got.num
    for name in ("valid", "boxes_xyxy", "areas"):
        np.testing.assert_array_equal(getattr(host, name), getattr(got, name).numpy(), err_msg=name)
    # the bundle pass leaves a dead slot's pixels as they came; the hand-off's rows past the last live one are empty
    np.testing.assert_array_equal(host.masks & host.valid[:, None, None], got.masks.numpy())
    assert host.masks[6].any() and not got.masks[6].any()


def test_cleanup_leaves_dead_slots():
    """A dead slot is neither cleaned nor flagged: its mask comes back as it
    came, as the reference's pass returns it; the live slots as the
    reference's."""
    C, h, w, P = 64, 56, 64, 8
    props = _bundle(tamg, lambda v: v, _bundle_masks(4, C, h, w), P, C)
    got, changed = host_pass(props.masks, (h, w), 12, valid=props.valid)
    jprops = _bundle(jamg, jnp.asarray, _bundle_masks(4, C, h, w), P, C)
    want, want_changed = jconn.cleanup_masks_jit(jprops.masks, jprops.valid, jvalid_mask((C, C), (h, w)), 12)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(changed, np.asarray(want_changed))
    assert np.array_equal(got[6], props.masks[6]) and props.masks[6].any() and not changed[6]
    assert changed.any() and not changed[0]


@pytest.mark.parametrize("hw", [(40, 48), (64, 30), (1, 1)])
def test_cleanup_covers_only_the_valid_extent(hw):
    """Masks inside the image, as the AMG leaves them, in the padded frame:
    the host pass clips its crop windows to the image, so its masks and flags
    equal the reference's pass over the whole frame with the image's valid
    region, also where the image is one pixel."""
    C, P = 64, 8
    masks = [m & np.asarray(jvalid_mask((C, C), hw)) for m in _bundle_masks(5, C, 56, 64)]
    props = _bundle(tamg, lambda v: v, masks, P, C)
    jprops = _bundle(jamg, jnp.asarray, masks, P, C)
    got, changed = host_pass(props.masks, hw, 12, valid=props.valid)
    want, want_changed = jconn.cleanup_masks_jit(jprops.masks, jprops.valid, jvalid_mask((C, C), hw), 12)
    live = props.valid
    np.testing.assert_array_equal(got[live], np.asarray(want)[live])
    np.testing.assert_array_equal(changed[live], np.asarray(want_changed)[live])
    assert not got[:, hw[0]:].any() and not got[:, :, hw[1]:].any()


def test_native_library_loads_once_a_process(monkeypatch):
    """Threads that reach the first load together (the cleanup splits a
    bundle between them) build and load the library once, and all get it."""
    from hybridgl_tpu_torch.utils import native_build

    path = native_build.build("region_cleanup.cpp")
    builds = []

    def slow_build(source):
        builds.append(source)
        threading.Event().wait(0.05)  # long enough for every thread to arrive
        return path

    monkeypatch.setattr(postprocess_native, "_lib", None)
    monkeypatch.setattr(native_build, "build", slow_build)
    n = 2 * (os.cpu_count() or 1) + 2
    got, start = [None] * n, threading.Barrier(n)

    def load(i):
        start.wait(timeout=30)
        got[i] = postprocess_native.get_lib()

    threads = [threading.Thread(target=load, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert builds == ["region_cleanup.cpp"]
    assert got[0] is not None and all(lib is got[0] for lib in got)
    assert postprocess_native.get_lib() is got[0]


def test_native_library_build_failure_raises_the_compilers_message(monkeypatch, tmp_path):
    """A compiler that fails: the cleanup raises with its message, loads
    nothing, and tries again at the next call."""
    from hybridgl_tpu_torch.utils import native_build

    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'region_cleanup.cpp:1: error: no compiler here' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(postprocess_native, "_lib", None)
    m = np.zeros((1, 8, 8), bool)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no compiler here"):
            postprocess_native.cleanup_batch(m, np.zeros((1, 4), np.float32), np.ones(1, bool), (8, 8), 4)
        assert postprocess_native._lib is None
