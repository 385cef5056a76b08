"""The port's tensor connected components and small-region cleanup
(hybridgl_tpu_torch/kernels/connected.py) against the JAX package's on CPU,
on random and hand-made masks as tests/test_connected.py builds them, and
against the port's own native host cleanup on the same masks. Everything is
exact: labels, sizes, cleaned masks, flags, boxes, validity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridgl_tpu.kernels import connected as jconn
from hybridgl_tpu.kernels.resize import valid_mask as jvalid_mask
from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu_torch.kernels import connected as conn
from hybridgl_tpu_torch.kernels.resize import valid_mask
from hybridgl_tpu_torch.models.sam import amg as tamg
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


def test_label_components_and_sizes_match_jax():
    for i, m in enumerate(cases(0, 40, 56)):
        want = jconn.label_components(jnp.asarray(m))
        got = conn.label_components(torch.from_numpy(m))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"case {i}")
        np.testing.assert_array_equal(conn.component_sizes(got).numpy(), np.asarray(jconn.component_sizes(want)),
                                      err_msg=f"case {i}")


def test_label_components_batched_equals_one_by_one():
    """A batch is labelled in one go, each mask with its own flat indices."""
    ms = np.stack(cases(1))
    batched = conn.label_components(torch.from_numpy(ms))
    assert batched.shape == ms.shape
    for i, m in enumerate(ms):
        one = conn.label_components(torch.from_numpy(m))
        assert torch.equal(batched[i], one), f"case {i}"
        # the label is the least flat index of its component; outside the set it is H * W
        lab = one.numpy()
        assert (lab[~m] == m.size).all()
        for v in np.unique(lab[m]):
            ys, xs = np.nonzero(lab == v)
            assert v == (ys * m.shape[1] + xs).min()
    sizes = conn.component_sizes(batched)
    assert torch.equal(sizes[0], conn.component_sizes(batched[0]))
    assert int(sizes[-1].max()) == ms[-1].size and int(sizes[-2].max()) == 0


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("thresh", [6, 40, 2000])
def test_remove_small_regions_jit_matches_jax(mode, thresh):
    H = W = 48
    ms = cases(2, H, W)
    vm_j, vm_t = jnp.ones((H, W), bool), torch.ones((H, W), dtype=torch.bool)
    got_b, changed_b = conn.remove_small_regions_jit(torch.from_numpy(np.stack(ms)), vm_t, thresh, mode)
    for i, m in enumerate(ms):
        want, ch_w = jconn.remove_small_regions_jit(jnp.asarray(m), vm_j, thresh, mode)
        got, ch_g = conn.remove_small_regions_jit(torch.from_numpy(m), vm_t, thresh, mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"case {i}")
        assert bool(ch_g) == bool(ch_w), f"case {i}"
        assert torch.equal(got_b[i], got) and bool(changed_b[i]) == bool(ch_g)


def test_remove_small_regions_jit_valid_region_matches_jax():
    """Padded-frame semantics: the padding must not bridge an edge pocket to
    the global background, and padding pixels never become mask."""
    C, h, w = 64, 40, 48
    m = np.zeros((C, C), bool)
    m[20:40, 10:40] = True
    m[32:40, 20:26] = False  # pocket open at the true bottom edge (row 39)
    want, ch_w = jconn.remove_small_regions_jit(jnp.asarray(m), jvalid_mask((C, C), (h, w)), 100, "holes")
    got, ch_g = conn.remove_small_regions_jit(torch.from_numpy(m), valid_mask((C, C), (h, w)), 100, "holes")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(ch_g) and bool(ch_w)
    assert got[32:40, 20:26].all() and not got[h:].any() and not got[:, w:].any()


def _bundle(module, to_array, masks, P, C):
    n = len(masks)
    arr = np.zeros((P, C, C), bool)
    boxes = np.zeros((P, 4), np.float32)
    for i, m in enumerate(masks):
        arr[i] = m
        ys, xs = np.nonzero(m)
        boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
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


@pytest.mark.parametrize("min_area", [12, 30])
def test_cleanup_proposals_jit_matches_jax_and_the_native_host_pass(min_area):
    """The whole bundle pass (cleanup + dedup NMS): equal to the reference's
    device pass, and to the port's native host pass on the same bundle, with
    the in-place invalidation and the demotion of changed masks."""
    C, h, w, P = 64, 56, 64, 8
    masks = _bundle_masks(3, C, h, w)
    want = jconn.cleanup_proposals_jit(_bundle(jamg, jnp.asarray, masks, P, C), jvalid_mask((C, C), (h, w)), min_area, 0.7)
    props = _bundle(tamg, torch.from_numpy, masks, P, C)
    got = conn.cleanup_proposals_jit(props, valid_mask((C, C), (h, w)), min_area, 0.7)
    assert isinstance(got.num, int) and got.num == int(want.num) and 0 < got.num < 6
    for name in ("masks", "valid", "boxes_xyxy", "areas", "iou_preds", "stability"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    host_in = tamg.Proposals(*(t.numpy() if isinstance(t, torch.Tensor) else t for t in props))
    host, changed = postprocess_small_regions(host_in, min_area, 0.7, hw=(h, w))
    assert changed and host.num == got.num
    for name in ("valid", "boxes_xyxy", "areas"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(host, name)), err_msg=name)
    # the host pass leaves a dead slot's pixels as they came, the device pass clears them (as the reference's does)
    np.testing.assert_array_equal(got.masks.numpy(), host.masks & host.valid[:, None, None])
    assert host.masks[6].any() and not got.masks[6].any()


def test_cleanup_masks_jit_batches_and_leaves_dead_slots():
    """One labelling for the bundle or one mask at a time: the same masks and
    flags; a dead slot's mask is returned as it came."""
    C, h, w, P = 64, 56, 64, 8
    props = _bundle(tamg, torch.from_numpy, _bundle_masks(4, C, h, w), P, C)
    vm = valid_mask((C, C), (h, w))
    all_at_once = conn.cleanup_masks_jit(props.masks, props.valid, vm, 12)
    one_by_one = conn.cleanup_masks_jit(props.masks, props.valid, vm, 12, max_batch_pixels=1)
    assert torch.equal(all_at_once[0], one_by_one[0]) and torch.equal(all_at_once[1], one_by_one[1])
    assert torch.equal(all_at_once[0][6], props.masks[6]) and props.masks[6].any() and not bool(all_at_once[1][6])
    assert bool(all_at_once[1].any()) and not bool(all_at_once[1][0])


@pytest.mark.parametrize("hw", [(40, 48), (64, 30), (1, 1)])
def test_cleanup_masks_jit_labels_only_the_valid_extent(hw):
    """The port labels only the rows and columns the image reaches; masks and
    flags equal the reference's pass over the whole padded frame, also for a
    live mask with pixels in the padding (the islands pass drops them)."""
    C, P = 64, 8
    masks = _bundle_masks(5, C, 56, 64)
    masks[0][60:63, 50:60] = True  # in the padding of every frame here
    props = _bundle(tamg, torch.from_numpy, masks, P, C)
    jprops = _bundle(jamg, jnp.asarray, masks, P, C)
    got, changed = conn.cleanup_masks_jit(props.masks, props.valid, valid_mask((C, C), hw), 12)
    want, want_changed = jconn.cleanup_masks_jit(jprops.masks, jprops.valid, jvalid_mask((C, C), hw), 12)
    live = props.valid.numpy()
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])
    np.testing.assert_array_equal(changed.numpy()[live], np.asarray(want_changed)[live])
    assert not got[0, hw[0]:].any() and not got[0, :, hw[1]:].any()
    assert torch.equal(got[6], props.masks[6])  # the dead slot as it came
