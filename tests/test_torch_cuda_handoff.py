"""The proposal stage's hand-off on the card (``pipeline/handoff.py``): the
packed, live-row host cleanup against the same cleanup on the CPU, and the
prefetch started at dispatch against work queued behind it. Marked ``cuda``;
each test skips where no CUDA card is present."""

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core.config import AMG_PHRASECUT, PipelineConfig
from hybridgl_tpu_torch.models.sam.amg import Proposals
from hybridgl_tpu_torch.pipeline import handoff, runner

pytestmark = pytest.mark.cuda

P, C, HW = 128, 1024, (480, 640)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bundle(n_live, seed, device):
    """PhraseCut's geometry (P = 128 slots of 1024^2): ``n_live`` rectangles
    in the 480 x 640 corner, each with a hole and an island of 799 pixels
    (cleaned away at min_mask_region_area 800) or 801 (kept), every fourth
    slot below the last live one dead."""
    rng = np.random.default_rng(seed)
    h, w = HW
    masks = np.zeros((P, C, C), bool)
    boxes = np.zeros((P, 4), np.float32)
    for i in range(n_live):
        y0, x0 = int(rng.integers(0, h - 150)), int(rng.integers(0, w - 200))
        hh, ww = int(rng.integers(60, 120)), int(rng.integers(100, 200))
        masks[i, y0 : y0 + hh, x0 : x0 + ww] = True
        hy, hx = (17, 47) if i % 2 else (9, 89)  # 799 or 801 pixels
        masks[i, y0 + 10 : y0 + 10 + hy, x0 + 5 : x0 + 5 + hx] = False
        iy, ix = (17, 47) if (i // 2) % 2 else (9, 89)
        masks[i, h - iy : h, :ix] = True
        ys, xs = np.nonzero(masks[i])
        boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    valid = np.arange(P) < n_live
    valid[: n_live - 1 : 4] = False
    boxes *= valid[:, None]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ones = t(valid.astype(np.float32))
    return Proposals(t(masks), t(boxes), ones, ones, t(np.zeros((P, 2), np.float32)),
                     t(masks.sum((-2, -1)).astype(np.float32)), t(valid),
                     num=torch.tensor(int(valid.sum()), dtype=torch.int32, device=device),
                     overflow=torch.zeros((), dtype=torch.int32, device=device))


def test_packed_handoff_on_the_card_equals_the_cpu(dev, monkeypatch):
    """48 live rows of 1024^2 (past the 8-row head: a bucket of 64 rows is
    sliced on the card and copied on the side stream): the cleanup's bundle
    equals the same cleanup's on the CPU, masks, boxes, valid, num and areas,
    and the copies to the host are the pinned head, aux, meta and the bucket."""
    cfg = PipelineConfig(canonical_size=C, amg=AMG_PHRASECUT)
    copies = []
    to_host = handoff.to_host_async
    monkeypatch.setattr(handoff, "to_host_async", lambda t: copies.append(tuple(t.shape)) or to_host(t))
    got = runner.cleanup_host(cfg, _bundle(48, 0, dev), HW, dev)
    want = runner.cleanup_host(cfg, _bundle(48, 0, "cpu"), HW, "cpu")
    assert got.masks.is_cuda and got.num == want.num and 0 < got.num < 48
    for name in ("masks", "boxes_xyxy", "valid", "areas"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert (64, C, C // 8) in copies and (handoff.PACKED_HEAD, C, C // 8) in copies and (2 + P,) in copies


def test_prefetched_head_is_complete_after_the_event(dev):
    """The head, aux and meta copies are queued right behind the stage; their
    event completes while a long run of products queued after them is still
    going, and the host buffers then hold the bundle's bytes."""
    props = _bundle(5, 1, dev)
    want_head = torch.from_numpy(np.packbits(props.masks[: handoff.PACKED_HEAD].cpu().numpy(), axis=-1))
    want_meta = torch.cat([props.num.reshape(1), props.overflow.reshape(1), props.valid.int()]).cpu()
    torch.cuda.synchronize()
    h = handoff.hand_off(props, pack=True)
    x = torch.randn(8192, 8192, device=dev)
    for _ in range(40):  # ~1 s of products behind the copies
        x = x @ x.T * 1e-4
    tail = torch.cuda.Event()
    tail.record()
    received, valid = handoff.receive(h)
    assert not tail.query(), "the wait took the work queued after the hand-off with it"
    assert h.head.is_pinned() and h.aux.is_pinned() and h.meta.is_pinned()
    assert torch.equal(h.head, want_head) and torch.equal(h.meta, want_meta)
    assert received.num == 4 and np.array_equal(valid, want_meta[2:].numpy().astype(bool))
    torch.cuda.synchronize()
