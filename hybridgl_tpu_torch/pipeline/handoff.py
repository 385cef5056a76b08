"""The proposal stage's hand-off to the host (the reference's runner.py:170-225
``proposal_stage`` and :495-528 ``_dispatch_proposals``).

Dispatch side, :func:`hand_off`, queued right behind the stage and waiting
on nothing: the masks packed to [P, C, C/8] uint8 on the device (the bit
order of ``np.packbits(axis=-1)``: a byte's first pixel in its high bit),
the per-proposal fields the host cleanup needs in one f32 ``aux`` buffer
(boxes, iou_preds, stability, points, areas: 9P floats) and the counts in
one int32 ``meta`` buffer (num, overflow, valid: 2 + P). The first
``PACKED_HEAD`` packed rows, ``aux`` and ``meta`` start copying into pinned
host memory of this dispatch's own, and an event marks their end. Without
a host cleanup (``min_mask_region_area`` 0) nothing is packed and only
``meta`` moves.

Finish side, :func:`receive`: one wait on that event, then ``meta`` gives
num, overflow and valid. The host cleanup (``runner.cleanup_host``) takes
its live rows from the prefetched head or from :func:`fetch_rows`.

On the CPU the same buffers are plain tensors and there is no event.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.sam.amg import Proposals
from ..utils.buckets import next_pow2
from ..utils.transfer import to_host_async, upload

PACKED_HEAD = 8  # packed rows copied at dispatch: random weights leave one NMS survivor


def _bits(device) -> torch.Tensor:
    """A byte's bit weights, first pixel in the high bit: [8] uint8, made on the device."""
    return (2 ** torch.arange(7, -1, -1, device=device)).to(torch.uint8)


class Handoff(NamedTuple):
    props: Proposals  # the device bundle; num and overflow int32 scalars there
    packed: Optional[torch.Tensor]  # [P, C, C/8] uint8 on the device, None without a host cleanup
    head: Optional[torch.Tensor]  # host copy of packed[:PACKED_HEAD]
    aux: Optional[torch.Tensor]  # host [9P] f32
    meta: torch.Tensor  # host [2 + P] int32: num, overflow, valid
    ready: Optional[torch.cuda.Event]  # recorded after the copies (None on the CPU)


def pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """[..., C] bool -> [..., ceil(C/8)] uint8, ``np.packbits(axis=-1)``'s bytes."""
    C = masks.shape[-1]
    m = masks.to(torch.uint8)
    if C % 8:
        m = torch.nn.functional.pad(m, (0, 8 - C % 8))
    return (m.reshape(*m.shape[:-1], -1, 8) * _bits(masks.device)).sum(-1, dtype=torch.uint8)


def unpack_masks(packed: torch.Tensor, C: int) -> torch.Tensor:
    """Inverse of :func:`pack_masks`: [..., ceil(C/8)] uint8 -> [..., C] bool."""
    return (packed[..., None] & _bits(packed.device)).ne(0).reshape(*packed.shape[:-1], -1)[..., :C]


def hand_off(props: Proposals, pack: bool) -> Handoff:
    """Queue the hand-off of a launched proposal bundle (see the module
    docstring); ``pack`` when the host cleanup will run."""
    dev = props.masks.device
    meta = torch.cat([upload(props.num, dev, torch.int32).reshape(1),
                      upload(props.overflow, dev, torch.int32).reshape(1), props.valid.to(torch.int32)])
    packed = head = aux = None
    if pack:
        packed = pack_masks(props.masks)
        head = to_host_async(packed[:PACKED_HEAD])
        aux = to_host_async(torch.cat([props.boxes_xyxy.float().reshape(-1), props.iou_preds.float(),
                                       props.stability.float(), props.points.float().reshape(-1),
                                       props.areas.float()]))
    meta = to_host_async(meta)
    ready = None
    if dev.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
    return Handoff(props, packed, head, aux, meta, ready)


def receive(handoff: Handoff) -> tuple[Proposals, np.ndarray]:
    """Wait for the dispatch's copies, then read ``meta``: the bundle with
    ``num`` and ``overflow`` as ints, and the validity [P] bool on the host."""
    if handoff.ready is not None:
        handoff.ready.synchronize()
    meta = handoff.meta.numpy()
    return handoff.props._replace(num=int(meta[0]), overflow=int(meta[1])), meta[2:].astype(bool)


def fetch_rows(handoff: Handoff, n_live: int) -> np.ndarray:
    """The first ``n_live`` packed rows on the host: from the prefetched head
    when it holds them, else a power-of-two bucket of rows sliced on the
    device and copied now. On the card the bucket's copy runs on a side
    stream that waits only on the hand-off's event, so it does not queue
    behind work launched after the dispatch (the next image's stage)."""
    if n_live <= handoff.head.shape[0]:
        return handoff.head.numpy()[:n_live]
    packed = handoff.packed
    rows = packed[: min(next_pow2(n_live, base=PACKED_HEAD), packed.shape[0])]
    if handoff.ready is None:
        return rows.numpy()[:n_live]
    side = torch.cuda.Stream(packed.device)  # from PyTorch's stream pool
    side.wait_event(handoff.ready)
    with torch.cuda.stream(side):
        host = to_host_async(rows)
    side.synchronize()
    return host.numpy()[:n_live]
