"""Host-device copies that leave the stream running.

PyTorch makes a blocking copy between pageable host memory and the card
synchronise the host with the stream: the host waits for the copy, and the
copy waits for all the work queued before it. A constant uploaded that way
in the middle of the proposal stage makes the host wait for the stage it is
still dispatching, so nothing it does next overlaps the card. ``upload``
puts a number on the device as a fill and an array through pinned memory
with a non-blocking copy, and ``upload_into`` copies into a tensor that is
already there (a captured graph's input); ``to_host_async`` starts a copy
into pinned host memory that the caller waits for on an event. On the CPU
they are plain tensor operations.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch


def upload(x, device, dtype=None) -> torch.Tensor:
    """``x`` (a number, a sequence, a numpy array or a tensor) as a tensor on
    ``device``, with ``torch.as_tensor``'s dtype unless ``dtype`` is given,
    and without a stream synchronisation."""
    device = torch.device(device)
    if isinstance(x, numbers.Number):
        return torch.full((), x.item() if isinstance(x, np.generic) else x, dtype=dtype, device=device)
    t = x.to(dtype=dtype) if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=dtype)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, x) -> torch.Tensor:
    """Copy ``x`` (a numpy array or a tensor of ``dst``'s shape) into ``dst``
    without a stream synchronisation: from the host through a pinned buffer
    of this call's own (the caching host allocator keeps it until the copy
    has run), on the device as a copy in stream order."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if dst.device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return dst.copy_(t, non_blocking=True)


def to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: for a CUDA tensor, pinned memory that the copy
    fills once the stream reaches this point (record an event after it and
    wait on that before reading); a CPU tensor is its own host copy."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out
