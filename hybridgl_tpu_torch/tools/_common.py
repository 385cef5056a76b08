"""What the card tools share: the card's name and power limit, the refusal
without a card, full-width random weights, synthetic frames, CUDA-event timing."""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch


def require_card(tool: str) -> None:
    """Stop with exit code 2 where no CUDA card is present: nothing is timed on the CPU."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA card; nothing was timed", file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_line() -> str:
    """``name, power limit`` as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def sam_weights(sam_cfg, dtype=torch.bfloat16, seed: int = 0):
    """Random SAM params from ``seed`` on the card, with the weight-only products prepared."""
    from ..core.params import cast_tree, init_sam
    from ..models.sam.image_encoder import prepare_sam_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return prepare_sam_params(cast_tree(init_sam(gen, sam_cfg), dtype), sam_cfg)


def sam_frames(rng, n: int, S: int = 1024, rh: int = 768, rw: int = 1024):
    """``n`` padded [S, S, 3] uint8 frames with a random (rh, rw) image in the corner, on the card."""
    out = []
    for _ in range(n):
        a = np.zeros((S, S, 3), np.uint8)
        a[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
        out.append(torch.from_numpy(a).cuda())
    return out


def event_ms(fn, inputs, warmup: int = 1) -> float:
    """Median time of ``fn(x)`` over ``inputs``, CUDA events around each call
    after a synchronise (the host work inside the call is part of the time)."""
    for x in inputs[:warmup]:
        fn(x)
    times = []
    for x in inputs[warmup:]:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
