"""The occupancy stamp: realistic live-proposal counts on random weights.

Random weights leave about one proposal an image. Where a traffic mix gives
``live_proposals``, the stamp, run through the pipeline's
``survival_hook`` after the small-region cleanup, sets the bundle's live
count to the image's drawn count: the rows after the real survivors take
masks and boxes gathered on the device, by indices drawn at set-up, from a
pool of rectangles and ellipses made at set-up inside each image size of the
stream. ``num`` is set as an int and ``valid`` as a host tensor, so the
runner sizes the scoring bucket without reading the device; the stamp itself
makes no read and no stream synchronisation (the traced run counts them).
"""

from __future__ import annotations

import numpy as np
import torch


class Stamp:
    def __init__(self, sizes, canonical: int, pool: int, cycle: int, device, seed: int):
        g = torch.Generator().manual_seed(seed % 2**63)
        C = canonical
        y = torch.arange(C, device=device, dtype=torch.float32)[None, :, None]
        x = torch.arange(C, device=device, dtype=torch.float32)[None, None, :]
        self.masks, self.boxes = [], []
        for h, w in sizes:
            u = torch.rand(pool, 5, generator=g)
            ry = (0.06 + 0.34 * u[:, 0]) * h / 2
            rx = (0.06 + 0.34 * u[:, 1]) * w / 2
            cy = ry + u[:, 2] * (h - 2 * ry)
            cx = rx + u[:, 3] * (w - 2 * rx)
            ellipse = (u[:, 4] < 0.5).to(device)[:, None, None]
            cy, cx, ry, rx = (t.to(device)[:, None, None] for t in (cy, cx, ry, rx))
            rect = ((y - cy).abs() <= ry) & ((x - cx).abs() <= rx)
            ell = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0
            m = torch.where(ellipse, ell, rect)
            self.masks.append(m)
            rows, cols = m.any(-1), m.any(-2)
            idx = torch.arange(C, device=device)
            box = torch.stack([torch.where(cols, idx, C).amin(-1), torch.where(rows, idx, C).amin(-1),
                               torch.where(cols, idx, -1).amax(-1), torch.where(rows, idx, -1).amax(-1)], -1)
            self.boxes.append(box.float())
        self.order = [torch.randperm(pool, generator=g).to(device) for _ in range(cycle)]

    def __call__(self, props, spec, position: int):
        """The bundle with ``spec.live`` live rows (the real survivors first)."""
        n_real = props.num
        n = max(spec.live, n_real)
        P = props.masks.shape[0]
        if n > n_real:
            idx = self.order[position % len(self.order)][: n - n_real]
            props.masks[n_real:n] = self.masks[spec.size][idx]
            props.boxes_xyxy[n_real:n] = self.boxes[spec.size][idx]
        valid = torch.from_numpy(np.arange(P) < n)
        return props._replace(valid=valid, num=n)
