"""The control: the reference one precision below the configuration's
(``benchref.quant.fp8``) put in the program's place, judged by the same
comparison as the program, at the cell's own sizes and checked images.

In the program's place it runs the automatic mask generator (every image of
the first cycle, as the program's runs are judged: its rows before the
cleanup), and, for the checked images, on the proposals the feature stage
would be handed (its cleaned survivors and the cell's stamped rows), its
features, GEM features, scores, picks and IoUs.
"""

from __future__ import annotations

import numpy as np
import torch

from benchref.quant import fp8

from . import check
from .config import benchmark_file, cell, load_json, model_settings, traffic
from .harness import reference_models
from .stamp import Stamp
from .traffic import Stream


def control_numbers(workload: str, seed: int, device="cuda", bench=None, cfg=None, mix=None) -> dict:
    """{position: numbers} of the control on the cell's checked images."""
    bench = bench or benchmark_file()
    w, conf = cell(bench, workload)
    cfg = cfg or load_json(conf["file"])
    mix = mix or traffic(w["traffic"])
    settings = model_settings(cfg, conf["file"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stream = Stream(mix, cfg, seed, settings)
    sam, clip = reference_models(cfg, settings, seed, dev)
    ref = check.Reference(sam, clip, cfg, settings)
    stamp = Stamp(stream.sizes, cfg["canonical_size"], mix["stamp_pool"], len(stream), dev, seed) \
        if stream.stamped else None
    checked = stream.checked(mix["check_images"], seed)
    out = {}
    for pos in range(len(stream)):  # the proposal stage: every image of the first cycle, as the program's runs
        sample = stream.sample(pos)
        h, w_ = sample.h, sample.w
        with fp8(sam, clip):
            rows, masks = ref.proposals(sample)
        if pos not in checked:
            out[pos] = check.proposal_gaps(ref, sample, rows)
            continue
        masks = [torch.from_numpy(m).to(dev) for m in masks]
        if stamp is not None:
            spec = stream.spec(pos)
            extra = max(spec.live - len(masks), 0)
            masks += list(stamp.masks[spec.size][stamp.order[pos % len(stamp.order)][:extra]][:, :h, :w_])
        live = torch.stack(masks) if masks else torch.zeros(0, h, w_, dtype=torch.bool, device=dev)
        boxes = check.boxes_of(live)
        L = live.shape[0]
        k = (min(cfg["guidance"]["k1"], L), min(cfg["guidance"]["k2"], L))
        with fp8(sam, clip):
            got = ref.control_output(sample, rows, live, boxes, k, torch.zeros(2, 4, device=dev))
        out[pos] = check.judge(ref, sample, got, k)
    return out
