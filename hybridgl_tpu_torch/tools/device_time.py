"""Device time per image of the two full-width paths, from torch.profiler.

Builds the RefCOCO and the PhraseCut pipeline as ``chip_smoke.py`` does (SAM
ViT-H + CLIP ViT-B/16, random bf16 weights from seed 0, the AMG's quality
thresholds zeroed, synthetic 480x640 images), runs one warm-up image, two
timed images (host clock around a synchronise) and one image under
torch.profiler, and prints for each path the wall time, the device time
summed over every kernel and copy, the busy share, the largest device
items, the copies from the device into pageable host memory (count, bytes
and device ms, from the profiler), the peak device memory of the timed
images, and the reads to the host by call site: one more image under a
dispatch mode that records every device-to-host transfer with the innermost
frame of the package that asked for it. Both paths are host bound, so a
kernel's gain shows in the device time long before it shows in ms per
image. Uses only the package's public entry points, so the same file times
an older tree when copied into it. Needs a CUDA card.

    python -m hybridgl_tpu_torch.tools.device_time [refcoco] [phrasecut]   (default: both)
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

SENTENCES = ["the large brown dog on the left", "person behind the table"]
# substrings of the port's own kernels' names: listed wherever they rank
OWN_KERNELS = ("rel_pos_", "resident_kernel", "attention_kernel", "pass1_stats", "decoder_attn", "upscale_hyper",
               "nms_")
PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pageable_downloads(prof) -> dict:
    """{copies, bytes, device_ms} of the profiled copies from the device into
    pageable host memory. The byte counts are CUPTI's, which only the
    exported trace carries (``args.bytes``); bytes is None where no copy has
    one."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "") and "Pageable" in e.get("name", "")]
    counted = [e["args"]["bytes"] for e in copies if "bytes" in e.get("args", {})]
    return dict(copies=len(copies), bytes=sum(counted) if counted else None,
                device_ms=sum(e["dur"] for e in copies) / 1e3)


def profile_image(pipe, sample, state, log=print, top_n: int = 12) -> dict:
    """One ``run_image`` under torch.profiler: {wall_ms, device_ms, launches,
    dtoh_pageable: pageable_downloads}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_image(sample, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_total = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"  profiled image: wall {wall:.1f} ms, device time {device_total:.1f} ms over "
        f"{launches} kernels and copies (busy share {device_total / wall:.2f}, profiler on)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    for e in top + [e for e in kernels if e not in top and any(n in e.key for n in OWN_KERNELS)]:
        log(f"  device {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    down = pageable_downloads(prof)
    size = "bytes not measured" if down["bytes"] is None else f"{down['bytes']} bytes ({down['bytes'] / 1e6:.1f} MB)"
    log(f"  pageable DtoH: {down['copies']} copies, {size}, {down['device_ms']:.2f} ms of device time")
    return dict(wall_ms=wall, device_ms=device_total, launches=launches, dtoh_pageable=down)


def _call_site() -> str:
    """The innermost frame of the package outside this file, as path:line (function)."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(PACKAGE) and not frame.filename.endswith("device_time.py"):
            return f"{os.path.relpath(frame.filename, os.path.dirname(PACKAGE))}:{frame.lineno} ({frame.name})"
    return "outside the package"


def host_reads(fn, log=print) -> list:
    """Run ``fn()`` under a dispatch mode that records every transfer from the
    device to the host (a copy into a CPU tensor, or a scalar read) with its
    call site, and log them: [(site, transfers, bytes)], most bytes first."""
    from torch.utils._python_dispatch import TorchDispatchMode

    sites = collections.defaultdict(lambda: [0, 0])

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            src = next((a for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)
            to_host = func is torch.ops.aten._local_scalar_dense.default or (
                isinstance(out, torch.Tensor) and out.device.type == "cpu")
            if src is not None and to_host:
                site = sites[_call_site()]
                site[0] += 1
                site[1] += src.numel() * src.element_size()
            return out

    with Reads():
        fn()
    torch.cuda.synchronize()
    reads = sorted(((k, n, b) for k, (n, b) in sites.items()), key=lambda r: -r[2])
    total = sum(b for _, _, b in reads)
    log(f"  reads to the host by call site (dispatch mode): {sum(n for _, n, _ in reads)} transfers, "
        f"{total} bytes ({total / 1e6:.1f} MB)")
    for site, n, b in reads:
        log(f"    {b:>12d} bytes  x{n:<5d} {site}")
    return reads


def _sample(rng, canonical, h=480, w=640, rh=768, rw=1024):
    from ..pipeline.runner import ImageSample

    img1024 = np.zeros((1024, 1024, 3), np.uint8)
    img1024[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((canonical, canonical, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    gt = np.zeros((canonical, canonical), bool)
    gt[100:300, 150:400] = True
    return ImageSample(img1024, rh, rw, imgc, h, w, gt, SENTENCES)


def main(argv=None) -> int:
    argv = [a.lower() for a in (sys.argv[1:] if argv is None else argv)]
    if not torch.cuda.is_available():
        print("device_time: no CUDA card; nothing was timed", file=sys.stderr)
        return 2
    from ..core.config import AMG_PHRASECUT, AMG_REFCOCO, PipelineConfig
    from ..core.params import cast_tree, init_clip, init_sam
    from ..lang import HeuristicParser
    from ..models.clip.tokenizer import default_tokenizer
    from ..pipeline.runner import HybridGLPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    weights = cast_tree(init_sam(gen, base.sam), torch.bfloat16), cast_tree(init_clip(gen, base.clip), torch.bfloat16)
    for tag, amg, canonical in (("RefCOCO", AMG_REFCOCO, 640), ("PhraseCut", AMG_PHRASECUT, 1024)):
        if argv and tag.lower() not in argv:
            continue
        cfg = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16", fusion_mode="G2L", canonical_size=canonical,
                             amg=dataclasses.replace(amg, pred_iou_thresh=0.0, stability_score_thresh=0.0))
        pipe = HybridGLPipeline(cfg, *weights, HeuristicParser(), default_tokenizer(), device=torch.device("cuda"))
        rng = np.random.default_rng(0)
        samples = [_sample(rng, canonical) for _ in range(4)]
        state = pipe.init_state()
        times = []
        for i, sample in enumerate(samples[:3]):  # the first is the warm-up
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_image(sample, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{tag}: ms/img {[round(t, 1) for t in times[1:]]} after a warm-up of {times[0]:.1f} ms, peak device "
              f"memory {torch.cuda.max_memory_allocated()} bytes "
              f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", flush=True)
        profile_image(pipe, samples[3], state, log=lambda m: print(m, flush=True))
        host_reads(lambda: pipe.run_image(samples[3], state), log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
