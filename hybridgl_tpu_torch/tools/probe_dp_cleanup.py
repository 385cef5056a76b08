"""Measure the host small-region cleanup of a data-parallel step: one image
against ``world`` images at once (counterpart of the reference's
tools/probe_dp_cleanup.py).

Under ``--data_parallel`` every rank runs the host cleanup of its own image
(``pipeline/runner.py:cleanup_host``), so ``world`` cleanups run on one host
at a time; if they serialise on its cores, data-parallel scaling flattens.
This probe isolates that host work, ``postprocess_small_regions`` over
representative [P, 640, 640] bundles (compact blobs with pepper noise and
holes, the expensive case for connected components), and reports

  serial     : the bundles one after another, one thread each
               (HYBRIDGL_CLEANUP_THREADS=1);
  pooled     : one after another, each with the per-mask thread pool at the
               host's core count;
  overlapped : all at once in ``world`` processes, one thread each, started
               together behind a barrier (``parallel/launch.py``: what
               ``world`` ranks on one host do; the time is the slowest
               rank's),

and checks that all three give the same masks, boxes and validity. Runs on
the host alone; no card is needed.

    python -m hybridgl_tpu_torch.tools.probe_dp_cleanup [world] [P]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def make_bundle(rng, P=64, C=640, hw=(480, 640), n_live=48):
    from ..models.sam.amg import Proposals

    h, w = hw
    masks = np.zeros((P, C, C), bool)
    boxes = np.zeros((P, 4), np.float32)
    valid = np.zeros(P, bool)
    for i in range(min(n_live, P)):
        cy, cx = rng.integers(60, h - 60), rng.integers(60, w - 60)
        ry, rx = rng.integers(30, 120), rng.integers(30, 120)
        y0, y1, x0, x1 = max(cy - ry, 0), min(cy + ry, h), max(cx - rx, 0), min(cx + rx, w)
        masks[i, y0:y1, x0:x1] = rng.random((y1 - y0, x1 - x0)) > 0.25  # noisy: many islands
        boxes[i] = [x0, y0, x1 - 1, y1 - 1]
        valid[i] = True
    return Proposals(masks, boxes, valid.astype(np.float32), valid.astype(np.float32), np.zeros((P, 2), np.float32),
                     masks.sum(axis=(1, 2)).astype(np.float32), valid, num=int(valid.sum()))


def run_one(bundle, hw, min_area=800, nms_thresh=0.7):
    from ..pipeline.postprocess import postprocess_small_regions

    b = bundle._replace(masks=bundle.masks.copy(), valid=bundle.valid.copy())
    return postprocess_small_regions(b, min_area, nms_thresh, hw=hw)[0]


def _digest(props) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in (props.masks, props.valid, props.boxes_xyxy):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _bundle(index: int, P: int, hw):
    return make_bundle(np.random.default_rng(index), P=P, C=max(hw), hw=hw, n_live=min(48, P))


def _overlapped_rank(P: int, hw) -> tuple[float, str]:
    """One rank of the overlapped run: its own bundle, cleaned after a barrier."""
    import torch.distributed as dist

    os.environ["HYBRIDGL_CLEANUP_THREADS"] = "1"
    bundle = _bundle(dist.get_rank(), P, hw)
    run_one(_bundle(0, min(P, 4), hw), hw)  # loads the native library
    dist.barrier()
    t0 = time.perf_counter()
    out = run_one(bundle, hw)
    return time.perf_counter() - t0, _digest(out)


def probe(world: int = 8, P: int = 64, hw=(480, 640), log=print) -> dict:
    """Times in seconds: {one_image, serial, pooled, overlapped}."""
    from ..parallel import launch

    bundles = [_bundle(i, P, hw) for i in range(world)]
    ncpu = os.cpu_count() or 1
    log(f"# nproc={ncpu} world={world} P={P} live={min(48, P)} noisy blobs")
    saved = os.environ.get("HYBRIDGL_CLEANUP_THREADS")
    out, times = {}, {}

    def timed(label, fn):
        t0 = time.perf_counter()
        res = fn()
        times[label] = time.perf_counter() - t0
        return res

    def report(label, n_items):
        log(f"{label:10s}: {times[label] * 1e3:8.1f} ms total, {times[label] / n_items * 1e3:7.1f} ms/img")

    try:
        os.environ["HYBRIDGL_CLEANUP_THREADS"] = "1"
        run_one(bundles[0], hw)  # builds the native library at first use
        timed("one_image", lambda: run_one(bundles[0], hw))
        report("one_image", 1)
        out["serial"] = [_digest(p) for p in timed("serial", lambda: [run_one(b, hw) for b in bundles])]
        report("serial", world)
        os.environ["HYBRIDGL_CLEANUP_THREADS"] = str(ncpu)
        out["pooled"] = [_digest(p) for p in timed("pooled", lambda: [run_one(b, hw) for b in bundles])]
        report("pooled", world)
    finally:
        if saved is None:
            os.environ.pop("HYBRIDGL_CLEANUP_THREADS", None)
        else:
            os.environ["HYBRIDGL_CLEANUP_THREADS"] = saved
    ranks = launch.spawn_workers(_overlapped_rank, world, (P, hw), "cpu", timeout=300.0)
    times["overlapped"], out["overlapped"] = max(t for t, _ in ranks), [d for _, d in ranks]
    report("overlapped", world)
    if not (out["serial"] == out["pooled"] == out["overlapped"]):
        raise AssertionError("the pooled or overlapped cleanup differs from the serial one")
    log("# pooled and overlapped results equal the serial ones")
    best = min(times["pooled"], times["overlapped"])
    log(f"# {world}-image wall over the 1-image wall: serial {times['serial'] / times['one_image']:.1f}x, "
        f"best threaded {best / times['one_image']:.1f}x")
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    probe(int(argv[0]) if argv else 8, int(argv[1]) if len(argv) > 1 else 64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
