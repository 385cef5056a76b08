"""Flag-compatible evaluation CLI of the port (counterpart of hybridgl_tpu/cli/main.py).

    python -m hybridgl_tpu_torch.cli.main --dataset refcoco --split val --fusion_mode G2L

Takes the reference's flags exactly (its ``default_argument_parser``,
including the vestigial detectron2 flags, parsed and ignored) plus
``--device``. The run goes through ``HybridGLPipeline.run_dataset`` and
writes the reference's result log (``result_log_<dataset>_<split>.txt``)
and, when asked, its per-sentence parity log and progress checkpoint.

The device is ``cuda`` unless the caller names ``--device cpu`` (where the
kernels run their plain versions); without a card the run stops rather
than falling back. Parameters are cast to ``PipelineConfig.compute_dtype``
(bf16 by default). Checkpoints are the converted ``.npz`` archives or the
published torch ``.pth``/``.pt`` files (converted on the fly by
``core/convert.py``); an orbax directory is refused. ``--profile`` prints the
per-stage wall times of ``utils/profiling.py:StageTimer``, then the top
operators of torch.profiler. Not ported yet (raises, see ROADMAP.md):
``--data_parallel``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

from ..core.config import AMG_PHRASECUT, AMG_REFCOCO, PipelineConfig
from ..eval.parity import ParityLog, SelectionRecord

from ..core import checkpoint, convert
from ..core.params import cast_tree, from_numpy_tree, init_clip, init_sam
from ..eval.logging import ProgressCheckpoint, write_result_log
from ..pipeline.runner import HybridGLPipeline, materialize_results


def default_argument_parser(epilog=None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(epilog=epilog, formatter_class=argparse.RawDescriptionHelpFormatter)
    # reference-compatible flags (utils.py:424-469); dist-era flags are
    # parsed and ignored for drop-in compatibility
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_false")
    p.add_argument("--num-gpus", type=int, default=1)
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    p.add_argument("--clip_model", default="ViT-B/16")
    p.add_argument("--visual_proj_path", default="./pretrain/")
    p.add_argument("--dataset", default="refcocog", help="refcoco, refcoco+, refcocog")
    p.add_argument("--split", default="val", help="val, testA, testB, test")
    p.add_argument("--fusion_mode", default="G2L")
    p.add_argument("--splitBy", default="umd")
    p.add_argument("--img_size", default=480, type=int)
    p.add_argument("--refer_data_root", default="./refer/data/")
    p.add_argument("--show_results", action="store_true")
    # additions of the JAX package
    p.add_argument("--sam_model", default="vit_h", help="vit_b, vit_l, vit_h")
    p.add_argument("--sam_checkpoint", default="", help="a converted .npz or a segment-anything .pth")
    p.add_argument("--clip_checkpoint", default="", help="a converted .npz or an OpenAI CLIP .pt")
    p.add_argument("--random-weights", action="store_true", help="random init from seed 0 (smoke runs)")
    p.add_argument("--max_proposals", type=int, default=0, help="proposal bucket override")
    p.add_argument("--max_images", type=int, default=0, help="truncate the eval set")
    p.add_argument("--log_dir", default="./result_log")
    p.add_argument("--parity_log", default="", help="write per-ref selection log here")
    p.add_argument("--progress_file", default="", help="checkpoint/resume eval progress")
    p.add_argument("--no-bug-compat", action="store_true", help="disable reference quirk reproduction")
    p.add_argument("--profile", action="store_true", help="print wall time per pipeline stage (device synchronised after each), then the top operators")
    p.add_argument("--trace_dir", default="", help="write a torch.profiler chrome trace here")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the eval over all local devices (not ported yet: raises)")
    # the port's addition
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    return p


def resolve_device(name: str) -> torch.device:
    """The named device; ``cuda`` without a card stops the run."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: expected cuda or cpu")
    return dev


def load_params(args, cfg: PipelineConfig, device):
    """(sam, clip) parameter trees on ``device`` in the config's compute dtype."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if args.random_weights:
        gen = torch.Generator(device=device).manual_seed(0)
        return cast_tree(init_sam(gen, cfg.sam), dtype), cast_tree(init_clip(gen, cfg.clip), dtype)
    if not args.sam_checkpoint or not args.clip_checkpoint:
        raise SystemExit(
            "--sam_checkpoint and --clip_checkpoint are required (or pass --random-weights for a "
            "smoke run). Convert torch checkpoints with tools/convert_checkpoints.py."
        )

    def load_one(path, loader, model_cfg):
        if path.endswith((".pth", ".pt")):
            tree, _ = loader(path, model_cfg)
        elif path.endswith(".npz"):
            tree = checkpoint.load(path)
        else:
            raise SystemExit(f"{path}: {checkpoint.ORBAX_REFUSAL}")
        return from_numpy_tree(tree, device, dtype)

    return (load_one(args.sam_checkpoint, convert.load_torch_sam, cfg.sam),
            load_one(args.clip_checkpoint, convert.load_torch_clip, cfg.clip))


def build_config(args) -> PipelineConfig:
    dataset = args.dataset
    split_by = "umd" if dataset == "refcocog" else "unc"
    amg = AMG_PHRASECUT if dataset == "phrasecut" else AMG_REFCOCO
    if args.max_proposals:
        import dataclasses

        amg = dataclasses.replace(amg, max_proposals=args.max_proposals)
    cfg = PipelineConfig(
        clip_model=args.clip_model,
        sam_model=args.sam_model,
        fusion_mode=args.fusion_mode,
        amg=amg,
        canonical_size=1024 if dataset == "phrasecut" else 640,
    )
    if args.clip_model == "test-tiny" or args.sam_model == "test-tiny":
        from ..core.config import tiny_smoke_config

        cfg = tiny_smoke_config(fusion_mode=args.fusion_mode, min_mask_region_area=amg.min_mask_region_area)
    if args.no_bug_compat:
        from ..core.config import CompatConfig

        cfg = cfg.replace(compat=CompatConfig(False, False, False))
    args.splitBy = split_by  # the reference overrides the flag (Hybridgl_main.py:26-29)
    return cfg


def build_dataset(args, cfg: PipelineConfig):
    """(dataset, ref ids) for the run."""
    if args.dataset == "phrasecut":
        from ..data.datasets import PhraseCutDataset

        dataset = PhraseCutDataset(args.refer_data_root, split=args.split, canonical=cfg.canonical_size)
        return dataset, list(range(len(dataset)))
    from ..data.datasets import ReferDataset

    dataset = ReferDataset(args.refer_data_root, args.dataset, args.splitBy, args.split,
                           sam_img_size=cfg.sam.img_size, canonical=cfg.canonical_size)
    return dataset, dataset.ref_ids


def main(argv=None) -> None:
    args = default_argument_parser().parse_args(argv)
    if not args.eval_only:
        raise SystemExit("Only eval_only available!")
    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel: multi-GPU evaluation is not ported yet (ROADMAP.md, Queue 1 item 13); "
            "run without it on one card"
        )
    device = resolve_device(args.device)
    cfg = build_config(args)
    sam_params, clip_params = load_params(args, cfg, device)
    pipe = HybridGLPipeline(cfg, sam_params, clip_params, device=device)
    # name the active expression parser: a silent heuristic fallback would
    # change selections against the reference
    print(f"expression parser: {type(pipe.parser).__name__}", flush=True)
    if args.profile:
        from ..utils.profiling import StageTimer

        pipe.timer = StageTimer(block=True, device=device)

    dataset, ref_ids = build_dataset(args, cfg)
    n = len(dataset)
    if args.max_images:
        n = min(n, args.max_images)
    state = pipe.init_state()
    progress = ProgressCheckpoint(args.progress_file or None)
    start = progress.load(state) if args.resume else 0
    parity = ParityLog(meta=dict(dataset=args.dataset, split=args.split, fusion=args.fusion_mode))

    from ..data.prefetch import IndexedPrefetcher

    profiling = args.profile or args.trace_dir
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof_ctx = torch.profiler.profile(activities=activities) if profiling else contextlib.nullcontext()
    t0 = time.time()
    images_done = 0
    with prof_ctx as prof:
        items = pipe.run_dataset(IndexedPrefetcher(_Sliced(dataset, start, n)), state,
                                 yield_props=args.show_results)
        for offset, item in enumerate(items):
            sample, results = item[:2]
            i = start + offset
            images_done += 1
            results = materialize_results(results)
            if args.show_results and images_done <= 50:
                _save_result_overlays(args.log_dir, i, sample, results, item[2])
            for r in results:
                parity.add(SelectionRecord(int(ref_ids[i]), r.sentence, r.pure_index, r.final_index,
                                           r.pure_iou, r.final_iou))
            if images_done % 20 == 0:
                rate = images_done / (time.time() - t0)
                print(
                    f"[{i + 1}/{n}] {rate:.2f} img/s | "
                    f"pure oIoU {100 * float(state.pure.cum_i) / max(float(state.pure.cum_u), 1):.2f} | "
                    f"final oIoU {100 * float(state.final.cum_i) / max(float(state.final.cum_u), 1):.2f}",
                    flush=True,
                )
                progress.save(i, state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = time.time() - t0
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
    if args.profile:
        print(pipe.timer.summary())
        key = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=key, row_limit=20))
    write_result_log(args.log_dir, args.dataset, args.split, args.splitBy, args.fusion_mode, state.pure, state.final)
    if args.parity_log:
        parity.save(args.parity_log)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"done: {images_done} images in {dt:.1f}s ({images_done / max(dt, 1e-9):.2f} img/s, "
          f"{1e3 * dt / max(images_done, 1):.1f} ms/img on {name})")


def _save_result_overlays(log_dir, index, sample, results, props):
    """--show_results: the selected masks over the image (the reference's
    demo.py:211-220 style), for the first 50 images."""
    import numpy as np

    from ..eval.viz import save_overlay

    out_dir = os.path.join(log_dir, "results_viz")
    os.makedirs(out_dir, exist_ok=True)
    img = np.asarray(sample.image_canonical)[: sample.h, : sample.w]
    masks = props.masks.cpu().numpy()
    gt = np.asarray(sample.gt_mask)[: sample.h, : sample.w] if sample.gt_mask is not None else None
    for si, r in enumerate(results):
        if r.final_index < 0:
            continue
        save_overlay(os.path.join(out_dir, f"{index:06d}_{si}.jpg"), img,
                     masks[r.final_index][: sample.h, : sample.w], gt_mask=gt)


class _Sliced:
    def __init__(self, dataset, start, stop):
        self.dataset, self.start, self.stop = dataset, start, stop

    def __len__(self):
        return max(0, self.stop - self.start)

    def __getitem__(self, i):
        return self.dataset[self.start + i]


def cli():
    main(sys.argv[1:])


if __name__ == "__main__":
    cli()
