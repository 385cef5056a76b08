"""Rank functions: what one rank of a multi-process run does, for the callers
that start such runs through ``launch.spawn_workers`` (the tests, the dry run,
``chip_smoke.py``, ``tools/probe_dp_cleanup.py``). Each takes one ``spec``
dict that pickles (configs, paths, host arrays) and returns a dict that
pickles. Every rank loads its own copy of the weights: converted ``.npz``
archives (``spec["sam"]``, ``spec["clip"]``) or a random init from
``spec["seed"]`` drawn on the rank's own device; nothing large crosses the
spawn pipe.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import checkpoint
from ..core.params import cast_tree, from_numpy_tree, init_clip, init_sam
from ..kernels import launch_counts, reset_launch_counts, tc_launch_counts
from ..models.sam.amg import Proposals
from . import launch


def _dtype(spec):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[spec.get("dtype", "float32")]


def load_weights(spec, cfg, device, which=("sam", "clip")):
    """The (sam, clip) trees a spec names, on ``device`` in ``spec["dtype"]``
    (None for a tree that ``which`` leaves out)."""
    dt = _dtype(spec)
    if "seed" in spec:
        gen = torch.Generator(device=device).manual_seed(spec["seed"])
        sam = cast_tree(init_sam(gen, cfg.sam), dt)  # drawn first whatever `which` says: one stream
        clip = cast_tree(init_clip(gen, cfg.clip), dt) if "clip" in which else None
        return sam, clip
    return tuple(from_numpy_tree(checkpoint.load(spec[k]), device, dt) if k in which else None for k in ("sam", "clip"))


def _mesh(spec):
    from .mesh import make_mesh, make_mesh_2d

    mp = spec.get("mp", 1)
    return (make_mesh_2d(mp=mp), "mp") if mp > 1 else (make_mesh(), None)


def _tokenizer(spec):
    if spec.get("tokenizer") == "tiny":
        from ..tools.dryrun import TinyVocabTokenizer

        return TinyVocabTokenizer()
    from ..models.clip.tokenizer import default_tokenizer

    return default_tokenizer()


def stamped_survivors(cfg, n_live: int, seed: int, hw, device) -> Proposals:
    """``n_live`` live blob masks in ``max_proposals`` slots of the canonical
    frame: a smooth random field from ``seed`` (numpy, so every process draws
    the same) thresholded at 0 inside the ``hw`` image, with boxes to match."""
    from ..kernels.masks import mask_to_box

    (h, w), C, P = hw, cfg.canonical_size, cfg.amg.max_proposals
    n_live = min(n_live, P)
    coarse = np.random.default_rng(seed).standard_normal((n_live, 1, max(h // 32, 2), max(w // 32, 2))).astype(np.float32)
    blobs = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(h, w), mode="bilinear")[:, 0] > 0
    masks = torch.zeros((P, C, C), dtype=torch.bool)
    masks[:n_live, :h, :w] = blobs
    masks = masks.to(device)
    valid = torch.arange(P, device=device) < n_live
    ones = valid.float()
    return Proposals(masks, mask_to_box(masks) * ones[:, None], ones, ones, torch.zeros((P, 2), device=device),
                     masks.sum((-2, -1)).float(), valid, num=n_live, overflow=0)


def survival_stamp(cfg, pattern, hw, device, image_of=lambda call: call):
    """A ``survival_hook`` that replaces the bundle of the image
    ``image_of(call)`` (``call`` counts the hook's calls from 0) with
    ``pattern[image % len(pattern)]`` stamped survivors, seeded by the image:
    random weights leave one survivor an image, so a comparison of selections
    and of the k1/k2 clamp needs bundles that range over many proposals and
    whose counts move from image to image. The sequential runner calls it in
    dataset order; a rank passes its place in the chunks as ``image_of``."""
    calls = [0]

    def stamp(props):
        image = image_of(calls[0])
        calls[0] += 1
        return stamped_survivors(cfg, pattern[image % len(pattern)], 1000 + image, hw, device)

    return stamp


def eval_worker(spec) -> dict:
    """``full_eval.run_chunks`` over ``spec["samples"]`` (ImageSamples) at
    ``spec["cfg"]`` on a ``dp x spec["mp"]`` mesh, ``spec["repeats"]`` times
    (the last one is kept and timed); with ``spec["survival"]`` (a pattern of
    live counts) and ``spec["survival_hw"]`` every image's bundle is replaced
    by :func:`survival_stamp`'s. Rank 0 returns the per-sentence
    records ``(image, sentence index, pure_idx, final_idx, pure_iou,
    final_iou)``, the summed accumulators and the final clamp; every rank its
    kernel launch counts and seconds."""
    from ..lang import HeuristicParser
    from .full_eval import run_chunks

    cfg, device = spec["cfg"], launch.worker_device()
    mesh, mp_axis = _mesh(spec)
    sam_params, clip_params = load_weights(spec, cfg, device)
    from ..models.sam.image_encoder import prepare_sam_params

    sam_params = prepare_sam_params(sam_params, cfg.sam)
    parser, tokenizer = HeuristicParser(rela_right_bug=cfg.compat.rela_right_bug), _tokenizer(spec)
    out = {}
    for _ in range(spec.get("repeats", 1)):
        reset_launch_counts()
        hook = None
        if spec.get("survival"):
            hook = survival_stamp(cfg, spec["survival"], spec["survival_hw"], device,
                                  lambda call: call * mesh.dp + mesh.dp_index)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        records, pure, final = [], np.zeros(4), np.zeros(4)
        k1, k2, at = cfg.guidance.k1, cfg.guidance.k2, 0
        for chunk, result in run_chunks(cfg, sam_params, clip_params, parser, tokenizer, mesh, iter(spec["samples"]),
                                        k1, k2, mp_axis=mp_axis, survival_hook=hook):
            if result is not None:
                pa, fa, pidx, fidx, pious, fious, k1, k2 = result
                pure += np.float64([float(v) for v in pa])
                final += np.float64([float(v) for v in fa])
                for b, sample in enumerate(chunk):
                    for si in range(len(sample.sentences)):
                        records.append((at + b, si, int(pidx[b, si]), int(fidx[b, si]), float(pious[b, si]), float(fious[b, si])))
            at += len(chunk)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out = dict(rank=mesh.rank, seconds=time.perf_counter() - t0, launches=launch_counts(), tc_launches=tc_launch_counts(),
                   records=records, pure=pure.tolist(), final=final.tolist(), k1=k1, k2=k2, images=at)
    return out


def sharded_step_worker(spec) -> dict:
    """``mesh.build_sharded_eval_step`` on ``spec["batch"]`` (a global
    EvalBatch): the summed accumulator and the gathered selections."""
    from .mesh import build_sharded_eval_step, shard_batch

    cfg, device = spec["cfg"], launch.worker_device()
    mesh, mp_axis = _mesh(spec)
    sam_params, clip_params = load_weights(spec, cfg, device)
    step = build_sharded_eval_step(cfg, mesh, mp_axis=mp_axis)
    acc, sels = step(sam_params, clip_params, shard_batch(spec["batch"], mesh))
    return dict(rank=mesh.rank, acc=[float(v) for v in acc], sels=sels.cpu().numpy())


def encoder_tp_worker(spec) -> dict:
    """``encoder_tp.encode_image_tp`` over an ``mp`` axis of every rank on
    ``spec["image"]`` ([1, S, S, 3] f32), ``spec["repeats"]`` times (the last
    is timed); with ``spec["compare"]`` also the single-process
    ``encode_image`` on this rank, returned as the cosine and the largest
    difference instead of the arrays."""
    from ..models.sam.image_encoder import encode_image, prepare_sam_params
    from .encoder_tp import encode_image_tp, shard_encoder_params
    from .mesh import make_mesh_2d

    cfg, device = spec["cfg"], launch.worker_device()
    mesh = make_mesh_2d(mp=spec["mp"])
    sam_params, _ = load_weights(spec, cfg, device, which=("sam",))
    p_enc = prepare_sam_params({"encoder": sam_params["encoder"]}, cfg.sam)["encoder"]
    local = shard_encoder_params(p_enc, cfg.sam, mesh.mp_index, mesh.mp)
    image = torch.from_numpy(spec["image"]).to(device)
    for _ in range(spec.get("repeats", 1)):
        reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        got = encode_image_tp(local, image, cfg.sam, mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    out = dict(rank=mesh.rank, seconds=seconds, launches=launch_counts(), tc_launches=tc_launch_counts())
    if spec.get("compare"):
        with torch.no_grad():
            want = encode_image(p_enc, image, cfg.sam).float().flatten()
        g = got.float().flatten()
        out["cos"] = float(torch.dot(g, want) / (g.norm() * want.norm()))
        out["max_abs_diff"] = float((g - want).abs().max())
        out["finite"] = bool(torch.isfinite(g).all())
    else:
        out["output"] = got.float().cpu().numpy()
    return out


def fail_on_rank_one() -> None:
    """Raises on rank 1 while the other ranks wait in a collective (what the
    launcher's failure handling is tested with)."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleep_forever() -> None:
    """Never returns (what the launcher's time limit is tested with)."""
    while True:
        time.sleep(1.0)
