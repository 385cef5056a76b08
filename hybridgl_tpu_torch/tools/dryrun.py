"""Entry points for a quick check of the port: a single-device forward step
and a multi-device dry run (counterpart of the reference's
``__graft_entry__.py``).

    python -m hybridgl_tpu_torch.tools.dryrun [--ranks 4] [--device cuda|cpu]

* :func:`entry` returns ``(fn, example_args)``: the hybrid G2L fusion scoring
  forward on CLIP ViT-B/16 over a bucket of proposals (the per-image scoring
  core of the pipeline).
* :func:`dryrun_multichip` starts ``n`` ranks (``parallel/launch.py``) and
  runs the real ``--data_parallel`` path on a tiny configuration that it
  builds itself: three passes of the sticky step + :func:`finalize_sticky`
  (a 2D ``dp x mp`` mesh; pure ``dp`` with ragged sentence counts; multicrop
  AMG), each checking the count of IoU updates, then the tensor-parallel
  encoder against the single-process one (max|d| < 2e-4 in f32).

On ``--device cuda`` (the default) the ranks share the visible cards (over
``gloo`` when there are fewer cards than ranks); ``--device cpu`` runs them on
the host.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..core.config import AmgConfig, GemConfig, GuidanceConfig, PipelineConfig, clip_preset, sam_preset
from ..core.params import init_clip, init_sam, tree_map


class TinyVocabTokenizer:
    """Deterministic word ids inside the test-tiny CLIP's 101-token vocabulary."""

    sot_token, eot_token = 99, 100

    def encode(self, text):
        return [sum(map(ord, w)) % 97 + 1 for w in text.split()][:40]


def entry(device="cuda", clip_model: str = "ViT-B/16"):
    """(fn, example_args): ``fn(visual_params, local, glob, masks)`` is the
    G2L hybrid forward at ``clip_model`` over P = 8 proposals on ``device``."""
    from ..models.clip.fusion import hybrid_forward

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA card is available (pass device='cpu' to run on the CPU)")
    cfg = clip_preset(clip_model)
    params = init_clip(torch.Generator(device=device).manual_seed(0), cfg)
    P, n = 8, cfg.image_size
    rng = np.random.default_rng(0)
    local = torch.from_numpy(rng.standard_normal((P, n, n, 3)).astype(np.float32)).to(device)
    glob = torch.from_numpy(rng.standard_normal((P, n, n, 3)).astype(np.float32)).to(device)
    masks = torch.from_numpy((rng.random((P, n, n)) > 0.5).astype(np.float32)).to(device)

    def fn(visual_params, local_imgs, global_imgs, pred_masks):
        return hybrid_forward(visual_params, local_imgs, global_imgs, pred_masks, cfg, fusion_mode="G2L",
                              masking_block=min(9, cfg.vision_layers - 2))

    return fn, (params["visual"], local, glob, masks)


def tiny_config() -> PipelineConfig:
    """The dry run's configuration: test-tiny models, a 32-pixel canonical
    frame, 2 x 2 points, 4 proposal slots, the in-step cleanup on."""
    clip_cfg = clip_preset("test-tiny")
    return PipelineConfig(
        clip_config=clip_cfg, sam_config=sam_preset("test-tiny"), fusion_mode="G2L", canonical_size=32,
        crop_size=clip_cfg.image_size,
        amg=AmgConfig(points_per_side=2, points_per_batch=4, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                      min_mask_region_area=6, max_proposals=4),
        gem=GemConfig(img_size=32, depth=1),
        guidance=GuidanceConfig(masking_block=clip_cfg.vision_layers - 2),
    )


def tiny_params(cfg: PipelineConfig, device, seed: int = 0):
    """(sam, clip) f32 params from ``seed``, drawn on the host (the same
    numbers on every rank and device), with nonzero rel-pos tables."""
    g = torch.Generator().manual_seed(seed)
    sam_p, clip_p = init_sam(g, cfg.sam), init_clip(g, cfg.clip)
    for blk in sam_p["encoder"]["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.2
    move = lambda _, t: t.to(device)  # noqa: E731
    return tree_map(move, sam_p), tree_map(move, clip_p)


def _make_batch(rng, cfg: PipelineConfig, B: int, s_max: int, sentence_valid=None):
    from ..parallel.full_eval import FullEvalBatch

    S, C, L, K = cfg.sam.img_size, cfg.canonical_size, cfg.clip.context_length, cfg.guidance.max_other_nouns
    toks = np.zeros((B, s_max, L), np.int32)
    toks[:, :, 0] = cfg.clip.vocab_size - 2
    toks[:, :, 1] = 7
    toks[:, :, 2] = cfg.clip.vocab_size - 1
    sv = np.ones((B, s_max), bool) if sentence_valid is None else np.asarray(sentence_valid, bool)
    return FullEvalBatch(
        image_1024=rng.integers(0, 255, (B, S, S, 3)).astype(np.uint8),
        rh=np.full(B, S, np.int32), rw=np.full(B, S, np.int32),
        image_canonical=rng.integers(0, 255, (B, C, C, 3)).astype(np.uint8),
        h=np.full(B, C, np.int32), w=np.full(B, C, np.int32),
        gt_mask=(rng.random((B, C, C)) > 0.5),
        tokens_sentence=toks, tokens_np=toks.copy(),
        tokens_others=np.zeros((B, s_max, K, L), np.int32),
        n_others=np.zeros((B, s_max), np.int32), dir_flag=np.zeros((B, s_max), np.int32),
        rela_flag=np.zeros((B, s_max), np.int32), black=np.full((B, s_max), 1.8, np.float32),
        has_other=np.zeros((B, s_max), bool), sentence_valid=sv,
    )


def _dryrun_rank(n: int) -> dict:
    """One rank of the dry run; every rank builds the same params and batches from seed 0."""
    from ..models.sam.image_encoder import encode_image
    from ..parallel import launch
    from ..parallel.encoder_tp import encode_image_tp
    from ..parallel.full_eval import build_full_eval_step, finalize_sticky
    from ..parallel.mesh import make_mesh, make_mesh_2d, shard_batch

    device = launch.worker_device()
    cfg = tiny_config()
    sam_params, clip_params = tiny_params(cfg, device)
    rng = np.random.default_rng(0)
    s_max = 2

    def run_step(run_cfg, mesh, mp_axis, batch, expected):
        """One full parity step (proposals -> in-step cleanup -> crops -> fusion
        -> text -> GEM -> ingredients, then the sticky-clamp replay: the real
        --data_parallel path), checking the count of IoU updates: every valid
        sentence updates, a zero-proposal image's as misses."""
        step = build_full_eval_step(run_cfg, mesh, mp_axis=mp_axis, sticky=True)
        ings = step(sam_params, clip_params, shard_batch(batch, mesh))
        pa, *_ = finalize_sticky(run_cfg, ings, batch, run_cfg.guidance.k1, run_cfg.guidance.k2)
        assert int(pa.count) == expected, f"expected {expected} IoU updates, got {int(pa.count)}"
        return pa

    # pass A: a 2D (dp, mp) mesh: the batch shards over dp, the fusion stage's
    # proposal axis over mp; 1D dp where the ranks cannot split
    if n >= 4 and n % 2 == 0:
        mesh, mp_axis = make_mesh_2d(n, mp=2), "mp"
    else:
        mesh, mp_axis = make_mesh(n), None
    B = mesh.dp
    pa = run_step(cfg, mesh, mp_axis, _make_batch(rng, cfg, B, s_max), B * s_max)

    # pass B: pure dp over every rank with ragged sentence counts
    mesh_1d = make_mesh(n)
    sv = np.ones((n, s_max), bool)
    sv[::2, 1:] = False  # every other image has a single sentence
    pa_r = run_step(cfg, mesh_1d, None, _make_batch(rng, cfg, n, s_max, sentence_valid=sv), int(sv.sum()))

    # pass C: multicrop AMG (crop_n_layers = 1, the PhraseCut engine) on the first mesh;
    # the per-crop bucket must not exceed a crop's 4 points x 3 masks = 12 candidates
    mc_cfg = cfg.replace(amg=dataclasses.replace(cfg.amg, crop_n_layers=1, crop_n_points_downscale_factor=1,
                                                 max_candidates_per_crop=8))
    pa_mc = run_step(mc_cfg, mesh, mp_axis, _make_batch(rng, mc_cfg, B, s_max), B * s_max)

    out = dict(ranks=n, mesh=dict(dp=mesh.dp, mp=mesh.mp), batch=B, sentences=int(pa.count), cum_i=float(pa.cum_i),
               cum_u=float(pa.cum_u), ragged_sentences=int(pa_r.count), multicrop_sentences=int(pa_mc.count),
               multicrop_cum_i=float(pa_mc.cum_i), multicrop_cum_u=float(pa_mc.cum_u), tp_max_abs_diff=None,
               device=str(device))
    # the tensor-parallel encoder over the mp axis against the single-process one
    if mp_axis is not None:
        S = cfg.sam.img_size
        img = torch.from_numpy(rng.standard_normal((1, S, S, 3)).astype(np.float32)).to(device)
        got = encode_image_tp(sam_params["encoder"], img, cfg.sam, mesh, axis=mp_axis)
        want = encode_image(sam_params["encoder"], img, cfg.sam)
        err = float((got - want).abs().max())
        assert err < 2e-4, f"encoder TP diverged: max|diff|={err}"
        out["tp_max_abs_diff"] = err
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """Run the full eval step over ``n_devices`` ranks on tiny shapes (see the
    module docstring); prints one line and returns rank 0's summary."""
    from ..parallel import launch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA card is available (pass device='cpu' to run on the CPU)")
    results = launch.spawn_workers(_dryrun_rank, n_devices, (n_devices,), device, timeout=timeout)
    r = results[0]
    tp = "" if r["tp_max_abs_diff"] is None else f", encoder-TP(mp=2) max|diff|={r['tp_max_abs_diff']:.1e}"
    print(f"dryrun_multichip OK: {n_devices} ranks on {r['device'].split(':')[0]}, mesh {r['mesh']}, batch {r['batch']}, "
          f"sticky-replayed {r['sentences']} sentences, oIoU-accum I={r['cum_i']:.1f} U={r['cum_u']:.1f}{tp}; "
          f"dp={n_devices} ragged OK ({r['ragged_sentences']} sentences); multicrop(crop_n_layers=1) OK "
          f"({r['multicrop_sentences']} sentences, I={r['multicrop_cum_i']:.1f} U={r['multicrop_cum_u']:.1f})", flush=True)
    return r


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    with torch.inference_mode():
        out = fn(*example)
    print("entry OK:", tuple(out.shape), flush=True)
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
