"""On-card smoke test of the PyTorch/CUDA port (hybridgl_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (every phase asserts; any failure exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
  2. build: compiles the port's CUDA kernels from csrc/ (one nvcc per
     source, all at once, sm_90a);
  3. kernel check: ``hybridgl_tpu_torch.tools.check_kernels`` over all ten
     CUDA kernels of the TPU kernels and the port's NMS kernel against their
     plain PyTorch versions at production geometry, bf16 inputs (f32 boxes
     for NMS, held exactly), TF32 off, with median times beside each
     kernel's bound (operations or bytes) and, for the four attention
     kernels, the time of one ``scaled_dot_product_attention`` call on the
     same inputs (a yardstick, used nowhere in the port). K3 and K4 are
     held on both their kernels: the tensor-core (wgmma) one at B = 64 and
     at B = 128, the PhraseCut pass-2 batch, and the CUDA-core one in bf16
     at a shape the tensor-core dispatch refuses and in f32 at half width
     (its f32 operands do not fit in shared memory at full width), and at
     SamPredictor's shapes (B = 1: K3 at 7 tokens and, on its split route,
     at 9; K4 at m = 3 and 1). K5 and
     K6 likewise: the tensor-core kernels in bf16 at the served shapes (K5
     at the RefCOCO window and both PhraseCut windows, K6 with query row 0
     held on its own), the CUDA-core kernels in f32 and at a shape the
     tensor-core dispatch refuses (n = 200; hd = 32), and K10 the same way
     (its tensor-core kernel at both shapes in bf16, beside the time of
     half_transform + K5 on the same inputs). The
     check is the path of K9 (flash_attention_rel_pos) and K10
     (pass1_stats), which no serving path runs, as in the reference;
  4. small-input parity: the port on the card against the port on the CPU
     (the kernels' plain versions) at two small f32 configurations, single
     crop (K1, K2, K5, K6 and the default decoder route, K3 + K4) and
     multicrop (pass 2 through K7 + K8): same proposals and selections;
     then the six fusion modes on the single-crop proposals: same
     selections;
  5. RefCOCO pipeline: HybridGLPipeline.run_image at full width (SAM ViT-H +
     CLIP ViT-B/16, random bf16 weights from seed 0, AMG at RefCOCO
     settings with the quality thresholds zeroed as the reference bench
     does) on one warm-up and two measured synthetic images, checking
     finite outputs, that every kernel of the path launched, that NMS ran
     on the card once an image, that the SAM encoder's fused glue launched
     its exact count (one ln_1 and five kernels a block of 32, an encoder
     pass), and that every launch of a wrapper with two
     kernels (K3-K8) took its tensor-core one;
  6. PhraseCut pipeline: the same at AMG_PHRASECUT (pps 64, one crop layer,
     P = 128, canonical 1024), one warm-up and one measured image, NMS on
     the card six times an image (five crops, then across crops); the
     RefCOCO path once more with CLIP ViT-L/14@336 as the scorer (crops of
     336, G2L from block 21: K6 at 577 tokens exactly 27 times an image, all
     on the tensor cores, and its glue's launches exact); then, on
     each path, one more image timed (ms/img, peak device memory), one under
     torch.profiler (every copy by kind, pageable and pinned DtoH among them:
     count, bytes, device ms), one under a dispatch mode (the reads to the
     host by call site) and one in the sync debug mode (the stream
     synchronisations by call site), and the proposal dispatch alone in both
     modes: no read from the proposal stage's sites (models/sam/amg.py,
     kernels/nms.py), no read or synchronisation in the dispatch, and at
     most 1 MB of pageable DtoH an image, or the run fails; then the busy share of three more images of each path through
     run_dataset against run_image; then the stage graph: on each path the
     pipeline's proposal stage is one CUDA graph captured at its first
     image (pipeline/stage_graph.py); three image sizes replayed and held
     bit for bit on every bundle field against the eager stage on the same
     inputs, with its launch counts, selections and IoUs, and one capture;
     the capture's numbers (ms, nodes, pool bytes) and the dispatch's host
     ms to return beside the device ms it queues, with no read or
     synchronisation in it; then the score graphs: on each path the feature
     stage is one CUDA graph a proposal bucket and the sentence stage one a
     (bucket, sentence bucket) (pipeline/score_graph.py); three image sizes
     x 1, 2 and 3 sentences through _score_image, each replay held bit for
     bit against the eager stages on the same inputs (features, GEM patch
     features, scores, selections, IoUs, accumulators) with the same launch
     counts (K6 x 15 a replay), one capture a key, no read or
     synchronisation in _score_image; each graph's numbers, the scoring
     call's host ms beside the device ms it queues, the busy share and
     ms/img of run_dataset against run_image;
  7. fusion modes: all six at full width on one RefCOCO image's proposals
     and on a bucket of 64 live synthetic proposals: finite features, and
     K6 launched as often as each mode's blocks need (the CLS-row bias in
     attn_masking, L2G and G2L&L2G);
  8. dataset path: run_dataset equals run_image on the two RefCOCO
     images, then the port's CLI (``hybridgl_tpu_torch.cli.main``) at full
     width on a synthetic REFER tree: the reference's result log, one
     parity record per sentence, ms/img;
  9. predictor: SamPredictor at full width (ViT-H, the same random bf16
     weights) on one 480x640 image: set_image (K1 x 28, K2 x 4), then predict
     with one point, with a box, and with a box and two points, multimask
     both ways (K3's two layer passes and K4 x 1 a call; the first two prompts
     give 7 tokens and one tensor-core K3 launch a pass, the third 9 tokens and
     K3's split route: one I2T launch on the CUDA cores and two T2I launches
     on the tensor cores a pass), each
     held against the same decoder on the CPU from the card's embedding; and
     the predictor at test-tiny in f32 on the card against the CPU
     (thresholded-pixel agreement > 99.5%, IoU predictions |d| < 2e-2);
 10. batched sentences: one RefCOCO image with three sentences, on its own
     proposals and on 64 live synthetic ones, through the sentence stage in
     one call (the runner's path) and one call a sentence: equal selections,
     IoU sums equal to 1e-5;
 11. data parallel on the card: (a) the CLI with --data_parallel at world 1
     over nccl at full width on phase 8's synthetic REFER tree gives the
     sequential CLI's result log and parity records (equal indices, IoUs |d| <
     1e-5); (b) two ranks on cuda:0 over gloo: build_full_eval_step(sticky) +
     finalize_sticky on four full-width RefCOCO images against run_image over
     the same four in order: equal k1/k2 and selections, accumulators to rtol
     1e-5, each rank's K1-K6 launch counts, ms/img of both;
 12. tensor-parallel encoder on the card: mp = 2 on cuda:0 over gloo, ViT-H
     in bf16, against encode_image in one process: cos > 0.999, K1 x 28 and K2
     x 4 a rank (8 heads each), every launch on the tensor-core kernel;
 13. prepared decoder params: predict_masks on a 64-point chunk at full width
     in bf16 from the prepared tree (what the pipeline and the predictor build
     once: the weight-only products of models/sam/decoder.py) against the raw
     tree: logits max|d| < 0.1, thresholded pixels > 99.5% equal, IoU
     predictions |d| < 2e-2; ms per chunk both ways. Phases 5 and 6 run
     prepared;
 14. bench: tools/bench.py at BENCH_ITERS=4 BENCH_REPS=3, its JSON line echoed;
     and the multi-device dry run (tools/dryrun.py): four ranks on cuda:0 over
     gloo at its tiny configuration;
 15. the kernels as operators: the host cost of a launch through
     torch.ops.hybridgl against the direct call (tools/dispatch_cost.py), then
     the serving export (tools/export_serving.py) at full width: the ViT-H
     encoder and the ViT-B/16 G2L fusion at P = 64 exported with torch.export,
     saved, loaded here and in a fresh process that imports only the port;
     28 + 4 (and the SAM glue's 161) and 15 kernel nodes; each loaded program
     once on the card against eager (cos > 0.999), K1 +28, K2 +4 and K6 +15
     launches, all on the tensor cores; the .pt2 sizes and both times;
 16. the demo: ``python -m hybridgl_tpu_torch.cli.demo --random-weights`` at
     its defaults (SAM ViT-B, CLIP ViT-B/16, 8 x 8 points) on a synthetic
     480x640 image in a process of its own: exit code 0 and "no proposals
     found" (random weights pass none of the quality thresholds), then again
     with those zeroed: its overlay written; each run K1 x 8 and K2 x 4 at 12
     heads of head dim 64, NMS x 1.
The ranks of phases 11, 12 and 14 and the demo run in processes of their own
and report their launch counts, which the kernels line adds to this
process's.
The second-to-last line is a JSON object with one entry per kernel; the
last line is the JSON contract line. ``--profile`` adds a breakdown of one
more RefCOCO image (stage wall times, device time by kernel from
torch.profiler), the scoring stages on a full bucket of 64 synthetic
proposals, the multicrop stage times, and the device time of one more
PhraseCut image.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the kernel-check entry point is the only path of K9 and K10 (as in the
# reference, whose serving paths run K2 and K5 instead); K1-K8 count the
# launches of the pipeline paths
KERNEL_CHECK_ONLY = ("flash_attention_rel_pos", "pass1_stats")
# the operators of one G2L forward at ViT-B/16: each block call one K6 with
# its head split and merge and one bias + QuickGELU; LayerNorm alone for the
# two stems' ln_pre, block 0's ln_1 and ln_post; the rest written with the
# residual it normalises (each block's ln_2, the trunk's and the global
# stream's next ln_1: 18 + 6 + 2), G2L's injection with the local ln_1 (3),
# and a residual alone at the end of the local blocks and the global last (4)
G2L_NODES = {"clip_attention": 15, "qkv_heads": 15, "merge_heads": 15, "bias_quick_gelu": 15, "layer_norm": 4,
             "residual_layer_norm": 26, "inject_layer_norm": 3, "residual_add": 4}  # = g2l_launches(12, 9)
# the CLIP block's fused glue an image, exactly (kernels/clip_glue.py; the
# feature graph once, the sentence graph once): the G2L forward above; GEM's
# 12 blocks (gem/gem.py: a head split a block, ln_pre and block 0's ln_1
# alone, each block's ln_2 and the next block's ln_1 with the residual, the
# last block's residual and the 7 GEM-stream residuals alone, ln_post on both
# streams, 12 QuickGELUs; its attention writes the heads merged); the text
# tower's 12 blocks (block 0's ln_1 alone, 12 ln_2 and 11 ln_1 + the ln_final
# with the residual, 12 QuickGELUs)
GEM_GLUE = {"qkv_heads": 12, "layer_norm": 4, "residual_layer_norm": 23, "residual_add": 8, "bias_quick_gelu": 12}
TEXT_GLUE = {"layer_norm": 1, "residual_layer_norm": 24, "bias_quick_gelu": 12}
GLUE_LAUNCHES_PER_IMAGE = {k: G2L_NODES[k] + GEM_GLUE.get(k, 0) + TEXT_GLUE.get(k, 0) for k in G2L_NODES
                           if k != "clip_attention"}
# GEM's attention an image, exactly (kernels/gem_attention.py): one call a block of the tower
GEM_ATTENTION_LAUNCHES_PER_IMAGE = 12
# the SAM encoder block's fused glue an encoder pass, exactly (kernels/sam_glue.py): block 0's ln_1
# alone, then a block's qkv bias + heads + rel-pos terms, head merge, out-projection residual + ln_2,
# bias + GELU, and the MLP residual with the next block's ln_1 (31) or alone (the last block), 32 blocks
SAM_GLUE_LAUNCHES_PER_IMAGE = {"sam_layer_norm": 1, "sam_qkv_heads": 32, "sam_merge_heads": 32,
                               "sam_residual_layer_norm": 63, "sam_residual_add": 1, "sam_bias_gelu": 32}
# encoder passes an image: RefCOCO's one; PhraseCut's five crops
ENCODER_PASSES_PER_IMAGE = {"RefCOCO": 1, "PhraseCut": 5}
# the same counts at any tower (tools/check_kernels.py:clip_launches_per_image): CLIP ViT-L/14@336 with
# G2L from block 21 of 24, GEM depth 7, a 12-layer text tower launches K6 27 times an image (21 + 2 x 3)
VIT_L14_336 = ("ViT-L/14@336", 24, 21, 7, 12)
# per-image launches on the RefCOCO path (one launch per call): 28 windowed
# and 4 global SAM blocks, one pass-1 chunk of 64 points (two K3 layer
# passes, one K4 tail), 9 trunk + 3 x 2 G2L stream CLIP blocks
MIN_LAUNCHES_PER_IMAGE = {
    "flash_windowed_fused": 28,
    "flash_attention_fused": 4,
    "pass1_stats_half": 1,
    "clip_attention": 15,
    "i2t_ln_then_t2i": 2,
    "upscale_hyper_blocked": 1,
    "nms": 1,
    "gem_attention": GEM_ATTENTION_LAUNCHES_PER_IMAGE,
    **GLUE_LAUNCHES_PER_IMAGE,
    **SAM_GLUE_LAUNCHES_PER_IMAGE,
}
# the PhraseCut path adds the pass-2 re-decode on the per-prompt route: two
# K7 image->token updates and three K8 token->image attentions; its five
# encoder passes and 128 pass-1 chunks launch the others many times over
MIN_LAUNCHES_PER_PHRASECUT_IMAGE = dict(MIN_LAUNCHES_PER_IMAGE, i2t_ln_update=2, t2i_ctx=3, nms=6)
# NMS launches an image, exactly (one a call): RefCOCO's one over all
# candidates; PhraseCut's five per-crop calls and the cross-crop call
NMS_LAUNCHES_PER_IMAGE = {"RefCOCO": 1, "PhraseCut": 6}
# K6 launches of one hybrid_forward at ViT-B/16 (12 blocks, masking block 9,
# last layer 10), one per block call: crop runs the 12 blocks once;
# token_masking 9 + 3; attn_masking stops one block early (9 + 2, the
# reference's quirk); L2G and G2L run the 9 trunk blocks on the fused 2P
# batch and two streams through the 3 tail blocks; G2L&L2G four streams.
# attn_masking, L2G and G2L&L2G pass the CLS-row bias in their tail blocks.
K6_LAUNCHES_PER_MODE = {"crop": 12, "token_masking": 12, "attn_masking": 11, "L2G": 15, "G2L": 15, "G2L&L2G": 21}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    log(f"card: {smi[0] if smi else 'nvidia-smi unavailable'}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from hybridgl_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi[0] if smi else ""


def phase_build():
    from hybridgl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_seconds} s in nvcc) -> {_build.build()}")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels():
    """All eleven kernels through the kernel-check entry point."""
    from hybridgl_tpu_torch.tools.check_kernels import run_checks

    results = run_checks(log=log)
    failed = [k for k, v in results.items() if not v["ok"]]
    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")
    return results


SENTENCES = ["the large brown dog on the left", "person behind the table"]


def _tokenizer():
    from hybridgl_tpu_torch.models.clip.tokenizer import default_tokenizer

    return default_tokenizer()


def _sample(rng, sam_size, canonical, h, w, rh, rw, gt_box):
    import numpy as np

    from hybridgl_tpu_torch.pipeline.runner import ImageSample

    img1024 = np.zeros((sam_size, sam_size, 3), np.uint8)
    img1024[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((canonical, canonical, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    gt = np.zeros((canonical, canonical), bool)
    y0, x0, y1, x1 = gt_box
    gt[y0:y1, x0:x1] = True
    return ImageSample(img1024, rh, rw, imgc, h, w, gt, SENTENCES)


def _plain(results):
    """An image's results with plain Python values (one read of their device scalars)."""
    from hybridgl_tpu_torch.pipeline.runner import materialize_results

    return materialize_results(results)


def _check_results(tag, results, props, n_sentences):
    import math

    import torch

    if len(results) != n_sentences:
        fail(f"{tag}: {len(results)} results for {n_sentences} sentences")
    P = int(props.masks.shape[0])
    for r in results:
        if not (0 <= r.pure_index < P and 0 <= r.final_index < P):
            fail(f"{tag}: selected index out of range: {r}")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in (r.pure_iou, r.final_iou)):
            fail(f"{tag}: IoU not a finite value in [0, 1]: {r}")
    for name in ("boxes_xyxy", "iou_preds", "stability", "points", "areas"):
        if not bool(torch.isfinite(getattr(props, name)).all()):
            fail(f"{tag}: non-finite proposal {name}")


def phase_small_parity():
    """The port on the card (CUDA kernels) against the port on the CPU (the
    kernels' plain versions), f32, at two small configurations: single crop,
    whose SAM grid routes through K1 (window 8) and K2 (grid 32), whose
    decoder takes the default route (K3 + K4) and whose CLIP blocks route
    through K6; and multicrop (one crop layer), whose pass 2 runs the
    decoder's per-prompt route (K7 + K8). Same proposals and the same
    selections, and every one of the eight pipeline kernels launched on the
    card. Then the six fusion modes score the single-crop proposals on
    both devices: the same selections in every mode."""
    import dataclasses

    import numpy as np
    import torch

    from hybridgl_tpu_torch.core.config import AmgConfig, GemConfig, PipelineConfig, SamConfig, clip_preset
    from hybridgl_tpu_torch.lang import HeuristicParser
    from hybridgl_tpu_torch.core.params import init_clip, init_sam, tree_map
    from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline
    from hybridgl_tpu_torch.tools.dryrun import TinyVocabTokenizer

    sam_cfg = SamConfig(
        img_size=512, encoder_width=64, encoder_depth=2, encoder_heads=2, encoder_global_idx=(1,),
        window_size=8, prompt_dim=32, decoder_heads=2, decoder_mlp_dim=64, iou_head_hidden=32,
        mask_in_chans=8,
    )
    clip_cfg = clip_preset("test-tiny")
    single = AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
                       stability_score_thresh=0.0, min_mask_region_area=40, max_proposals=8)
    multicrop = dataclasses.replace(single, crop_n_layers=1, crop_n_points_downscale_factor=2, max_proposals=16,
                                    max_candidates_per_crop=16)
    g = torch.Generator().manual_seed(3)
    sam_p, clip_p = init_sam(g, sam_cfg), init_clip(g, clip_cfg)
    for blk in sam_p["encoder"]["blocks"]:  # nonzero rel-pos so the bias matters
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.2
    rng = np.random.default_rng(7)
    sample = _sample(rng, 512, 128, 96, 128, 384, 512, (20, 30, 70, 90))
    total = dict.fromkeys(MIN_LAUNCHES_PER_PHRASECUT_IMAGE, 0)
    for tag, amg_cfg in (("single crop", single), ("multicrop", multicrop)):
        cfg = PipelineConfig(
            clip_config=clip_cfg, sam_config=sam_cfg, canonical_size=128, crop_size=clip_cfg.image_size,
            amg=amg_cfg, gem=GemConfig(img_size=32, depth=2),
        )
        cfg = cfg.replace(guidance=cfg.guidance.__class__(masking_block=1))
        out = {}
        for dev in ("cpu", "cuda"):
            move = lambda _, t: t.to(dev)  # noqa: E731
            pipe = HybridGLPipeline(cfg, tree_map(move, sam_p), tree_map(move, clip_p),
                                    HeuristicParser(), TinyVocabTokenizer(), device=dev)
            reset_launch_counts()
            results = _plain(pipe.run_image(sample, pipe.init_state()))
            props = pipe.last_proposals
            _check_results(f"small {tag}/{dev}", results, props, len(SENTENCES))
            out[dev] = (results, props, launch_counts(), pipe)
        (r_cpu, p_cpu, _, pipe_cpu), (r_gpu, p_gpu, counts, pipe_gpu) = out["cpu"], out["cuda"]
        total = {k: total[k] + counts[k] for k in total}
        agree = float((p_cpu.masks == p_gpu.masks.cpu()).float().mean())
        same_valid = bool((p_cpu.valid == p_gpu.valid.cpu()).all())
        same_sel = [(a.pure_index, a.final_index) for a in r_cpu] == [(b.pure_index, b.final_index) for b in r_gpu]
        d_iou = max(abs(a.final_iou - b.final_iou) for a, b in zip(r_cpu, r_gpu))
        ok = agree >= 0.999 and same_valid and same_sel and d_iou <= 1e-4 and int(p_gpu.num) > 0
        log(f"{'PASS' if ok else 'FAIL'} small-input parity, {tag} (card vs cpu plain): proposals {p_gpu.num}, "
            f"mask agreement {agree:.6f}, same valid {same_valid}, same selections {same_sel}, "
            f"IoU max|d| {d_iou:.2e}, launches {counts}")
        if not ok:
            fail(f"small-input parity ({tag}) between the card and the CPU reference failed")
        if tag == "single crop":
            _small_fusion_modes(sample, (pipe_cpu, p_cpu), (pipe_gpu, p_gpu))
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        fail(f"small-input parity: kernels never launched on the card: {missing}")


def _small_fusion_modes(sample, cpu, gpu):
    """The six fusion modes score, on the CPU and on the card, each device's
    own proposals (equal above) and a bundle of 8 live synthetic rectangles:
    same selections."""
    from hybridgl_tpu_torch.core.config import FUSION_MODES
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline

    for mode in FUSION_MODES:
        for label in ("proposals", "8 synthetic proposals"):
            picks = []
            for pipe, props in (cpu, gpu):
                p = HybridGLPipeline(pipe.cfg.replace(fusion_mode=mode), pipe.sam_params, pipe.clip_params,
                                     pipe.parser, pipe.tokenizer, device=pipe.device)
                if label != "proposals":
                    props = _synthetic_full_bucket(p, 8, sample.h, sample.w)
                picks.append(_plain(p._score_image(sample, props, p.init_state())))
            r_cpu, r_gpu = picks
            same_sel = [(a.pure_index, a.final_index) for a in r_cpu] == [(b.pure_index, b.final_index) for b in r_gpu]
            d_iou = max(abs(a.final_iou - b.final_iou) for a, b in zip(r_cpu, r_gpu))
            ok = same_sel and d_iou <= 1e-4
            log(f"{'PASS' if ok else 'FAIL'} small-input parity, fusion mode {mode}, {label} (card vs cpu plain): "
                f"selections {[(b.pure_index, b.final_index) for b in r_gpu]}, same {same_sel}, "
                f"IoU max|d| {d_iou:.2e}")
            if not ok:
                fail(f"small-input parity of fusion mode {mode} ({label}) between the card and the CPU reference failed")


def full_width_weights():
    """SAM ViT-H + CLIP ViT-B/16 random weights from seed 0, bf16, on the card."""
    import torch

    from hybridgl_tpu_torch.core.config import PipelineConfig
    from hybridgl_tpu_torch.core.params import cast_tree, init_clip, init_sam, param_count

    cfg = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sam_p = cast_tree(init_sam(gen, cfg.sam), torch.bfloat16)
    clip_p = cast_tree(init_clip(gen, cfg.clip), torch.bfloat16)
    torch.cuda.synchronize()
    log(f"weights: random SAM {param_count(sam_p) / 1e6:.1f}M + CLIP {param_count(clip_p) / 1e6:.1f}M "
        f"params (bf16) in {time.perf_counter() - t0:.1f} s")
    return sam_p, clip_p


def clip_weights(clip_model):
    """Random CLIP weights of ``clip_model`` from seed 1, bf16, on the card."""
    import torch

    from hybridgl_tpu_torch.core.config import clip_preset
    from hybridgl_tpu_torch.core.params import cast_tree, init_clip, param_count

    clip_p = cast_tree(init_clip(torch.Generator(device="cuda").manual_seed(1), clip_preset(clip_model)), torch.bfloat16)
    log(f"weights: random CLIP {clip_model} {param_count(clip_p) / 1e6:.1f}M params (bf16)")
    return clip_p


def phase_pipeline(tag, amg, canonical, n_images, min_launches, weights, clip_model="ViT-B/16"):
    """One main path at full width: SAM ViT-H + CLIP ``clip_model`` (its crop
    size and masking block as the CLI derives them), bf16, the given AMG with
    the quality thresholds zeroed as the reference bench does (random weights
    pass none of them), synthetic 480x640 images in the canonical frame; one
    warm-up image, then ``n_images`` measured. The CLIP glue's launches an
    image are exact (``tools/check_kernels.py:clip_launches_per_image``), and
    K6's too past ViT-B/16; so are the SAM glue's, once an encoder pass
    (``SAM_GLUE_LAUNCHES_PER_IMAGE``)."""
    import dataclasses

    import numpy as np
    import torch

    from hybridgl_tpu_torch.cli.main import tower_defaults
    from hybridgl_tpu_torch.core.config import GuidanceConfig, PipelineConfig, clip_preset
    from hybridgl_tpu_torch.lang import HeuristicParser
    from hybridgl_tpu_torch.kernels import launch_counts, tc_launch_counts
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline
    from hybridgl_tpu_torch.tools.check_kernels import clip_launches_per_image

    tower = tower_defaults(clip_preset(clip_model))
    cfg = PipelineConfig(sam_model="vit_h", clip_model=clip_model, fusion_mode="G2L", canonical_size=canonical,
                         crop_size=tower["crop_size"], guidance=GuidanceConfig(masking_block=tower["masking_block"]),
                         amg=dataclasses.replace(amg, pred_iou_thresh=0.0, stability_score_thresh=0.0))
    exact = clip_launches_per_image(cfg.clip.vision_layers, cfg.guidance.masking_block, cfg.gem.depth,
                                    cfg.clip.text_layers)
    if clip_model == "ViT-B/16":
        exact.pop("clip_attention")
    passes = ENCODER_PASSES_PER_IMAGE[tag.split()[0]]
    exact.update({k: n * passes for k, n in SAM_GLUE_LAUNCHES_PER_IMAGE.items()})
    pipe = HybridGLPipeline(cfg, *weights, HeuristicParser(), _tokenizer(), device=torch.device("cuda"))
    rng = np.random.default_rng(0)
    samples = [_sample(rng, 1024, canonical, 480, 640, 768, 1024, (100, 150, 300, 400)) for _ in range(n_images + 1)]
    state = pipe.init_state()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, sample in enumerate(samples):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = pipe.run_image(sample, state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        results = _plain(results)
        props = pipe.last_proposals
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        name = f"{tag} warm-up" if i == 0 else f"{tag} image {i}"
        if i:
            times.append(ms)
        log(f"  {name}: {ms:.1f} ms, proposals {props.num} (bucket {props.masks.shape[0]}), "
            f"selected {[(r.pure_index, r.final_index) for r in results]}, launches {delta}")
        _check_results(name, results, props, len(SENTENCES))
        short = {k: (delta[k], n) for k, n in min_launches.items() if delta[k] < n}
        if short:
            fail(f"{name}: kernels launched fewer times than the path needs: {short}")
        off = {k: (delta[k], n) for k, n in exact.items() if delta[k] != n}
        if off:
            fail(f"{name}: the CLIP or SAM glue's launches (launched, expected) differ from the path's: {off}")
        nms = NMS_LAUNCHES_PER_IMAGE[tag.split()[0]]
        if delta["nms"] != nms:
            fail(f"{name}: NMS launched {delta['nms']} times on the card, expected {nms}")
    # at full width in bf16 every launch of a wrapper with two kernels is the tensor-core kernel's
    total, on_tc = launch_counts(), tc_launch_counts()
    off_tc = {k: (n, total[k]) for k, n in on_tc.items() if n != total[k]}
    log(f"  {tag}: launches on the tensor-core kernels {on_tc}")
    if off_tc:
        fail(f"{tag}: launches that missed the tensor-core kernel (on it, all): {off_tc}")
    acc = [float(v) for v in (*state.pure, *state.final)]
    if not all(np.isfinite(acc)) or int(state.pure.count) != 2 * len(samples):
        fail(f"{tag}: accumulators wrong: {state}")
    log(f"{tag} pipeline: median {statistics.median(times):.1f} ms/img over {len(times)} images "
        f"(per image {[round(t, 1) for t in times]}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return pipe, samples


# the proposal stage's call sites: once launched, the stage reads nothing back
PROPOSAL_STAGE_SITES = ("models/sam/amg.py", "kernels/nms.py")
MAX_PAGEABLE_DTOH_BYTES = 1 << 20  # a image: the hand-off moves packed live rows into pinned memory


def phase_downloads(tag, pipe, samples, card):
    """One more image timed (ms/img, peak device memory), one under
    torch.profiler (every copy by kind: device to pageable and to pinned host
    memory, host to device; count, bytes, device ms), one under a dispatch
    mode (the reads to the host by call site, the non-blocking copies apart)
    and one in the sync debug mode (the stream synchronisations by call site),
    one with a blocking stage timer (the host cleanup's wall), then the
    proposal dispatch alone in both modes. Fails if a call site of
    the proposal stage reads the host, if the dispatch alone reads or
    synchronises at all, or if the image's pageable DtoH bytes exceed 1 MB
    (run_dataset against run_image: phase_dataset_path)."""
    import torch

    from hybridgl_tpu_torch.tools.device_time import host_reads, host_syncs, profile_image, stage_ms

    sample = samples[-1]
    torch.cuda.reset_peak_memory_stats()
    ms, _ = _wall_ms(lambda: pipe.run_image(sample, pipe.init_state()))
    peak = torch.cuda.max_memory_allocated()
    prof = profile_image(pipe, sample, pipe.init_state(), log=log, top_n=8)
    reads = host_reads(lambda: pipe.run_image(sample, pipe.init_state()), log=log)
    syncs = host_syncs(lambda: pipe.run_image(sample, pipe.init_state()), log=log)
    cleanup = stage_ms(pipe, sample, log=log).get("small_region_cleanup", 0.0)
    log(f"  {tag}, the proposal dispatch alone (stage + hand-off, nothing waited for):")
    dispatch_reads = host_reads(lambda: pipe._dispatch_proposals(sample), log=log)
    dispatch_syncs = host_syncs(lambda: pipe._dispatch_proposals(sample), log=log)
    torch.cuda.synchronize()
    down, pinned = prof["dtoh_pageable"], prof["dtoh_pinned"]
    size = lambda c: "bytes not measured" if c["bytes"] is None else f"{c['bytes']} bytes"  # noqa: E731
    stage_reads = [r for r in reads + dispatch_reads if any(s in r[0] for s in PROPOSAL_STAGE_SITES)]
    log(f"{tag}, one image: pageable DtoH {size(down)} in {down['copies']} copies, {down['device_ms']:.3f} ms of "
        f"device time; pinned DtoH {size(pinned)} in {pinned['copies']} copies, {pinned['device_ms']:.3f} ms "
        f"(torch.profiler); reads to the host {sum(n for _, n, _ in reads)} ({sum(b for _, _, b in reads)} bytes), "
        f"{len(stage_reads)} from the proposal stage's sites {PROPOSAL_STAGE_SITES} (dispatch mode); stream "
        f"synchronisations {sum(n for _, n in syncs)} an image, {sum(n for _, n in dispatch_syncs)} in the "
        f"proposal dispatch; host cleanup {cleanup:.1f} ms (blocking timer); peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); {ms:.1f} ms/img; on {card}")
    if stage_reads or dispatch_reads or dispatch_syncs:
        fail(f"{tag}: the proposal stage read the host or waited for the card: reads {stage_reads + dispatch_reads}, "
             f"synchronisations in the dispatch {dispatch_syncs}")
    if down["bytes"] is None or down["bytes"] > MAX_PAGEABLE_DTOH_BYTES:
        fail(f"{tag}: pageable DtoH of one image {down['bytes']} bytes, more than {MAX_PAGEABLE_DTOH_BYTES} "
             f"(or not measured)")


def phase_busy_share(paths, card):
    """The busy share of three more images of each path (the union of the
    card's busy intervals over the wall, torch.profiler with device activity
    only) through run_dataset and one run_image an image, in turns:
    {path: {"run_dataset": median, "run_image": median}}."""
    import numpy as np

    from hybridgl_tpu_torch.tools.device_time import compare_busy_share

    shares = {}
    for tag, (pipe, _) in paths.items():
        C = pipe.cfg.canonical_size
        rng = np.random.default_rng(11)
        samples = [_sample(rng, 1024, C, 480, 640, 768, 1024, (100, 150, 300, 400)) for _ in range(3)]
        out = compare_busy_share(pipe, samples, log=log)
        med = {how: statistics.median(r["share"] for r in runs) for how, runs in out.items()}
        log(f"{tag}: busy share over 3 images, run_dataset {med['run_dataset']:.3f} against run_image "
            f"{med['run_image']:.3f} (medians of two runs each, profiler on); on {card}")
        shares[tag] = med
    return shares


# the stage-graph phase's image sizes (h, w) a path: landscape, portrait, and one side below half the canonical frame
STAGE_GRAPH_SIZES = {"RefCOCO": ((480, 640), (640, 427), (240, 640)), "PhraseCut": ((480, 640), (1024, 683), (400, 1024))}


def _selections(pipe, sample, props):
    """A proposal bundle through the runner's finish (hand-off, host cleanup)
    and scoring: [(pure_index, final_index, pure_iou, final_iou)] a sentence."""
    from hybridgl_tpu_torch.pipeline.handoff import hand_off

    done, bucket = pipe._finish_proposals(hand_off(props, pipe.cfg.amg.min_mask_region_area > 0), (sample.h, sample.w))
    return [(r.pure_index, r.final_index, r.pure_iou, r.final_iou)
            for r in _plain(pipe._score_image(sample, done, pipe.init_state(), bucket=bucket))]


def phase_stage_graph(paths, card, shares):
    """The proposal stage as one captured CUDA graph a configuration
    (pipeline/stage_graph.py), on each full-width path: three image sizes
    through the pipeline's StageGraph, each replay held bit for bit on every
    bundle field against the eager stage on the same inputs, with the same
    launch counts and the same selections and IoUs after the cleanup and
    scoring, and still one capture; the capture's numbers (warm-up, capture
    and instantiate ms, nodes, pool bytes); the host ms from the call of the
    proposal dispatch to its return and the device ms it queued (CUDA events),
    and no read or synchronisation in it; and phase_busy_share's run_dataset
    against run_image. Fails on any difference, a second capture, or a read
    or synchronisation in the dispatch."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch.kernels import launch_counts
    from hybridgl_tpu_torch.models.sam.amg import Proposals
    from hybridgl_tpu_torch.models.sam.sam import get_preprocess_shape
    from hybridgl_tpu_torch.tools.device_time import dispatch_ms, host_reads, host_syncs

    for tag, (pipe, samples) in paths.items():
        stage, C = pipe.stage, pipe.cfg.canonical_size
        rng = np.random.default_rng(13)
        for h, w in STAGE_GRAPH_SIZES[tag]:
            rh, rw = get_preprocess_shape(h, w, pipe.cfg.sam.img_size)
            sample = _sample(rng, pipe.cfg.sam.img_size, C, h, w, rh, rw, (h // 5, w // 5, h // 2, w // 2))
            c0 = launch_counts()
            replayed = stage.launch(sample)
            c1 = launch_counts()
            eager = stage.eager()
            c2 = launch_counts()
            torch.cuda.synchronize()
            differ = [f for f in Proposals._fields if not torch.equal(getattr(replayed, f), getattr(eager, f))]
            by_replay = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
            by_eager = {k: c2[k] - c1[k] for k in c2 if c2[k] != c1[k]}
            sel_replay, sel_eager = _selections(pipe, sample, replayed), _selections(pipe, sample, eager)
            ok = not differ and by_replay == by_eager and sel_replay == sel_eager and stage.captures == 1
            log(f"{'PASS' if ok else 'FAIL'} {tag} stage graph, {h}x{w} (rh, rw {rh}, {rw}): replay against eager, "
                f"fields that differ {differ}, proposals {int(replayed.num)}, selections {sel_replay} "
                f"(eager {sel_eager}), launches a replay {by_replay} (eager {by_eager}), captures {stage.captures}")
            if not ok:
                fail(f"{tag}: the replayed proposal stage differs from the eager one at {h}x{w}")
        sample = samples[-1]
        reads = host_reads(lambda: pipe._dispatch_proposals(sample), log=log)
        syncs = host_syncs(lambda: pipe._dispatch_proposals(sample), log=log)
        if reads or syncs:
            fail(f"{tag}: the replayed proposal dispatch read the host {reads} or synchronised {syncs}")
        host, device = dispatch_ms(pipe, sample)
        st = stage.stats()
        share = shares[tag]
        log(f"{tag} stage graph: {st['captures']} capture, warm-up {st['warmup_ms']:.1f} ms, capture "
            f"{st['capture_ms']:.1f} ms, instantiate {st['instantiate_ms']:.1f} ms, {st['nodes']} nodes, pool "
            f"{st['pool_bytes']} bytes; proposal dispatch: host ms to return {[round(t, 3) for t in host]}, device "
            f"ms queued {[round(t, 3) for t in device]}; 0 reads, 0 syncs; busy share run_dataset "
            f"{share['run_dataset']:.3f} against run_image {share['run_image']:.3f} "
            f"({'above' if share['run_dataset'] > share['run_image'] else 'not above'}); on {card}")


def phase_score_graph(paths, card, shares):
    """The feature and sentence stages as CUDA graphs, one a shape key
    (pipeline/score_graph.py), on each full-width path: three image sizes x
    1, 2 and 3 sentences through _score_image, each replay held bit for bit
    against the eager stages on the same inputs (fusion features, GEM patch
    features, scores, selections, IoUs, accumulators) with the same launch
    counts (K6 included), and one capture a key; no read and no stream
    synchronisation in _score_image; then each graph's warm-up, capture and
    instantiate ms, nodes and pool bytes, the scoring call's host ms to return
    beside the device ms it queues, the busy share of run_dataset against
    run_image (phase_busy_share) and ms/img both ways. Fails on any
    difference, a second capture of a key, or a read or synchronisation."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch.kernels import launch_counts
    from hybridgl_tpu_torch.models.sam.sam import get_preprocess_shape
    from hybridgl_tpu_torch.tools.device_time import host_reads, host_syncs, score_ms

    sentences = SENTENCES + ["the small cup to the right of the person"]
    for tag, (pipe, _) in paths.items():
        scorer, C = pipe.scorer, pipe.cfg.canonical_size
        rng = np.random.default_rng(17)
        bases = []
        for h, w in STAGE_GRAPH_SIZES[tag]:
            rh, rw = get_preprocess_shape(h, w, pipe.cfg.sam.img_size)
            base = _sample(rng, pipe.cfg.sam.img_size, C, h, w, rh, rw, (h // 5, w // 5, h // 2, w // 2))
            bases.append(base)
            with torch.inference_mode():
                handoff, image_c = pipe._dispatch_proposals(base)
                props, bucket = pipe._finish_proposals(handoff, (h, w))
            for n in (1, 2, 3):
                sample = base._replace(sentences=sentences[:n])
                state = pipe.init_state()
                c0 = launch_counts()
                results = pipe._score_image(sample, props, state, image_c, bucket)
                c1 = launch_counts()
                bk, _ = scorer.last
                feats, gem_pf, out = bk.feats.clone(), bk.gem_pf.clone(), scorer.outputs
                e_feats, e_gem, e_out = scorer.eager()
                c2 = launch_counts()
                torch.cuda.synchronize()
                differ = [name for name, a, b in (("feats", feats, e_feats), ("gem_pf", gem_pf, e_gem),
                                                  *zip(out._fields, out, e_out)) if not torch.equal(a, b)]
                state_acc = torch.stack([*state.pure, *state.final]).reshape(2, 4)
                by_replay = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
                by_eager = {k: c2[k] - c1[k] for k in c2 if c2[k] != c1[k]}
                picks = [(r.pure_index, r.final_index, r.pure_iou, r.final_iou) for r in _plain(results)]
                once = all(v == 1 for v in scorer.captures.values())
                ok = (not differ and torch.equal(state_acc, out.acc) and by_replay == by_eager
                      and by_replay.get("clip_attention", 0) == K6_LAUNCHES_PER_MODE["G2L"] and once)
                log(f"{'PASS' if ok else 'FAIL'} {tag} score graph, {h}x{w}, {n} sentence(s) (bucket "
                    f"{bk.masks.shape[0]}, sentence bucket {out.picks.shape[0]}): replay against eager, outputs that "
                    f"differ {differ}, selections {picks}, launches a replay {by_replay} (eager {by_eager}), "
                    f"captures {dict(scorer.captures)}")
                if not ok:
                    fail(f"{tag}: the replayed scoring stages differ from the eager ones at {h}x{w}, {n} sentence(s)")
        fn = lambda: pipe._score_image(sample, props, pipe.init_state(), image_c, bucket)  # noqa: E731
        reads, syncs = host_reads(fn, log=log), host_syncs(fn, log=log)
        if reads or syncs:
            fail(f"{tag}: _score_image read the host {reads} or synchronised {syncs}")
        host, device = score_ms(pipe, sample, finished=(props, image_c, bucket))
        for key, st in scorer.stats().items():
            log(f"  {tag} score graph {key}: warm-up {st['warmup_ms']:.1f} ms, capture {st['capture_ms']:.1f} ms, "
                f"instantiate {st['instantiate_ms']:.1f} ms, {st['nodes']} nodes, pool {st['pool_bytes']} bytes, "
                f"launches a replay {st['launches']}")
        pools = sum(st["pool_bytes"] for st in scorer.stats().values())
        ms_image, ms_dataset = [], []
        state = pipe.init_state()
        for base in bases:
            ms_image.append(_wall_ms(lambda: _plain(pipe.run_image(base, state)))[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, results in pipe.run_dataset(iter(bases), pipe.init_state()):
            _plain(results)  # the CLI's one read an image
        torch.cuda.synchronize()
        ms_dataset = (time.perf_counter() - t0) * 1e3 / len(bases)
        share = shares[tag]
        log(f"{tag} score graphs: {len(scorer.stats())} graphs, one capture a key, pools {pools} bytes in all; "
            f"_score_image: 0 reads, 0 syncs, host ms to return {[round(t, 3) for t in host]}, device ms queued "
            f"{[round(t, 3) for t in device]}; busy share run_dataset {share['run_dataset']:.3f} against run_image "
            f"{share['run_image']:.3f}; ms/img run_image {[round(t, 1) for t in ms_image]}, run_dataset "
            f"{ms_dataset:.1f} (three sizes, results read once an image); on {card}")


def _synthetic_full_bucket(pipe, P=64, h=480, w=640):
    """P live rectangle proposals in the canonical frame of an h x w image
    (positions and sizes drawn for 480x640 and scaled)."""
    import torch

    from hybridgl_tpu_torch.kernels.masks import mask_to_box
    from hybridgl_tpu_torch.models.sam.amg import Proposals

    dev, C = pipe.device, pipe.cfg.canonical_size
    g = torch.Generator().manual_seed(2)
    masks = torch.zeros((P, C, C), dtype=torch.bool)
    sy, sx = h / 480, w / 640
    for i in range(P):
        y0, x0 = (int(v) for v in torch.randint(0, 400, (2,), generator=g))
        hh, ww = (int(v) for v in torch.randint(20, 200, (2,), generator=g))
        y0, x0, hh, ww = int(y0 * sy), int(x0 * sx), max(int(hh * sy), 1), max(int(ww * sx), 1)
        masks[i, y0 : min(y0 + hh, h), x0 : min(x0 + ww, w)] = True
    masks = masks.to(dev)
    ones = torch.ones(P, device=dev)
    return Proposals(masks, mask_to_box(masks), ones, ones, torch.zeros((P, 2), device=dev),
                     masks.sum((-2, -1)).float(), ones.bool(), num=P, overflow=0)


def phase_profile(pipe, samples):
    """Stage wall times and device time by kernel for one more image, plus
    the scoring stages at a full bucket (random weights leave few proposals)."""
    import torch

    from hybridgl_tpu_torch.tools.device_time import profile_image

    sample = samples[-1]
    state = pipe.init_state()
    stage_ms = {}
    for _ in range(2):  # second pass is the one kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        props = pipe.propose(sample)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe._score_image(sample, props, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stage_ms = {"proposals (encoder + AMG + cleanup)": (t1 - t0) * 1e3, "features + sentences": (t2 - t1) * 1e3}
    full = _synthetic_full_bucket(pipe)
    pipe._score_image(sample, full, pipe.init_state())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe._score_image(sample, full, pipe.init_state())
    torch.cuda.synchronize()
    stage_ms["features + sentences at P = 64 live"] = (time.perf_counter() - t0) * 1e3
    for k, v in stage_ms.items():
        log(f"  stage {k}: {v:.1f} ms")

    profile_image(pipe, sample, state, log=log, top_n=15)


def _wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_multicrop_stages(pipe, samples):
    """Stage times of one PhraseCut image: the five encoder passes, pass 1
    (full-image crop: 64 chunks; one layer-1 crop: 16 chunks), the pass-2
    re-decode of P = 128 survivors, and the whole proposal and scoring stages."""
    import torch

    from hybridgl_tpu_torch.models.sam import amg
    from hybridgl_tpu_torch.models.sam.decoder import predict_masks
    from hybridgl_tpu_torch.models.sam.prompt_encoder import dense_pe, embed_points, no_mask_dense
    from hybridgl_tpu_torch.models.sam.sam import encode, preprocess_padded

    cfg, p_sam = pipe.cfg, pipe.sam_params
    sample = samples[1]
    x = preprocess_padded(torch.from_numpy(sample.image_1024).cuda(), (sample.rh, sample.rw), cfg.sam)
    stages = {"encoder, one frame (x5 per image)": _wall_ms(lambda: encode(p_sam, x, cfg.sam))[0]}
    emb = encode(p_sam, x, cfg.sam)
    # the stage's geometry table (row 0 the full image, rows 1-4 the layer-1 crops) and point grids
    geo = torch.from_numpy(amg.geometry(sample.rh, sample.rw, sample.h, sample.w, cfg.sam, cfg.amg)).cuda()
    consts = amg.stage_constants(cfg.sam, cfg.amg, "cuda")
    for name, row in (("pass 1, full-image crop (64 chunks)", 0), ("pass 1, one layer-1 crop (16 chunks, x4 per image)", 4)):
        stages[name] = _wall_ms(lambda: amg._score_candidates(p_sam, emb, consts.chunks[row], consts.n_points[row],
                                                              geo[row], geo[0], cfg.sam, cfg.amg,
                                                              cfg.canonical_size))[0]
    P, g = cfg.amg.max_proposals, cfg.sam.embed_grid
    coords = torch.rand((P, 1, 2), device="cuda") * 1000
    sparse = embed_points(p_sam["prompt"], coords, torch.ones((P, 1), device="cuda"), cfg.sam)
    dense = emb[None].expand(P, g, g, -1) + no_mask_dense(p_sam["prompt"], cfg.sam, P)
    pe = dense_pe(p_sam["prompt"], cfg.sam)
    redecode = lambda: predict_masks(p_sam["decoder"], torch.zeros_like(emb), pe, sparse, cfg.sam,  # noqa: E731
                                     dense_prompts=dense, multimask_output=True)
    redecode()
    stages[f"pass 2 re-decode, P = {P} (K7 + K8 + K4)"] = _wall_ms(redecode)[0]
    for _ in range(2):  # the second pass is kept
        t_prop, props = _wall_ms(lambda: pipe.propose(sample))
        t_score, _ = _wall_ms(lambda: pipe._score_image(sample, props, pipe.init_state()))
    stages["proposals (5 encoder passes + multicrop AMG + cleanup)"] = t_prop
    stages[f"features + sentences (live bucket {props.masks.shape[0]})"] = t_score
    for k, v in stages.items():
        log(f"  PhraseCut stage {k}: {v:.1f} ms")


def phase_fusion_modes(pipe, samples):
    """All six fusion modes at full width (CLIP ViT-B/16, bf16) on one
    RefCOCO image's proposals and on 64 live synthetic proposals: finite
    [P, 512] features, and K6 launched once per block call of the mode."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch.core.config import FUSION_MODES
    from hybridgl_tpu_torch.kernels import launch_counts
    from hybridgl_tpu_torch.models.clip.fusion import hybrid_forward
    from hybridgl_tpu_torch.pipeline.preprocess import build_crops

    cfg, sample = pipe.cfg, samples[1]
    image_c = torch.from_numpy(np.asarray(sample.image_canonical)).cuda()
    hw = (sample.h, sample.w)
    for label, props in (("RefCOCO image", pipe._bucket_props(pipe.propose(sample))),
                         ("64 live synthetic proposals", _synthetic_full_bucket(pipe))):
        glob, local = build_crops(image_c, props.masks, hw, cfg.crop_size, cfg.blur_ksize)
        for mode in FUSION_MODES:
            def forward(mode=mode):
                return hybrid_forward(pipe.clip_params["visual"], local, glob, props.masks.float(), cfg.clip,
                                      fusion_mode=mode, masking_block=cfg.guidance.masking_block, compat=cfg.compat,
                                      masks_hw=hw)

            before = launch_counts()["clip_attention"]
            feats = forward()
            torch.cuda.synchronize()
            k6 = launch_counts()["clip_attention"] - before
            ms = statistics.median(_wall_ms(forward)[0] for _ in range(3))
            P = props.masks.shape[0]
            ok = feats.shape == (P, cfg.clip.embed_dim) and bool(torch.isfinite(feats).all()) \
                and k6 == K6_LAUNCHES_PER_MODE[mode]
            log(f"{'PASS' if ok else 'FAIL'} fusion mode {mode}, {label} (P = {P}): features {tuple(feats.shape)} "
                f"finite {bool(torch.isfinite(feats).all())}, K6 launches {k6} (expected "
                f"{K6_LAUNCHES_PER_MODE[mode]}), {ms:.1f} ms")
            if not ok:
                fail(f"fusion mode {mode} at full width ({label}) failed")


def _write_refer_tree(root, n_images=3, h=480, w=640):
    """A synthetic REFER tree (the layout hybridgl_tpu/data/refer.py reads):
    ``n_images`` random 480x640 images with one or two val refs each,
    rectangle annotations as polygons; returns the number of sentences."""
    import json
    import pickle

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "images/mscoco/images/train2014")
    os.makedirs(img_dir)
    os.makedirs(os.path.join(root, "refcoco"))
    images, anns, refs = [], [], []
    words = ["the dog on the left", "person behind the table", "small cup", "the big one in the middle"]
    for i in range(1, n_images + 1):
        fname = f"COCO_train2014_{i:012d}.jpg"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(os.path.join(img_dir, fname))
        images.append({"id": i, "file_name": fname, "height": h, "width": w})
        for j in range(1 + i % 2):
            aid = 10 * i + j
            y0, x0 = (int(v) for v in rng.integers(0, 200, 2))
            y1, x1 = y0 + int(rng.integers(60, 250)), x0 + int(rng.integers(60, 400))
            anns.append({"id": aid, "image_id": i, "category_id": 1, "bbox": [x0, y0, x1 - x0, y1 - y0],
                         "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]], "area": (x1 - x0) * (y1 - y0)})
            sents = [{"sent_id": 100 * aid + k, "raw": words[(aid + k) % 4], "tokens": []} for k in range(1 + j)]
            refs.append({"ref_id": aid, "ann_id": aid, "image_id": i, "category_id": 1, "split": "val",
                         "sentences": sents, "sent_ids": [x["sent_id"] for x in sents]})
    with open(os.path.join(root, "refcoco", "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(root, "refcoco", "instances.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "thing"}]}, f)
    return sum(len(r["sentences"]) for r in refs)


def phase_dataset_path(pipe, samples, card):
    """run_dataset equals run_image on the measured RefCOCO images; then the
    port's CLI at full width on a synthetic REFER tree, sequential and with
    --data_parallel (one rank, nccl): the same result log and parity records."""
    import json
    import tempfile

    import torch

    from hybridgl_tpu_torch.cli.main import main as cli_main
    from hybridgl_tpu_torch.kernels import launch_counts

    measured = samples[1:]
    state_a = pipe.init_state()
    seq = [_plain(pipe.run_image(smp, state_a)) for smp in measured]
    state_b = pipe.init_state()
    piped = [_plain(results) for _, results in pipe.run_dataset(iter(measured), state_b)]
    same = [[(r.pure_index, r.final_index, r.pure_iou, r.final_iou) for r in rs] for rs in seq] == \
        [[(r.pure_index, r.final_index, r.pure_iou, r.final_iou) for r in rs] for rs in piped]
    same_state = [float(v) for v in (*state_a.pure, *state_a.final)] == [float(v) for v in (*state_b.pure, *state_b.final)]
    ok = same and same_state and len(piped) == len(measured)
    log(f"{'PASS' if ok else 'FAIL'} run_dataset == run_image on {len(measured)} RefCOCO images: same selections and "
        f"IoUs {same}, same accumulators {same_state}")
    if not ok:
        fail("run_dataset differs from run_image")

    with tempfile.TemporaryDirectory() as root:
        n_sentences = _write_refer_tree(root)
        runs = {}
        # the sequential CLI, then --data_parallel: one rank for the one card, over nccl
        for tag, extra in (("sequential", []), ("--data_parallel (world 1, nccl)", ["--data_parallel"])):
            logs, parity = os.path.join(root, tag[:4], "logs"), os.path.join(root, tag[:4], "parity.json")
            os.environ.pop("HYBRIDGL_WORLD_SIZE", None)
            before = launch_counts()
            t0 = time.perf_counter()
            cli_main(["--dataset", "refcoco", "--split", "val", "--refer_data_root", root, "--sam_model", "vit_h",
                      "--clip_model", "ViT-B/16", "--random-weights", "--device", "cuda", "--log_dir", logs,
                      "--parity_log", parity, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(logs, "result_log_refcoco_val.txt")) as f:
                text = f.read()
            with open(parity) as f:
                records = json.load(f)["records"]
            runs[tag] = (text, records)
            k1 = launch_counts()["flash_windowed_fused"] - before["flash_windowed_fused"]
            ok = "pure hybridgl:" in text and "hybridgl w/ spatial guidance:" in text and len(records) == n_sentences \
                and k1 >= 3 * 28
            log(f"{'PASS' if ok else 'FAIL'} CLI {tag} (python -m hybridgl_tpu_torch.cli.main, vit_h + ViT-B/16, random "
                f"weights): {len(records)} parity records for {n_sentences} sentences, result log rows present "
                f"{'pure hybridgl:' in text and 'hybridgl w/ spatial guidance:' in text}, K1 x {k1}, {wall:.1f} s in all "
                f"with weights and dataset set-up, on {card}")
            if not ok:
                fail(f"the CLI's result or parity log is wrong ({tag})")
    (seq_text, seq_rec), (dp_text, dp_rec) = runs.values()
    key = lambda r: (r["ref_id"], r["sentence"], r["pure_index"], r["final_index"])  # noqa: E731
    d_iou = max(max(abs(a["pure_iou"] - b["pure_iou"]), abs(a["final_iou"] - b["final_iou"])) for a, b in zip(dp_rec, seq_rec))
    ok = dp_text == seq_text and [key(r) for r in dp_rec] == [key(r) for r in seq_rec] and d_iou < 1e-5
    log(f"{'PASS' if ok else 'FAIL'} CLI --data_parallel == sequential CLI: same result log {dp_text == seq_text}, same "
        f"records {[key(r) for r in dp_rec] == [key(r) for r in seq_rec]}, IoU max|d| {d_iou:.2e}")
    if not ok:
        fail("the data-parallel CLI differs from the sequential CLI")


PROMPTS = (
    # name, predict arguments, tokens the decoder sees, K3's route at SAM's widths in bf16 (decoder_pass.pass_route)
    ("one point", dict(point_coords=[[320.0, 240.0]], point_labels=[1.0]), 7, "wgmma"),
    ("box", dict(box=[100.0, 80.0, 500.0, 400.0]), 7, "wgmma"),
    ("box + two points", dict(point_coords=[[320.0, 240.0], [120.0, 90.0]], point_labels=[1.0, 0.0],
                              box=[100.0, 80.0, 500.0, 400.0]), 9, "split"),
)
# K3's launches a predict call (two layer passes), all of them and those on the
# tensor cores: one PASS launch a pass, or on the split route one I2T launch on
# the CUDA cores and two T2I launches (64 context columns each) on the tensor cores
K3_LAUNCHES_PER_PREDICT = {"wgmma": (2, 2), "split": (6, 4)}


def _predict_kwargs(kw):
    import numpy as np

    return {k: np.asarray(v, np.float32) for k, v in kw.items()}


def phase_predictor(weights):
    """SamPredictor on the card: full width (launch counts, the K3 kernel each
    prompt takes, the decoder against its CPU plain versions from the card's
    embedding: low-res logits max|d| < 0.1 and IoU predictions |d| < 2e-2, the
    decoder's bar, and thresholded pixels > 99% equal: random weights leave
    many logits within bf16 rounding of the threshold, 99.6-99.8% measured),
    then test-tiny in f32 against the CPU end to end (> 99.5%, |d| < 2e-2)."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch import SamPredictor
    from hybridgl_tpu_torch.core.config import sam_preset
    from hybridgl_tpu_torch.core.params import init_sam, tree_map
    from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts, tc_launch_counts
    from hybridgl_tpu_torch.kernels.decoder_pass import pass_route

    cfg = sam_preset("vit_h")
    sam_p = weights[0]
    pred = SamPredictor(sam_p, cfg)
    if pred.device.type != "cuda":
        fail(f"predictor: the device defaults to the params', got {pred.device}")
    image = np.random.default_rng(0).integers(0, 255, (480, 640, 3), np.uint8)
    pred.set_image(image)  # warm-up
    reset_launch_counts()
    ms, _ = _wall_ms(lambda: pred.set_image(image))
    counts = launch_counts()
    ok = counts["flash_windowed_fused"] == 28 and counts["flash_attention_fused"] == 4 and pred.is_image_set
    log(f"{'PASS' if ok else 'FAIL'} predictor set_image (ViT-H, 480x640): {ms:.1f} ms, K1 x "
        f"{counts['flash_windowed_fused']}, K2 x {counts['flash_attention_fused']}")
    if not ok:
        fail("predictor: set_image did not launch K1 x 28 and K2 x 4")
    # the same decoder on the CPU (plain versions, bf16) from the card's embedding
    cpu = SamPredictor({k: tree_map(lambda _, t: t.cpu(), sam_p[k]) for k in ("prompt", "decoder")}, cfg, device="cpu")
    cpu._features, cpu._orig_hw, cpu._input_hw = pred.get_image_embedding().cpu(), pred._orig_hw, pred._input_hw
    totals = dict.fromkeys(("i2t_ln_then_t2i", "upscale_hyper_blocked"), 0)
    for name, kw, tokens, k3_kind in PROMPTS:
        for multimask in (True, False):
            kw_np = _predict_kwargs(kw)
            pred.predict(multimask_output=multimask, **kw_np)  # warm-up
            reset_launch_counts()
            ms, (masks, iou, low) = _wall_ms(lambda: pred.predict(multimask_output=multimask, **kw_np))
            counts, on_tc = launch_counts(), tc_launch_counts()
            k3 = (counts["i2t_ln_then_t2i"], on_tc["i2t_ln_then_t2i"])
            route = pass_route(torch.bfloat16, 4096, 256, 256, 8, 8 if tokens <= 8 else 16,
                               64 if tokens <= 8 else 128, False)
            M = 3 if multimask else 1
            logits = pred.predict(multimask_output=multimask, return_logits=True, **kw_np)[0]
            want_masks, want_iou, want_low = cpu.predict(multimask_output=multimask, **kw_np)
            agree = float((masks == want_masks).mean())
            d_iou = float(np.abs(iou - want_iou).max())
            d_low = float(np.abs(low - want_low).max())
            ok = (masks.shape == (M, 480, 640) and masks.dtype == np.bool_ and iou.shape == (M,)
                  and low.shape == (M, 256, 256) and bool(np.isfinite(low).all() and np.isfinite(iou).all())
                  and bool(np.isfinite(logits).all()) and route == k3_kind
                  and k3 == K3_LAUNCHES_PER_PREDICT[k3_kind] and counts["upscale_hyper_blocked"] == 1
                  and on_tc["upscale_hyper_blocked"] == 1 and agree > 0.99 and d_iou < 2e-2 and d_low < 0.1)
            log(f"{'PASS' if ok else 'FAIL'} predictor predict, {name} ({tokens} tokens), multimask {multimask}: "
                f"{ms:.1f} ms, K3 route {route} (expected {k3_kind}): {k3[0]} launches, {k3[1]} on the tensor cores "
                f"(expected {K3_LAUNCHES_PER_PREDICT[k3_kind]}), K4 x "
                f"{counts['upscale_hyper_blocked']} (wgmma {on_tc['upscale_hyper_blocked']}), masks {masks.shape}, "
                f"card vs CPU decoder: pixel agreement {agree:.6f}, IoU-pred max|d| {d_iou:.2e}, "
                f"low-res logits max|d| {d_low:.4f}")
            if not ok:
                fail(f"predictor: predict with {name} failed")
            for k in totals:
                totals[k] += counts[k]
    pred.reset_image()
    if pred.is_image_set:
        fail("predictor: reset_image left the image set")

    # end to end at test-tiny, f32: the card against the CPU
    tiny = sam_preset("test-tiny")
    g = torch.Generator().manual_seed(5)
    tiny_p = init_sam(g, tiny)
    for blk in tiny_p["encoder"]["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.2
    small = np.random.default_rng(1).integers(0, 255, (24, 32, 3), np.uint8)
    on_cpu = SamPredictor(tiny_p, tiny)
    on_card = SamPredictor(tree_map(lambda _, t: t.cuda(), tiny_p), tiny)
    on_cpu.set_image(small)
    on_card.set_image(small)
    scale = np.float32([32 / 640, 24 / 480] * 2)
    for name, kw, _, _ in PROMPTS:
        kw_np = {k: (v * scale[: v.shape[-1]] if k != "point_labels" else v) for k, v in _predict_kwargs(kw).items()}
        for multimask in (True, False):
            got = on_card.predict(multimask_output=multimask, **kw_np)
            want = on_cpu.predict(multimask_output=multimask, **kw_np)
            agree = float((got[0] == want[0]).mean())
            d_iou, d_low = float(np.abs(got[1] - want[1]).max()), float(np.abs(got[2] - want[2]).max())
            ok = agree > 0.995 and d_iou < 2e-2 and got[0].shape == want[0].shape
            log(f"{'PASS' if ok else 'FAIL'} predictor at test-tiny, f32, {name}, multimask {multimask} (card vs cpu): "
                f"pixel agreement {agree:.6f}, IoU-pred max|d| {d_iou:.2e}, low-res logits max|d| {d_low:.2e}")
            if not ok:
                fail(f"predictor: test-tiny parity with {name} failed")
    return totals


def phase_batched_sentences(pipe, samples):
    """Three sentences of one RefCOCO image through the sentence stage in one
    call (the runner's path: a leading sentence dimension) and one call a
    sentence, on the same features, on the image's own proposals and on 64
    live synthetic ones: a sentence's selections and IoUs do not depend on the
    sentences beside it."""
    import torch

    sentences = SENTENCES + ["the small cup to the right of the person"]
    sample = samples[1]._replace(sentences=sentences)
    g = pipe.cfg.guidance
    with torch.inference_mode():
        image_c = torch.from_numpy(sample.image_canonical).to(pipe.device)
        gt = torch.from_numpy(sample.gt_mask).to(pipe.device)
        rows = [pipe._row(sentence) for sentence in sentences]
        for label, props in (("the image's proposals", pipe.propose(sample)),
                             ("64 live synthetic proposals", _synthetic_full_bucket(pipe))):
            props = pipe._bucket_props(props)
            feats, gem_pf = pipe._feature_stage(props, image_c, (sample.h, sample.w))
            k1, k2 = min(g.k1, props.num), min(g.k2, props.num)

            def together(state):
                return _plain(pipe._sentence_stage(sample, props, feats, gem_pf, rows, k1, k2, gt, state))

            def one_by_one(state):
                return [r for sentence, row in zip(sentences, rows) for r in _plain(pipe._sentence_stage(
                    sample._replace(sentences=[sentence]), props, feats, gem_pf, [row], k1, k2, gt, state))]

            out = {}
            for mode, fn in (("one call a sentence", one_by_one), ("one call", together)):
                fn(pipe.init_state())  # warm-up
                state = pipe.init_state()
                ms, results = _wall_ms(lambda: fn(state))
                out[mode] = (ms, results, [float(v) for v in (*state.pure, *state.final)])
            (ms_l, r_l, s_l), (ms_b, r_b, s_b) = out["one call a sentence"], out["one call"]
            same = [(r.pure_index, r.final_index) for r in r_l] == [(r.pure_index, r.final_index) for r in r_b]
            d_sum = max(abs(a - b) for a, b in zip(s_l, s_b))
            ok = same and d_sum <= 1e-5 and len(r_b) == len(sentences)
            log(f"  sentence stage of 3 sentences, {label}: one call a sentence {ms_l:.1f} ms, one call {ms_b:.1f} ms")
            log(f"{'PASS' if ok else 'FAIL'} sentences in one call == one call a sentence, {label}: selections "
                f"{[(r.pure_index, r.final_index) for r in r_b]}, same {same}, IoU sums max|d| {d_sum:.2e}")
            if not ok:
                fail(f"the batched sentence stage depends on the batch ({label})")


def phase_prepared(pipe, samples, weights):
    """predict_masks on one 64-point chunk at full width in bf16: the prepared
    tree (built once by the pipeline) against the raw tree, on the decoder's
    bar, and the time of a chunk both ways (raw, prepared, prepared, raw)."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch.kernels import launch_counts
    from hybridgl_tpu_torch.models.sam.amg import build_point_grid
    from hybridgl_tpu_torch.models.sam.prompt_encoder import dense_pe, no_mask_dense
    from hybridgl_tpu_torch.models.sam.sam import encode, predict_points, preprocess_padded
    from hybridgl_tpu_torch.tools.check_kernels import time_ms

    cfg, raw, prepared = pipe.cfg, weights[0], pipe.sam_params
    if "prepared_final_t2i" in raw["decoder"]["transformer"] or "prepared_final_t2i" not in prepared["decoder"]["transformer"]:
        fail("prepared params: the pipeline did not prepare its own copy of the decoder params")
    sample = samples[1]
    with torch.inference_mode():
        x = preprocess_padded(torch.from_numpy(sample.image_1024).cuda(), (sample.rh, sample.rw), cfg.sam)
        emb = encode(prepared, x, cfg.sam)
        pe, dense = dense_pe(raw["prompt"], cfg.sam), no_mask_dense(raw["prompt"], cfg.sam, 1)[0]
        pts = torch.from_numpy(build_point_grid(8) * np.float32([sample.rw, sample.rh])).cuda()[:, None, :]
        labels = torch.ones((64, 1), device="cuda")
        call = lambda p: predict_points(p, emb, pts, labels, cfg.sam, True, pe=pe, dense=dense)  # noqa: E731
        before = launch_counts()
        (m_raw, iou_raw), (m_prep, iou_prep) = call(raw), call(prepared)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        wall, queued = {"raw": [], "prepared": []}, {"raw": [], "prepared": []}
        for name in ("raw", "prepared", "prepared", "raw"):
            p = raw if name == "raw" else prepared
            wall[name].append(statistics.median(_wall_ms(lambda: call(p))[0] for _ in range(10)))
            queued[name].append(time_ms(lambda: call(p), reps=5))
    d_logit = float((m_raw - m_prep).abs().max())
    agree = float(((m_raw > 0) == (m_prep > 0)).float().mean())
    d_iou = float((iou_raw - iou_prep).abs().max())
    ok = d_logit < 0.1 and agree > 0.995 and d_iou < 2e-2 and bool(torch.isfinite(m_prep).all()) \
        and delta["i2t_ln_then_t2i"] == 4 and delta["upscale_hyper_blocked"] == 2
    log(f"  decoder chunk of 64 points, wall of one call (median of 10): raw {[round(t, 2) for t in wall['raw']]} ms, "
        f"prepared {[round(t, 2) for t in wall['prepared']]} ms; back to back on the card's queue: raw "
        f"{[round(t, 2) for t in queued['raw']]} ms, prepared {[round(t, 2) for t in queued['prepared']]} ms")
    log(f"{'PASS' if ok else 'FAIL'} prepared decoder params == raw (full width, bf16): logits max|d| {d_logit:.4f}, "
        f"thresholded-pixel agreement {agree:.6f}, IoU-pred max|d| {d_iou:.2e}, K3 x {delta['i2t_ln_then_t2i']}, "
        f"K4 x {delta['upscale_hyper_blocked']} over the two calls")
    if not ok:
        fail("the prepared decoder params disagree with the raw tree")


def phase_dispatch_cost():
    """The host cost of a launch through the registered operators
    (tools/dispatch_cost.py: direct call, operator, custom_op, wrapper, on
    K1, K6, K5 and K3 at small shapes). Not a counted path."""
    from hybridgl_tpu_torch.tools.dispatch_cost import measure

    return measure(calls=1000, rounds=5, log=log)


_FRESH_LOAD = """
import json, sys, torch
from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts, tc_launch_counts
from hybridgl_tpu_torch.tools.export_serving import load_exported
tmp = sys.argv[1]
assert not {"jax", "jaxlib", "hybridgl_tpu"} & set(sys.modules)
args = torch.load(tmp + "/args.pt")
out, counts = {}, {}
with torch.no_grad():
    for name in ("sam_encoder", "hybrid_fusion"):
        program = load_exported(tmp + "/" + name + ".pt2").module()
        reset_launch_counts()
        out[name] = program(*args[name])
        counts[name] = [{k: v for k, v in launch_counts().items() if v},
                        {k: v for k, v in tc_launch_counts().items() if v}]
torch.save(out, tmp + "/fresh.pt")
print(json.dumps(counts))
"""


def phase_export(weights, card):
    """tools/export_serving.py at full width on the card: the SAM ViT-H
    encoder (the main path's bf16 weights, prepared) and the ViT-B/16 G2L
    fusion at P = 64, exported with torch.export on the card, saved, loaded in this process and in a fresh one that imports only the
    port; the graphs hold 28 + 4 torch.ops.hybridgl attention nodes and the
    G2L's 15 K6 nodes with its fused glue (G2L_NODES); one run of each loaded
    program against eager: cos > 0.999 (the encoder bar; equal expected: the
    same kernels on the same inputs), K1 +28, K2 +4 for the frame and K6 +15,
    every attention launch on the tensor cores, and each glue operator launched
    as often as it has nodes. Prints the .pt2 sizes and both times."""
    import tempfile

    import numpy as np
    import torch

    from hybridgl_tpu_torch.core.config import PipelineConfig
    from hybridgl_tpu_torch.kernels import launch_counts, tc_launch_counts
    from hybridgl_tpu_torch.models.sam.image_encoder import prepare_sam_params
    from hybridgl_tpu_torch.tools import export_serving as es

    cfg, P = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16", fusion_mode="G2L"), 64
    enc = prepare_sam_params({"encoder": weights[0]["encoder"]}, cfg.sam)["encoder"]
    visual = weights[1]["visual"]
    dev = visual["conv1"].device
    rng = np.random.default_rng(5)
    S, img = cfg.clip.image_size, cfg.sam.img_size
    grid = rng.random((P, 1, 14, 14)) > 0.5  # blocky masks: about half the patches in each proposal
    masks = torch.nn.functional.interpolate(torch.from_numpy(grid.astype(np.float32)), size=(S, S))[:, 0]
    image = torch.from_numpy(rng.standard_normal((1, img, img, 3)).astype(np.float32)).to(dev)
    local, glob = (torch.from_numpy(rng.standard_normal((P, S, S, 3)).astype(np.float32)).to(dev) for _ in range(2))
    args = {"sam_encoder": (enc, image), "hybrid_fusion": (visual, local, glob, masks.to(dev))}
    mb = es.fusion_masking_block(cfg)
    eager = {"sam_encoder": es.SamEncoder(cfg.sam), "hybrid_fusion": es.HybridFusion(cfg.clip, cfg.fusion_mode, mb)}
    want_nodes = {"sam_encoder": {"flash_windowed_fused": 28, "flash_attention_fused": 4,
                                  **SAM_GLUE_LAUNCHES_PER_IMAGE},
                  "hybrid_fusion": G2L_NODES}
    want_tc = {name: {k: v for k, v in nodes.items() if k in tc_launch_counts()} for name, nodes in want_nodes.items()}
    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        for name in args:
            t0 = time.perf_counter()
            program = (es.export_encoder(cfg, enc, dev) if name == "sam_encoder"
                       else es.export_fusion(cfg, visual, P, dev))
            export_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.pt2")
            torch.export.save(program, path)
            nodes = es.kernel_nodes(program)
            log(f"  export {name}: {export_s:.1f} s, {name}.pt2 {os.path.getsize(path)} bytes "
                f"({os.path.getsize(path) / 1e6:.2f} MB), kernel nodes {nodes}")
            if nodes != want_nodes[name]:
                fail(f"exported {name}: kernel nodes {nodes}, expected {want_nodes[name]}")
            loaded = es.load_exported(path).module()
            with torch.no_grad():
                want = eager[name](*args[name])
                before, tc_before = launch_counts(), tc_launch_counts()
                first_ms, got = _wall_ms(lambda: loaded(*args[name]))
                delta = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
                tc_delta = {k: v - tc_before[k] for k, v in tc_launch_counts().items() if v != tc_before[k]}
                loaded_ms = statistics.median(_wall_ms(lambda: loaded(*args[name]))[0] for _ in range(3))
                eager_ms = statistics.median(_wall_ms(lambda: eager[name](*args[name]))[0] for _ in range(3))
            g, w = got.float().flatten(), want.float().flatten()
            cos = float(g @ w / (g.norm() * w.norm()))
            d = float((g - w).abs().max())
            ok = cos > 0.999 and bool(torch.isfinite(g).all()) and delta == want_nodes[name] and tc_delta == want_tc[name]
            log(f"  {name}: loaded program {first_ms:.1f} ms (first call), {loaded_ms:.1f} ms (median of 3); "
                f"eager {eager_ms:.1f} ms; on {card}")
            log(f"{'PASS' if ok else 'FAIL'} exported {name} (loaded, on the card) == eager: cos {cos:.6f}, max|d| "
                f"{d:.3e}, equal {torch.equal(got, want)}, launches {delta}, on the tensor cores {tc_delta}")
            if not ok:
                fail(f"the exported {name} differs from the eager port or missed its kernels")
            outs[name] = want
        torch.save(args, os.path.join(tmp, "args.pt"))
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=REPO)
        done = subprocess.run([sys.executable, "-c", _FRESH_LOAD, tmp], cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=600)
        if done.returncode != 0:
            fail(f"loading the exported programs in a fresh process failed: {done.stderr[-3000:]}")
        counts = json.loads(done.stdout.strip().splitlines()[-1])
        fresh = torch.load(os.path.join(tmp, "fresh.pt"))
        for name, want in outs.items():
            g, w = fresh[name].float().flatten(), want.float().flatten()
            cos = float(g @ w / (g.norm() * w.norm()))
            launched, on_tc = counts[name]
            ok = cos > 0.999 and launched == want_nodes[name] and on_tc == want_tc[name]
            log(f"{'PASS' if ok else 'FAIL'} exported {name} loaded in a fresh process (the port alone): cos "
                f"{cos:.6f}, max|d| {float((g - w).abs().max()):.3e} against eager here, launches {launched}, "
                f"on the tensor cores {on_tc} ({time.perf_counter() - t0:.1f} s for the process)")
            if not ok:
                fail(f"the exported {name} loaded in a fresh process differs or missed its kernels")
    del outs, fresh, args
    torch.cuda.empty_cache()


def phase_data_parallel(pipe, card):
    """Two ranks on cuda:0 over gloo run the sticky data-parallel step +
    finalize_sticky (parallel/full_eval.py:run_chunks) on four full-width
    RefCOCO images; the parent runs run_image over the same four in order on
    the same weights (seed 0). Random weights leave one NMS survivor an image,
    so both sides replace every image's bundle with the same stamped survivors
    (21, 5, 33 and 2 live blobs, seeded by the image): the selections range
    over the slots and the sticky clamp shrinks from image to image, (3, 6) ->
    (3, 5) -> (2, 2). Equal clamp and selections, accumulators to rtol 1e-5;
    each rank launched the RefCOCO path's kernels for its two images."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch.parallel import launch, workers

    rng = np.random.default_rng(11)
    samples = [_sample(rng, 1024, 640, 480, 640, 768, 1024, (100, 150, 300, 400)) for _ in range(4)]
    survival, hw = [21, 5, 33, 2], (480, 640)
    state = pipe.init_state()
    pipe.run_image(samples[0], pipe.init_state())  # warm-up
    pipe.survival_hook = workers.survival_stamp(pipe.cfg, survival, hw, pipe.device)
    t_seq, seq = _wall_ms(lambda: [_plain(pipe.run_image(smp, state)) for smp in samples])
    pipe.survival_hook = None
    spec = dict(cfg=pipe.cfg, samples=samples, seed=0, dtype="bfloat16", repeats=2, survival=survival, survival_hw=hw)
    t0 = time.perf_counter()
    out = launch.spawn_workers(workers.eval_worker, 2, (spec,), "cuda", timeout=600.0)
    spawn_s = time.perf_counter() - t0
    par = out[0]
    want = [(b, si, r.pure_index, r.final_index) for b, rs in enumerate(seq) for si, r in enumerate(rs)]
    same_sel = [rec[:4] for rec in par["records"]] == want
    d_iou = max(max(abs(rec[4] - r.pure_iou), abs(rec[5] - r.final_iou))
                for rec, r in zip(par["records"], [r for rs in seq for r in rs]))
    acc_seq = np.float64([float(v) for v in (*state.pure, *state.final)])
    acc_par = np.float64(par["pure"] + par["final"])
    same_acc = bool(np.allclose(acc_par, acc_seq, rtol=1e-5))
    short = {o["rank"]: {k: o["launches"][k] for k, n in MIN_LAUNCHES_PER_IMAGE.items() if o["launches"][k] < 2 * n}
             for o in out}
    off_tc = {o["rank"]: {k: (n, o["launches"][k]) for k, n in o["tc_launches"].items() if n != o["launches"][k]}
              for o in out}
    picked = sorted({i for rec in par["records"] for i in rec[2:4]})
    ok = same_sel and d_iou < 1e-5 and same_acc and (par["k1"], par["k2"]) == (state.k1, state.k2) == (2, 2) \
        and len(picked) >= 3 and not any(short.values()) and not any(off_tc.values()) and par["images"] == 4
    for o in out:
        log(f"  rank {o['rank']}: {o['seconds'] * 1e3 / 2:.1f} ms a chunk of 2 images, launches "
            f"{ {k: o['launches'][k] for k in MIN_LAUNCHES_PER_IMAGE} }")
    log(f"  data parallel, 2 ranks on one card over gloo: {par['seconds'] * 1e3 / 4:.1f} ms/img; sequential run_image "
        f"{t_seq / 4:.1f} ms/img; on {card} (the ranks' start, weights and warm-up took {spawn_s:.1f} s)")
    log(f"{'PASS' if ok else 'FAIL'} data-parallel step + finalize_sticky == run_image in order (4 RefCOCO images, full "
        f"width, {survival} stamped survivors): same selections {same_sel} over proposals {picked}, IoU max|d| "
        f"{d_iou:.2e}, accumulators to rtol 1e-5 {same_acc}, k1/k2 {(par['k1'], par['k2'])} vs {(state.k1, state.k2)}, "
        f"kernels short {short}, off the tensor cores {off_tc}")
    if not ok:
        fail("the data-parallel step differs from the sequential runner")
    return out


def phase_encoder_tp(card):
    """The tensor-parallel encoder, mp = 2, both ranks on cuda:0 over gloo,
    ViT-H in bf16: each rank's replicated output against encode_image on the
    same rank (cos > 0.999, the encoder's bar); 8 heads a rank through K1 (28
    launches) and K2 (4), every launch on the tensor-core kernel."""
    import numpy as np

    from hybridgl_tpu_torch.core.config import PipelineConfig
    from hybridgl_tpu_torch.parallel import launch, workers

    image = np.random.default_rng(3).standard_normal((1, 1024, 1024, 3)).astype(np.float32)
    spec = dict(cfg=PipelineConfig(sam_model="vit_h"), seed=0, dtype="bfloat16", mp=2, image=image, repeats=2, compare=True)
    out = launch.spawn_workers(workers.encoder_tp_worker, 2, (spec,), "cuda", timeout=600.0)
    for o in out:
        k1, k2 = o["launches"]["flash_windowed_fused"], o["launches"]["flash_attention_fused"]
        t1, t2 = o["tc_launches"]["flash_windowed_fused"], o["tc_launches"]["flash_attention_fused"]
        ok = o["cos"] > 0.999 and o["finite"] and (k1, k2) == (28, 4) and (t1, t2) == (28, 4)
        log(f"{'PASS' if ok else 'FAIL'} tensor-parallel encoder, mp = 2, rank {o['rank']} (ViT-H, bf16, gloo on one "
            f"card): cos {o['cos']:.6f}, max|d| {o['max_abs_diff']:.4f} against encode_image, K1 x {k1} ({t1} on the "
            f"tensor cores), K2 x {k2} ({t2}), {o['seconds'] * 1e3:.1f} ms a frame, on {card}")
        if not ok:
            fail("the tensor-parallel encoder differs from the single-process encoder")
    return out


def phase_dryrun():
    from hybridgl_tpu_torch.tools.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    r = dryrun_multichip(4, "cuda", timeout=600.0)
    ok = r["mesh"] == {"dp": 2, "mp": 2} and r["sentences"] == 4 and r["ragged_sentences"] == 6 \
        and r["multicrop_sentences"] == 4 and r["tp_max_abs_diff"] < 2e-4 and r["device"].startswith("cuda")
    log(f"{'PASS' if ok else 'FAIL'} dryrun_multichip(4) on the card (4 ranks on {r['device']}, gloo): {r}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not ok:
        fail("the multi-device dry run failed on the card")


_DEMO = """
import contextlib, io, json, runpy, sys
import torch
from torch.utils._python_dispatch import TorchDispatchMode
import hybridgl_tpu_torch.core.config as config
from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts


class Shapes(TorchDispatchMode):  # the first operand's shape of every torch.ops.hybridgl call a replay launches
    def __init__(self):
        super().__init__()
        self.shapes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        # the proposal stage is a CUDA graph: its calls reach the dispatcher once, at the capture, and each replay
        # launches them (the warm-up before the capture is set-up, as the launch counters have it)
        if name.startswith("hybridgl::") and torch.cuda.is_current_stream_capturing():
            self.shapes.setdefault(name.split("::")[1], []).append(list(args[0].shape))
        return func(*args, **(kwargs or {}))


def demo(argv):
    reset_launch_counts()
    sys.argv = ["hybridgl_tpu_torch.cli.demo", *argv]
    out = io.StringIO()
    with Shapes() as mode, contextlib.redirect_stdout(out):
        runpy.run_module("hybridgl_tpu_torch.cli.demo", run_name="__main__", alter_sys=True)
    return {"stdout": out.getvalue(), "launches": launch_counts(), "shapes": mode.shapes}


tmp, args = sys.argv[1], sys.argv[2:]
runs = {"defaults": demo(args + ["--out", tmp + "/at_defaults.jpg"])}
amg = config.AmgConfig  # the demo again, the quality thresholds zeroed as the bench does for random weights
config.AmgConfig = lambda **kw: amg(**dict(dict(pred_iou_thresh=0.0, stability_score_thresh=0.0), **kw))
runs["thresholds zeroed"] = demo(args + ["--out", tmp + "/overlay.jpg"])
assert not {"jax", "jaxlib", "hybridgl_tpu"} & set(sys.modules)
print(json.dumps(runs))
"""


def phase_demo(card):
    """The port's demo as a user runs it (``python -m hybridgl_tpu_torch.cli.demo
    --random-weights``: SAM ViT-B, CLIP ViT-B/16, 8 x 8 points, G2L) on a
    synthetic 480x640 image, in a process of its own that records the shape
    of every kernel operator's first operand in the captured proposal stage
    (what its replay launches); twice: at its defaults, where
    random weights pass none of the AMG's quality thresholds (it prints "no
    proposals found" and writes nothing, as the reference's demo does), then
    with those two thresholds zeroed as the bench does, where it writes its
    overlay. Each run: exit code 0, K1 x 8 on [25 windows x 12 heads, 196, 64]
    and K2 x 4 on [12, 4096, 64] (ViT-B: 12 blocks, 4 of them global), NMS x
    1; the second, the overlay at the image's size. Returns the process's
    launch counts (both runs)."""
    import tempfile

    import numpy as np
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        img, out = os.path.join(tmp, "image.png"), os.path.join(tmp, "overlay.jpg")
        Image.fromarray(np.random.default_rng(8).integers(0, 255, (480, 640, 3), np.uint8)).save(img)
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-c", _DEMO, tmp, "--img_path", img, "--ref_text", "the dog on the left",
                               "--random-weights"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if done.returncode != 0:
            fail(f"the demo exited with {done.returncode}: {done.stderr[-3000:]}")
        runs = json.loads(done.stdout.strip().splitlines()[-1])
        written = Image.open(out).size if os.path.exists(out) else None
        at_defaults = os.path.exists(os.path.join(tmp, "at_defaults.jpg"))
    total = {}
    for tag, run in runs.items():
        for line in run["stdout"].strip().splitlines():
            log(f"  demo, {tag}: {line}")
        launches, shapes = run["launches"], run["shapes"]
        k1, k2 = shapes.get("flash_windowed_fused", []), shapes.get("flash_attention_fused", [])
        printed = "no proposals found" in run["stdout"] if tag == "defaults" else f"wrote {out}" in run["stdout"]
        ok = (printed and launches["flash_windowed_fused"] == len(k1) == 8
              and launches["flash_attention_fused"] == len(k2) == 4 and launches["nms"] == 1
              and all(s == [25 * 12, 196, 64] for s in k1) and all(s == [12, 4096, 64] for s in k2))
        ok = ok and (not at_defaults if tag == "defaults" else written == (640, 480))
        log(f"{'PASS' if ok else 'FAIL'} demo, {tag} (python -m hybridgl_tpu_torch.cli.demo --random-weights, vit_b + "
            f"ViT-B/16): rc {done.returncode}, overlay {written if tag != 'defaults' else 'none (no proposal passes)'}, "
            f"K1 x {len(k1)} on {k1[:1]}, K2 x {len(k2)} on {k2[:1]}, launches "
            f"{dict((k, v) for k, v in launches.items() if v)}")
        if not ok:
            fail(f"the demo ({tag}) printed the wrong outcome, wrote no overlay or missed its kernels at ViT-B's "
                 "12 heads of head dim 64")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    log(f"  demo: both runs {seconds:.1f} s in all with weights, on {card}")
    return total


def phase_bench():
    """tools/bench.py as a user runs it, at BENCH_ITERS=4 BENCH_REPS=3; its JSON line is echoed."""
    env = dict(os.environ, BENCH_ITERS="4", BENCH_REPS="3", BENCH_MC_ITERS="2", PYTHONPATH=REPO)
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "hybridgl_tpu_torch.tools.bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    for line in done.stderr.strip().splitlines()[-8:]:
        log(f"  bench: {line}")
    if done.returncode != 0:
        fail(f"tools/bench.py exited with {done.returncode}: {done.stderr[-2000:]}")
    record = json.loads(done.stdout.strip().splitlines()[-1])
    need = ("metric", "value", "unit", "device", "power_limit_w", "realistic_survival_img_per_s", "device_ms_per_img",
            "stage_device_ms", "flops_per_img_t", "est_mfu_e2e", "est_mfu_device", "multicrop")
    missing = [k for k in need if k not in record]
    ok = not missing and record["value"] > 0 and record["multicrop"]["value"] > 0
    log(f"{'PASS' if ok else 'FAIL'} bench ({time.perf_counter() - t0:.1f} s): {json.dumps(record)}")
    if not ok:
        fail(f"tools/bench.py's record is incomplete: missing {missing}")
    return record


def main(argv):
    card = phase_environment()
    phase_build()
    from hybridgl_tpu_torch.core.config import AMG_PHRASECUT, AMG_REFCOCO
    from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from hybridgl_tpu_torch.tools.check_kernels import KERNELS

    counts, paths = {}, {}
    # each path: the counts are set to 0 just before it and read just after
    reset_launch_counts()
    results = phase_kernels()
    counts["kernel check"] = launch_counts()
    phase_small_parity()
    weights = full_width_weights()
    for tag, amg, canonical, n_images, mins in (
        ("RefCOCO", AMG_REFCOCO, 640, 2, MIN_LAUNCHES_PER_IMAGE),
        ("PhraseCut", AMG_PHRASECUT, 1024, 1, MIN_LAUNCHES_PER_PHRASECUT_IMAGE),
    ):
        reset_launch_counts()
        paths[tag] = phase_pipeline(tag, amg, canonical, n_images, mins, weights)
        counts[tag] = launch_counts()
        missing = [k for k in mins if counts[tag][k] == 0]
        if missing:
            fail(f"kernels of the {tag} path never launched: {missing}")
    # CLIP ViT-L/14@336 as the scorer at RefCOCO settings: K6 at 577 tokens, 27 launches an image on the tensor cores
    reset_launch_counts()
    tag = "RefCOCO " + VIT_L14_336[0]
    phase_pipeline(tag, AMG_REFCOCO, 640, 1, MIN_LAUNCHES_PER_IMAGE, (weights[0], clip_weights(VIT_L14_336[0])),
                   clip_model=VIT_L14_336[0])
    counts[tag] = launch_counts()
    for tag in paths:
        phase_downloads(tag, *paths[tag], card)
    shares = phase_busy_share(paths, card)
    phase_stage_graph(paths, card, shares)
    phase_score_graph(paths, card, shares)
    reset_launch_counts()
    phase_fusion_modes(*paths["RefCOCO"])
    counts["fusion modes"] = launch_counts()
    reset_launch_counts()
    phase_dataset_path(*paths["RefCOCO"], card)
    counts["dataset path"] = launch_counts()
    reset_launch_counts()
    phase_predictor(weights)
    counts["predictor"] = launch_counts()
    reset_launch_counts()
    phase_batched_sentences(*paths["RefCOCO"])
    counts["batched sentences"] = launch_counts()
    reset_launch_counts()
    phase_prepared(*paths["RefCOCO"], weights)
    counts["prepared params"] = launch_counts()
    phase_dispatch_cost()
    reset_launch_counts()
    phase_export(weights, card)
    counts["serving export"] = launch_counts()
    # the parallel paths run in ranks of their own: each rank counts its launches and reports them
    for o in phase_data_parallel(paths["RefCOCO"][0], card):
        counts[f"data parallel, rank {o['rank']}"] = o["launches"]
    for o in phase_encoder_tp(card):
        counts[f"tensor-parallel encoder, rank {o['rank']}"] = o["launches"]
    phase_dryrun()
    phase_bench()
    counts["demo"] = phase_demo(card)
    if "--profile" in argv:  # opt-in: the stage breakdowns are not part of the contract run
        phase_profile(*paths["RefCOCO"])
        phase_multicrop_stages(*paths["PhraseCut"])
        from hybridgl_tpu_torch.tools.device_time import profile_image

        log("PhraseCut, one more image under torch.profiler:")
        pipe, samples = paths["PhraseCut"]
        profile_image(pipe, samples[-1], pipe.init_state(), log=log, top_n=15)

    import torch

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        launched = [counts["kernel check"]] if name in KERNEL_CHECK_ONLY else [
            c for tag, c in counts.items() if tag != "kernel check"]
        n = sum(c[name] for c in launched)
        if n == 0:
            fail(f"{name} never launched on its path")
        # max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms: measured by the kernel check
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=n, **{
            k: v for k, v in results[name].items() if k != "ok"}))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
