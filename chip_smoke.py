"""On-card smoke test of the PyTorch/CUDA port (hybridgl_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (every phase asserts; any failure exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
  2. build: compiles the port's CUDA kernels from csrc/ (one nvcc per
     source, all at once, sm_90a);
  3. kernel check: ``hybridgl_tpu_torch.tools.check_kernels`` over all ten
     CUDA kernels against their plain PyTorch versions at production
     geometry, bf16 inputs, TF32 off, with median times beside each
     kernel's bound (operations or bytes) and, for the four attention
     kernels, the time of one ``scaled_dot_product_attention`` call on the
     same inputs (a yardstick, used nowhere in the port). K3 and K4 are
     held on both their kernels: the tensor-core (wgmma) one at B = 64 and
     at B = 128, the PhraseCut pass-2 batch, and the CUDA-core one in bf16
     at a shape the tensor-core dispatch refuses and in f32 at half width
     (its f32 operands do not fit in shared memory at full width). K5 and
     K6 likewise: the tensor-core kernels in bf16 at the served shapes (K5
     at the RefCOCO window and both PhraseCut windows, K6 with query row 0
     held on its own), the CUDA-core kernels in f32 and at a shape the
     tensor-core dispatch refuses (n = 200; hd = 32). The
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
     does) on one warm-up and three measured synthetic images, checking
     finite outputs, that every kernel of the path launched, and that every
     K5 and K6 launch took its tensor-core kernel;
  6. PhraseCut pipeline: the same at AMG_PHRASECUT (pps 64, one crop layer,
     P = 128, canonical 1024), one warm-up and two measured images;
  7. fusion modes: all six at full width on one RefCOCO image's proposals
     and on a bucket of 64 live synthetic proposals: finite features, and
     K6 launched as often as each mode's blocks need (the CLS-row bias in
     attn_masking, L2G and G2L&L2G);
  8. dataset path: run_dataset equals run_image on the three RefCOCO
     images, then the port's CLI (``hybridgl_tpu_torch.cli.main``) at full
     width on a synthetic REFER tree: the reference's result log, one
     parity record per sentence, ms/img.
The decoder runs its default route: the HYBRIDGL_FUSED_* switches are
removed from the environment at start. The second-to-last line is a JSON
object with one entry per kernel; the last line is the JSON contract line.
``--profile`` adds a breakdown of one more RefCOCO image (stage wall times,
device time by kernel from torch.profiler), the scoring stages on a full
bucket of 64 synthetic proposals, the RefCOCO ms/img with the four decoder
switches at 0 beside the default route, the decoder chunk times, the
multicrop stage times, and the device time of one more PhraseCut image.
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
DECODER_SWITCHES = tuple(f"HYBRIDGL_FUSED_{k}" for k in ("PASS", "I2T", "T2I", "UPSCALE"))
for _k in DECODER_SWITCHES:  # the contract run takes the default decoder route
    os.environ.pop(_k, None)

# the kernel-check entry point is the only path of K9 and K10 (as in the
# reference, whose serving paths run K2 and K5 instead); K1-K8 count the
# launches of the pipeline paths
KERNEL_CHECK_ONLY = ("flash_attention_rel_pos", "pass1_stats")
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
}
# the PhraseCut path adds the pass-2 re-decode on the per-prompt route: two
# K7 image->token updates and three K8 token->image attentions; its five
# encoder passes and 128 pass-1 chunks launch the others many times over
MIN_LAUNCHES_PER_PHRASECUT_IMAGE = dict(MIN_LAUNCHES_PER_IMAGE, i2t_ln_update=2, t2i_ctx=3)
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
    """All ten kernels through the kernel-check entry point."""
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


class _TinyVocabTokenizer:
    """Deterministic word ids inside the test-tiny CLIP's 101-token vocab."""

    sot_token, eot_token = 99, 100

    def encode(self, text):
        return [sum(map(ord, w)) % 97 + 1 for w in text.split()][:40]


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
                                    HeuristicParser(), _TinyVocabTokenizer(), device=dev)
            reset_launch_counts()
            results = pipe.run_image(sample, pipe.init_state())
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
                picks.append(p._score_image(sample, props, p.init_state()))
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


def phase_pipeline(tag, amg, canonical, n_images, min_launches, weights):
    """One main path at full width: SAM ViT-H + CLIP ViT-B/16, bf16, the
    given AMG with the quality thresholds zeroed as the reference bench does
    (random weights pass none of them), synthetic 480x640 images in the
    canonical frame; one warm-up image, then ``n_images`` measured."""
    import dataclasses

    import numpy as np
    import torch

    from hybridgl_tpu_torch.core.config import PipelineConfig
    from hybridgl_tpu_torch.lang import HeuristicParser
    from hybridgl_tpu_torch.kernels import launch_counts, tc_launch_counts
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline

    cfg = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16", fusion_mode="G2L", canonical_size=canonical,
                         amg=dataclasses.replace(amg, pred_iou_thresh=0.0, stability_score_thresh=0.0))
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
    # at full width in bf16 every K5 and K6 launch is the tensor-core kernel's
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


def phase_routes(pipe, samples):
    """RefCOCO ms/img and one decoder chunk (64 points) on the default route
    against the four switches at 0, in turns (default, off, off, default)."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch.models.sam.amg import build_point_grid
    from hybridgl_tpu_torch.models.sam.prompt_encoder import dense_pe, no_mask_dense
    from hybridgl_tpu_torch.models.sam.sam import encode, predict_points, preprocess_padded
    from hybridgl_tpu_torch.tools.check_kernels import time_ms

    cfg, p_sam = pipe.cfg, pipe.sam_params
    sample = samples[1]
    x = preprocess_padded(torch.from_numpy(sample.image_1024).cuda(), (sample.rh, sample.rw), cfg.sam)
    emb = encode(p_sam, x, cfg.sam)
    pe, dense = dense_pe(p_sam["prompt"], cfg.sam), no_mask_dense(p_sam["prompt"], cfg.sam, 1)[0]
    pts = torch.from_numpy(build_point_grid(8) * np.float32([sample.rw, sample.rh])).cuda()[:, None, :]
    labels = torch.ones((64, 1), device="cuda")
    per_route = {"default": [], "switches at 0": []}
    chunk = {"default": [], "switches at 0": []}
    for route in ("default", "switches at 0", "switches at 0", "default"):
        for k in DECODER_SWITCHES:
            if route == "default":
                os.environ.pop(k, None)
            else:
                os.environ[k] = "0"
        chunk[route].append(time_ms(lambda: predict_points(p_sam, emb, pts, labels, cfg.sam, True, pe=pe, dense=dense),
                                    reps=5))
        state = pipe.init_state()
        for smp in samples[1:3]:
            per_route[route].append(_wall_ms(lambda: pipe.run_image(smp, state))[0])
    for k in DECODER_SWITCHES:
        os.environ.pop(k, None)
    for route in per_route:
        log(f"  RefCOCO route {route}: median {statistics.median(per_route[route]):.1f} ms/img "
            f"({[round(t, 1) for t in per_route[route]]}); decoder chunk of 64 points "
            f"{[round(t, 2) for t in chunk[route]]} ms")


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
    hw = (sample.h, sample.w)
    full_grid = amg.build_point_grid(cfg.amg.points_per_side)
    crop_grid = amg.build_point_grid(cfg.amg.points_per_side // cfg.amg.crop_n_points_downscale_factor)
    cy0, cx0, ch, cw = amg._crop_boxes_layer1(*hw, cfg.amg.crop_overlap_ratio)[3]
    for name, grid, origin, extent, rhw in (
        ("pass 1, full-image crop (64 chunks)", full_grid, (0, 0), hw, (sample.rh, sample.rw)),
        ("pass 1, one layer-1 crop (16 chunks, x4 per image)", crop_grid, (cy0, cx0), (ch, cw), (sample.rh, sample.rw)),
    ):
        stages[name] = _wall_ms(lambda: amg._score_candidates(p_sam, emb, grid, origin, extent, rhw, hw, cfg.sam,
                                                              cfg.amg, cfg.canonical_size))[0]
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
    """run_dataset equals run_image on the three RefCOCO images; then the
    port's CLI at full width on a synthetic REFER tree."""
    import json
    import tempfile

    import torch

    from hybridgl_tpu_torch.cli.main import main as cli_main

    measured = samples[1:]
    state_a = pipe.init_state()
    seq = [pipe.run_image(smp, state_a) for smp in measured]
    state_b = pipe.init_state()
    piped = [results for _, results in pipe.run_dataset(iter(measured), state_b)]
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
        logs, parity = os.path.join(root, "logs"), os.path.join(root, "parity.json")
        t0 = time.perf_counter()
        cli_main(["--dataset", "refcoco", "--split", "val", "--refer_data_root", root, "--sam_model", "vit_h",
                  "--clip_model", "ViT-B/16", "--random-weights", "--device", "cuda", "--log_dir", logs,
                  "--parity_log", parity])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(logs, "result_log_refcoco_val.txt")) as f:
            text = f.read()
        with open(parity) as f:
            records = json.load(f)["records"]
    ok = "pure hybridgl:" in text and "hybridgl w/ spatial guidance:" in text and len(records) == n_sentences
    log(f"{'PASS' if ok else 'FAIL'} CLI (python -m hybridgl_tpu_torch.cli.main, vit_h + ViT-B/16, random weights): "
        f"{len(records)} parity records for {n_sentences} sentences, result log rows present "
        f"{'pure hybridgl:' in text and 'hybridgl w/ spatial guidance:' in text}, {wall:.1f} s in all with "
        f"weights and dataset set-up, on {card}")
    if not ok:
        fail("the CLI's result or parity log is wrong")


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
        ("RefCOCO", AMG_REFCOCO, 640, 3, MIN_LAUNCHES_PER_IMAGE),
        ("PhraseCut", AMG_PHRASECUT, 1024, 2, MIN_LAUNCHES_PER_PHRASECUT_IMAGE),
    ):
        reset_launch_counts()
        paths[tag] = phase_pipeline(tag, amg, canonical, n_images, mins, weights)
        counts[tag] = launch_counts()
        missing = [k for k in mins if counts[tag][k] == 0]
        if missing:
            fail(f"kernels of the {tag} path never launched: {missing}")
    reset_launch_counts()
    phase_fusion_modes(*paths["RefCOCO"])
    counts["fusion modes"] = launch_counts()
    reset_launch_counts()
    phase_dataset_path(*paths["RefCOCO"], card)
    counts["dataset path"] = launch_counts()
    if "--profile" in argv:  # opt-in: CUPTI tracing is not part of the contract run
        phase_profile(*paths["RefCOCO"])
        phase_routes(*paths["RefCOCO"])
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
