"""End-to-end zero-shot referring segmentation (port of hybridgl_tpu/pipeline/runner.py).

Per image:
  proposal stage  SAM encoder + AMG (models/sam/amg.py: single crop for
                  RefCOCO, one crop layer for PhraseCut, chosen by
                  cfg.amg.crop_n_layers), then the host small-region cleanup
                  (pipeline/postprocess.py)
  feature stage   crops (pipeline/preprocess.py) -> hybrid fusion features
                  in cfg.fusion_mode (models/clip/fusion.py) -> GEM patch
                  features
  sentence stage  text encoding (+ noun-phrase ensemble and negatives) ->
                  CLIP scores -> box-relation + GEM guidance -> selection ->
                  IoU accumulation

The host parses and tokenizes expressions and carries the reference's
sticky k1/k2 clamp (Hybridgl_main.py:178-181, CompatConfig.k_clamp_sticky).
Proposal bundles are sliced to the smallest power-of-two bucket covering
every live proposal before the feature stage, as the reference does.
``run_image`` processes one image; ``run_dataset`` iterates a dataset with
the next image's proposal stage launched before the current one's host
cleanup.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..lang import ExpressionParser, HeuristicParser, ParsedExpression

from ..eval.metrics import IoUAccum, accumulate, mask_iou
from ..kernels.masks import box_xyxy_to_xywh
from ..kernels.resize import place_valid_region_antialias, resize_bilinear, valid_mask
from ..models.clip.fusion import calculate_score, hybrid_forward
from ..models.clip.text import encode_text
from ..models.gem.gem import gem_image_features, gem_preprocess
from ..models.sam.amg import Proposals, generate_proposals, generate_proposals_multicrop
from .guidance import dir_flag_id, gem_mask_scores, normalize_heatmap, rela_flag_id, select_candidates
from .postprocess import postprocess_small_regions
from .preprocess import build_crops


class ImageSample(NamedTuple):
    """Host-prepared per-image inputs (the reference's ImageSample)."""

    image_1024: np.ndarray  # [1024, 1024, 3] uint8, long-side resized + padded
    rh: int  # valid rows in the 1024 frame
    rw: int
    image_canonical: np.ndarray  # [C, C, 3] uint8, original resolution at the origin
    h: int  # original height (<= C)
    w: int
    gt_mask: Optional[np.ndarray]  # [C, C] bool (None for demo)
    sentences: Sequence[str]


class SentenceResult(NamedTuple):
    sentence: str
    pure_index: int
    final_index: int
    pure_iou: float
    final_iou: float


@dataclass
class PipelineState:
    """Host-side mutable run state (sticky clamps + metric accumulators)."""

    k1: int
    k2: int
    pure: IoUAccum
    final: IoUAccum


def _next_pow2(n: int, base: int = 8) -> int:
    b = base
    while b < n:
        b *= 2
    return b


class HybridGLPipeline:
    def __init__(self, cfg: PipelineConfig, sam_params, clip_params, parser: Optional[ExpressionParser] = None, tokenizer=None, device=None):
        if cfg.amg.crop_n_layers > 1:
            raise NotImplementedError("AMG with more than one crop layer is not supported (nor by the reference)")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else sam_params["prompt"]["pe_gaussian"].device
        self.sam_params = sam_params
        self.clip_params = clip_params
        self.parser = parser or HeuristicParser(rela_right_bug=cfg.compat.rela_right_bug)
        if tokenizer is None:
            from ..models.clip.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        self._sentence_rows = {}  # sentence -> parsed/tokenized row cache
        self.last_proposals: Optional[Proposals] = None  # run_image's bundle, for inspection
        self._warned_overflow = False
        self.timer = None  # optional utils.profiling.StageTimer: per-stage wall times

    def _span(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.span(name)

    def init_state(self) -> PipelineState:
        g = self.cfg.guidance
        return PipelineState(g.k1, g.k2, IoUAccum.zeros(self.device), IoUAccum.zeros(self.device))

    # ----------------------------------------------------------- proposals
    @torch.inference_mode()
    def propose(self, sample: ImageSample) -> Proposals:
        """SAM proposals + the host small-region cleanup, which the reference
        applies whenever min_mask_region_area > 0 (automatic_mask_generator.py:166-171)."""
        with self._span("proposals"):
            props = self._launch_proposals(sample)
        return self._finish_proposals(props, (sample.h, sample.w))

    def _launch_proposals(self, sample: ImageSample) -> Proposals:
        """The proposal stage on the device (SAM encoder + AMG)."""
        cfg = self.cfg
        image_1024 = torch.from_numpy(np.asarray(sample.image_1024)).to(self.device)
        if cfg.amg.crop_n_layers >= 1:
            image_c = torch.from_numpy(np.asarray(sample.image_canonical)).to(self.device)
            props = generate_proposals_multicrop(
                self.sam_params, image_1024, sample.rh, sample.rw, image_c, sample.h, sample.w,
                cfg.sam, cfg.amg, cfg.canonical_size,
            )
        else:
            props = generate_proposals(
                self.sam_params, image_1024, sample.rh, sample.rw, sample.h, sample.w,
                cfg.sam, cfg.amg, cfg.canonical_size,
            )
        return props

    def _finish_proposals(self, props: Proposals, hw) -> Proposals:
        """The host side of the proposal stage: the overflow warning and the
        small-region cleanup."""
        cfg = self.cfg
        if props.overflow > 0 and not self._warned_overflow:
            # the reference keeps every NMS survivor; a full bucket drops some
            warnings.warn(
                f"proposal bucket overflow: {props.overflow} NMS survivor(s) dropped "
                f"(max_proposals={cfg.amg.max_proposals}, "
                f"max_candidates_per_crop={cfg.amg.max_candidates_per_crop})",
                stacklevel=2,
            )
            self._warned_overflow = True
        if cfg.amg.min_mask_region_area > 0:
            with self._span("small_region_cleanup"):
                if props.num > 0:
                    props = self._cleanup_host(props, hw)
        return props

    def _cleanup_host(self, props: Proposals, hw) -> Proposals:
        host = Proposals(*(t.cpu().numpy() if isinstance(t, torch.Tensor) else t for t in props))
        amg = self.cfg.amg
        out, changed = postprocess_small_regions(
            host, amg.min_mask_region_area, max(amg.box_nms_thresh, amg.crop_nms_thresh), hw=hw
        )
        if not changed:
            return props
        dev = self.device
        return Proposals(
            *(torch.from_numpy(np.ascontiguousarray(f)).to(dev) for f in out[:7]),
            num=out.num,
            overflow=out.overflow,
        )

    @staticmethod
    def _bucket_props(props: Proposals) -> Proposals:
        """Slice to the smallest power-of-two bucket (min 8) covering the
        highest live index: the cleanup invalidates suppressed duplicates in
        place, so validity is not always a prefix. Indices are unchanged."""
        P = int(props.masks.shape[0])
        live = torch.nonzero(props.valid).flatten()
        extent = int(live.max()) + 1 if live.numel() else props.num
        bucket = min(_next_pow2(extent), P)
        if bucket >= P:
            return props
        return props._replace(**{f: getattr(props, f)[:bucket] for f in Proposals._fields[:7]})

    # ------------------------------------------------------------- stages
    def _feature_stage(self, props: Proposals, image_c: torch.Tensor, h: int, w: int):
        cfg = self.cfg
        glob, local = build_crops(image_c, props.masks, (h, w), cfg.crop_size, cfg.blur_ksize)
        feats = hybrid_forward(
            self.clip_params["visual"], local, glob, props.masks.float(), cfg.clip,
            fusion_mode=cfg.fusion_mode, masking_block=cfg.guidance.masking_block,
            compat=cfg.compat, masks_hw=(h, w),
        )
        # squash-resize the valid region to the GEM input (uint8 rounding as
        # the reference's PIL intermediate), then normalize
        gem_u8 = torch.round(
            resize_bilinear(image_c, (cfg.gem.img_size, cfg.gem.img_size), src_hw=(h, w))
        ).to(torch.uint8)
        gem_img = gem_preprocess(gem_u8, cfg.gem.img_size)
        # GEM patch features are text-independent: once per image
        gem_pf, _, _ = gem_image_features(self.clip_params["visual"], gem_img[None], cfg.clip, cfg.gem)
        gem_pf = gem_pf[0] / torch.clamp(torch.linalg.norm(gem_pf[0], dim=-1, keepdim=True), min=1e-6)
        return feats, gem_pf

    def _sentence_stage(self, props, feats, gem_pf, h, w, row, k1, k2, gt_mask):
        cfg = self.cfg
        C = cfg.canonical_size
        toks_all, n_others, dir_flag, rela_flag, black, has_other = row
        tf = encode_text(self.clip_params["text"], torch.from_numpy(toks_all).to(self.device), cfg.clip)
        sent_f, np_f, other_f = tf[0], tf[1], tf[2:]
        r = cfg.guidance.r
        text_ensemble = r * sent_f + (1 - r) * np_f
        ls = self.clip_params["logit_scale"]
        score = calculate_score(feats, text_ensemble[None], ls)[:, 0]
        if n_others > 0:
            neg_mean = other_f[:n_others].sum(0) / n_others
        else:
            neg_mean = torch.zeros_like(other_f[0])
        # guard the zero vector (the reference leaves NaNs in the unused branch)
        neg_norm = torch.clamp(torch.linalg.norm(neg_mean), min=1e-6)
        score_neg = torch.exp(ls) * (feats / torch.linalg.norm(feats, dim=-1, keepdim=True)) @ (neg_mean / neg_norm)

        # GEM heatmap of the noun phrase, moved into the original (h, w)
        # corner of the canonical frame with antialias=True (Hybridgl_main.py:201)
        g = cfg.gem.img_size // cfg.clip.patch_size
        npf_n = np_f / torch.clamp(torch.linalg.norm(np_f), min=1e-6)
        rel = (gem_pf @ npf_n).reshape(g, g)
        heat448 = resize_bilinear(rel, (cfg.gem.img_size, cfg.gem.img_size))
        heat = place_valid_region_antialias(heat448, (C, C), (h, w))
        vm = valid_mask((C, C), (h, w), self.device)
        heat = normalize_heatmap(heat, vm, dir_flag)
        gem_scores = gem_mask_scores(heat, props.masks, vm, black)
        sel = select_candidates(
            score, score_neg, box_xyxy_to_xywh(props.boxes_xyxy), gem_scores, props.valid,
            rela_flag, has_other, k1, k2, alpha=cfg.guidance.alpha,
        )
        pure = mask_iou(props.masks[sel.pure_index], gt_mask)
        final = mask_iou(props.masks[sel.final_index], gt_mask)
        return sel, pure, final

    # --------------------------------------------------------------- host
    def _tokenize_parsed(self, parsed: ParsedExpression):
        from ..models.clip import tokenizer as tok

        K = self.cfg.guidance.max_other_nouns
        L = self.cfg.clip.context_length
        tk = dict(tokenizer=self.tokenizer, context_length=L, truncate=True)
        toks_all = np.zeros((2 + K, L), np.int32)
        toks_all[0] = tok.tokenize(parsed.sentence, **tk)[0]
        toks_all[1] = tok.tokenize(parsed.noun_phrase, **tk)[0]
        others = parsed.other_noun_phrases[:K]
        for i, noun in enumerate(others):
            toks_all[2 + i] = tok.tokenize("a photo of " + noun, **tk)[0]
        return toks_all, len(others)

    def _black(self, rela_flag: str) -> float:
        g = self.cfg.guidance
        if rela_flag == "big":
            return g.black_big
        if rela_flag == "small":
            return g.black_small
        return g.black_other

    def _row(self, sentence: str):
        row = self._sentence_rows.get(sentence)
        if row is None:
            parsed = self.parser.parse(sentence)
            toks_all, n_others = self._tokenize_parsed(parsed)
            row = (
                toks_all, n_others, dir_flag_id(parsed.dir_flag), rela_flag_id(parsed.rela_flag),
                self._black(parsed.rela_flag), bool(parsed.has_other_nouns),
            )
            if len(self._sentence_rows) < 65536:
                self._sentence_rows[sentence] = row
        return row

    @torch.inference_mode()
    def run_dataset(self, samples: Iterable[ImageSample], state: PipelineState, yield_props: bool = False):
        """Software-pipelined iteration (the reference's runner.py:568-591):
        image i+1's proposal stage is launched on the device before image i's
        host cleanup and scoring. Yields (sample, results), or (sample,
        results, proposals) with ``yield_props``, exactly what
        :meth:`run_image` gives image by image; mutates ``state``. The AMG
        reads its NMS counts on the host, so only the work queued after the
        last of those reads overlaps the previous image's cleanup."""
        pending = None  # (sample, launched proposals)
        for sample in samples:
            with self._span("proposals_dispatch"):
                launched = (sample, self._launch_proposals(sample))
            if pending is not None:
                yield self._emit(*pending, state, yield_props)
            pending = launched
        if pending is not None:
            yield self._emit(*pending, state, yield_props)

    def _emit(self, sample: ImageSample, props: Proposals, state: PipelineState, yield_props: bool):
        props = self._finish_proposals(props, (sample.h, sample.w))
        self.last_proposals = props
        results = self._score_image(sample, props, state)
        return (sample, results, props) if yield_props else (sample, results)

    @torch.inference_mode()
    def run_image(self, sample: ImageSample, state: PipelineState) -> List[SentenceResult]:
        """Process one image; mutates the ``state`` accumulators and clamps."""
        props = self.propose(sample)
        self.last_proposals = props
        return self._score_image(sample, props, state)

    @torch.inference_mode()
    def _score_image(self, sample: ImageSample, props: Proposals, state: PipelineState) -> List[SentenceResult]:
        """Feature and sentence stages for one image's proposal bundle."""
        num_props = int(props.num)
        C = self.cfg.canonical_size
        if num_props == 0:
            # no proposal survived: a miss per sentence (the reference would
            # crash on torch.stack([]))
            gt_area = float(np.sum(sample.gt_mask)) if sample.gt_mask is not None else 0.0
            out = []
            for s in sample.sentences:
                miss = tuple(torch.tensor(v, device=self.device) for v in (0.0, gt_area, 0.0))
                state.pure = accumulate(state.pure, miss)
                state.final = accumulate(state.final, miss)
                out.append(SentenceResult(s, -1, -1, 0.0, 0.0))
            return out

        props = self._bucket_props(props)
        image_c = torch.from_numpy(np.asarray(sample.image_canonical)).to(self.device)
        with self._span("crops+fusion"):
            feats, gem_pf = self._feature_stage(props, image_c, sample.h, sample.w)

        # sticky clamp (reference: Hybridgl_main.py:178-181)
        if self.cfg.compat.k_clamp_sticky:
            state.k1 = min(state.k1, num_props)
            state.k2 = min(state.k2, num_props)
            k1, k2 = state.k1, state.k2
        else:
            k1 = min(self.cfg.guidance.k1, num_props)
            k2 = min(self.cfg.guidance.k2, num_props)

        has_gt = sample.gt_mask is not None
        gt = (
            torch.from_numpy(np.asarray(sample.gt_mask)).to(self.device)
            if has_gt
            else torch.zeros((C, C), dtype=torch.bool, device=self.device)
        )
        with self._span("parse+tokenize"):
            rows = [self._row(sentence) for sentence in sample.sentences]
        results = []
        for sentence, row in zip(sample.sentences, rows):
            with self._span("sentence_stage"):
                sel, pure, final = self._sentence_stage(props, feats, gem_pf, sample.h, sample.w, row, k1, k2, gt)
            if has_gt:
                state.pure = accumulate(state.pure, pure)
                state.final = accumulate(state.final, final)
            results.append(
                SentenceResult(sentence, sel.pure_index, sel.final_index, float(pure[2]), float(final[2]))
            )
        return results


def materialize_results(results: List[SentenceResult]) -> List[SentenceResult]:
    """Plain Python values in every field (the reference's runner.py:804);
    the port's results already hold them, so this only normalises types."""
    return [
        SentenceResult(r.sentence, int(r.pure_index), int(r.final_index), float(r.pure_iou), float(r.final_iou))
        for r in results
    ]
