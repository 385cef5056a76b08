"""End-to-end zero-shot referring segmentation (port of hybridgl_tpu/pipeline/runner.py).

Per image:
  proposal stage  SAM encoder + AMG (models/sam/amg.py: single crop for
                  RefCOCO, one crop layer for PhraseCut, chosen by
                  cfg.amg.crop_n_layers), then the host small-region cleanup
                  (pipeline/postprocess.py) on the stage's hand-off
                  (pipeline/handoff.py)
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

The proposal stage is one dispatch, as the reference's one jitted program
(runner.py:361): on a CUDA device the pipeline's ``StageGraph``
(``pipeline/stage_graph.py``) captures the SAM encoder + AMG once for its
configuration and replays the graph for every image, whatever its size, after
copying the image's frames and geometry into the graph's inputs; off the card
the same stage function runs eagerly. The stage reads nothing back: its
counts stay on the device, and its hand-off (``pipeline/handoff.py``) packs
the masks and starts copying the first packed rows, the per-proposal fields
and a meta buffer (num, overflow, valid) to pinned host memory as soon as
the stage is queued. The finish side waits once, reads the meta buffer and
cleans only the live rows; the canonical image is uploaded once, at
dispatch, and handed on to the feature stage.

All of an image's sentences go through one sentence stage with a leading
sentence dimension (the reference's ``HYBRIDGL_BATCH_SENTENCES=1`` path). The
small-region cleanup is the native host pass by default, on the live rows
of the hand-off. ``HYBRIDGL_CLEANUP=device`` (the reference's switch, read when the
pipeline is built; default ``host``) runs the pass on tensors instead
(kernels/connected.py:cleanup_proposals_jit) where the masks are, with the
same results. Its time follows the masks: it takes as many sweeps as their
components are wound, on an H100 from a fifth of the host pass's time (clean
rectangles) to ten times it (speckled blobs; ``PERF.md``), so the host pass
stays the default.
``survival_hook``, where set, replaces the proposal bundle after the proposal
stage.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from dataclasses import dataclass
from typing import Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..lang import ExpressionParser, ParsedExpression, get_parser

from ..eval.metrics import IoUAccum, accumulate
from ..kernels.masks import box_xyxy_to_xywh
from ..kernels.resize import place_valid_region_antialias, resize_bilinear, valid_mask
from ..models.clip.fusion import calculate_score, hybrid_forward
from ..models.clip.text import encode_text
from ..models.gem.gem import gem_image_features, gem_preprocess
from ..models.sam.amg import Proposals
from ..models.sam.image_encoder import prepare_sam_params
from ..utils.buckets import next_pow2
from ..utils.transfer import upload
from .guidance import dir_flag_id, gem_mask_scores, normalize_heatmap, rela_flag_id, select_candidates
from .handoff import Handoff, fetch_rows, hand_off, receive, unpack_masks
from .postprocess import postprocess_small_regions
from .preprocess import build_crops
from .stage_graph import StageGraph


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


class Ingredients(NamedTuple):
    """What the selection of one image's sentences needs (the reference's
    ``parallel/full_eval.py:Ingredients``): score tables over S sentences and P
    proposal slots, and each proposal's (I, U, IoU) against the ground truth.
    The sequential runner selects from them at once; the data-parallel step
    ships them, stacked over a batch of images as numpy arrays (a leading axis
    B on every field), to the rank that replays the sticky clamp."""

    num: int  # live proposals (after the cleanup)
    score: torch.Tensor  # [S, P] f32 CLIP scores
    score_neg: torch.Tensor  # [S, P]
    gem_scores: torch.Tensor  # [S, P]
    boxes_xywh: torch.Tensor  # [P, 4]
    prop_valid: torch.Tensor  # [P] bool
    iu: torch.Tensor  # [P, 3] f32: (I, U, IoU) of each proposal against the ground truth


def cleanup_host(cfg: PipelineConfig, props: Proposals, hw, device, handoff: Optional[Handoff] = None) -> Proposals:
    """The small-region cleanup, the native host pass, on the live rows of
    the bundle's hand-off (``handoff``, made here from ``props`` when not
    given; the reference's runner.py:424-486): the packed rows up to the last
    live one are unpacked into this call's own buffer and cleaned in place.
    When nothing changed, ``props``' tensors come back as they are; else the
    live rows are packed again, uploaded and unpacked on the device, and the
    rows past the last live one are empty. ``num`` and ``overflow`` come back
    as ints, from the hand-off's meta buffer."""
    if handoff is None:
        handoff = hand_off(props, pack=True)
    received, valid = receive(handoff)
    props = props._replace(num=received.num, overflow=received.overflow)
    C, P = cfg.canonical_size, props.masks.shape[0]
    live = np.nonzero(valid)[0]
    n_live = int(live[-1]) + 1 if live.size else 0
    masks = np.zeros((P, C, C), np.uint8)
    if n_live:
        masks[:n_live] = np.unpackbits(fetch_rows(handoff, n_live), axis=-1, count=C)
    a = handoff.aux.numpy()
    host = Proposals(masks.view(np.bool_), a[: 4 * P].reshape(P, 4), a[4 * P : 5 * P], a[5 * P : 6 * P],
                     a[6 * P : 8 * P].reshape(P, 2), a[8 * P :], valid, num=props.num, overflow=props.overflow)
    amg = cfg.amg
    out, changed = postprocess_small_regions(host, amg.min_mask_region_area,
                                             max(amg.box_nms_thresh, amg.crop_nms_thresh), hw=hw, inplace_masks=True)
    if not changed:
        return props
    cleaned = torch.zeros((P, C, C), dtype=torch.bool, device=device)
    if n_live:
        cleaned[:n_live] = unpack_masks(upload(np.packbits(out.masks[:n_live], axis=-1), device), C)
    return Proposals(cleaned, *(upload(np.ascontiguousarray(f), device) for f in out[1:7]), num=out.num,
                     overflow=props.overflow)


def cleanup_on_device() -> bool:
    """``HYBRIDGL_CLEANUP=device``: the small-region cleanup runs on tensors
    where the masks are (the reference's switch; any other value, or none,
    selects the host pass)."""
    return os.environ.get("HYBRIDGL_CLEANUP", "host") == "device"


def cleanup_device(cfg: PipelineConfig, props: Proposals, hw, device) -> Proposals:
    """The small-region cleanup on tensors (kernels/connected.py) over the
    frame's valid ``hw`` corner, as the reference's runner.py:179-186: the
    host pass's masks, boxes and validity (a dead slot loses its pixels)."""
    from ..kernels.connected import cleanup_proposals_jit

    amg, C = cfg.amg, cfg.canonical_size
    return cleanup_proposals_jit(props, valid_mask((C, C), hw, device), amg.min_mask_region_area,
                                 max(amg.box_nms_thresh, amg.crop_nms_thresh))


def bucket_size(valid: torch.Tensor, num: int) -> int:
    """The smallest power-of-two bucket (min 8, at most all slots) covering
    the highest live index: the cleanup invalidates suppressed duplicates in
    place, so validity is not always a prefix."""
    live = torch.nonzero(valid).flatten()
    extent = int(live.max()) + 1 if live.numel() else num
    return min(next_pow2(extent, base=8), int(valid.shape[0]))


def fusion_features(cfg: PipelineConfig, clip_params, masks: torch.Tensor, image_c: torch.Tensor, h: int, w: int, mp=None):
    """Crops -> hybrid fusion features [P, E]. With ``mp``
    (``parallel/mesh.py:ProcessMesh.mp_shard``: ``index``, ``size``,
    ``all_gather``) each member of a model-parallel group runs the fusion on
    its P / size proposals and the group gathers the features."""
    if mp is not None:
        if masks.shape[0] % mp.size:
            raise ValueError(f"{masks.shape[0]} proposal slots do not split over {mp.size} model-parallel ranks")
        shard = masks.shape[0] // mp.size
        masks = masks[mp.index * shard : (mp.index + 1) * shard]
    glob, local = build_crops(image_c, masks, (h, w), cfg.crop_size, cfg.blur_ksize)
    feats = hybrid_forward(
        clip_params["visual"], local, glob, masks.float(), cfg.clip,
        fusion_mode=cfg.fusion_mode, masking_block=cfg.guidance.masking_block,
        compat=cfg.compat, masks_hw=(h, w),
    )
    return feats if mp is None else mp.all_gather(feats)


def feature_stage(cfg: PipelineConfig, clip_params, props: Proposals, image_c: torch.Tensor, h: int, w: int, mp=None):
    """Fusion features [P, E] (:func:`fusion_features`) and the normalised
    GEM patch features of one image."""
    feats = fusion_features(cfg, clip_params, props.masks, image_c, h, w, mp)
    # squash-resize the valid region to the GEM input (uint8 rounding as
    # the reference's PIL intermediate), then normalize
    gem_u8 = torch.round(
        resize_bilinear(image_c, (cfg.gem.img_size, cfg.gem.img_size), src_hw=(h, w))
    ).to(torch.uint8)
    gem_img = gem_preprocess(gem_u8, cfg.gem.img_size)
    # GEM patch features are text-independent: once per image
    gem_pf, _, _ = gem_image_features(clip_params["visual"], gem_img[None], cfg.clip, cfg.gem)
    gem_pf = gem_pf[0] / torch.clamp(torch.linalg.norm(gem_pf[0], dim=-1, keepdim=True), min=1e-6)
    return feats, gem_pf


def sentence_ingredients(cfg: PipelineConfig, clip_params, props: Proposals, feats, gem_pf, rows, hw, gt) -> Ingredients:
    """All sentences of an image through one sentence stage with a leading
    sentence dimension (the reference's ``_sentences_batched``, without its
    power-of-two sentence buckets: eager PyTorch compiles nothing per shape):
    the text encoder, both scores, the heatmap's resize, placement and
    normalisation and the per-mask GEM scores are batched. ``rows`` are
    ``HybridGLPipeline._row`` tuples. A sentence's scores do not depend on the
    sentences beside it. The one body of the sequential runner and of the
    data-parallel step (``parallel/full_eval.py``)."""
    C = cfg.canonical_size
    h, w = hw
    dev = feats.device
    S = len(rows)
    toks = upload(np.stack([r[0] for r in rows]), dev)  # [S, 2 + K, L]
    tf = encode_text(clip_params["text"], toks.reshape(-1, toks.shape[-1]), cfg.clip)
    tf = tf.reshape(S, toks.shape[1], -1)
    sent_f, np_f, other_f = tf[:, 0], tf[:, 1], tf[:, 2:]
    r = cfg.guidance.r
    ls = clip_params["logit_scale"]
    score = calculate_score(feats, r * sent_f + (1 - r) * np_f, ls).T  # [S, P]
    n_others = upload([r_[1] for r_ in rows], dev)
    k_mask = torch.arange(other_f.shape[1], device=dev)[None, :] < n_others[:, None]
    neg_sum = torch.where(k_mask[..., None], other_f, 0.0).sum(1)
    neg_mean = torch.where((n_others > 0)[:, None], neg_sum / torch.clamp(n_others, min=1)[:, None], 0.0)
    neg_norm = torch.clamp(torch.linalg.norm(neg_mean, dim=-1, keepdim=True), min=1e-6)
    score_neg = (torch.exp(ls) * (feats / torch.linalg.norm(feats, dim=-1, keepdim=True)) @ (neg_mean / neg_norm).T).T

    g = cfg.gem.img_size // cfg.clip.patch_size
    npf_n = np_f / torch.clamp(torch.linalg.norm(np_f, dim=-1, keepdim=True), min=1e-6)
    rel = (gem_pf @ npf_n.T).reshape(g, g, S)  # the sentence axis rides as the channel axis
    heat448 = resize_bilinear(rel, (cfg.gem.img_size, cfg.gem.img_size))
    heat = place_valid_region_antialias(heat448, (C, C), (h, w)).movedim(-1, 0)  # [S, C, C]
    vm = valid_mask((C, C), (h, w), dev)
    heat = normalize_heatmap(heat, vm, [r_[2] for r_ in rows])
    black = upload([r_[4] for r_ in rows], dev, torch.float32)
    gem_scores = gem_mask_scores(heat, props.masks, vm, black)  # [S, P]
    # every proposal's (I, U, IoU) against the ground truth (mask_iou, for all P at once)
    i = (props.masks & gt).sum(dim=(-2, -1)).float()
    u = (props.masks | gt).sum(dim=(-2, -1)).float()
    iou = torch.where(u == 0, 0.0, i / torch.clamp(u, min=1.0))
    return Ingredients(int(props.num), score, score_neg, gem_scores, box_xyxy_to_xywh(props.boxes_xyxy), props.valid,
                       torch.stack([i, u, iou], dim=-1))


def select_sentences(cfg: PipelineConfig, ing: Ingredients, rows, k1: int, k2: int):
    """``select_candidates`` per sentence (it branches on each sentence's
    flags in Python) -> [(pure_index, final_index)]."""
    sels = [
        select_candidates(ing.score[i], ing.score_neg[i], ing.boxes_xywh, ing.gem_scores[i], ing.prop_valid,
                          rows[i][3], rows[i][5], k1, k2, alpha=cfg.guidance.alpha)
        for i in range(len(rows))
    ]
    return [(sel.pure_index, sel.final_index) for sel in sels]


class HybridGLPipeline:
    def __init__(self, cfg: PipelineConfig, sam_params, clip_params, parser: Optional[ExpressionParser] = None, tokenizer=None, device=None):
        if cfg.amg.crop_n_layers > 1:
            raise NotImplementedError("AMG with more than one crop layer is not supported (nor by the reference)")
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else sam_params["prompt"]["pe_gaussian"].device
        # what depends on the weights alone is built once (the reference's runner.py:118-133)
        self.sam_params = prepare_sam_params(sam_params, cfg.sam)
        # the proposal stage, captured at the first image on a CUDA device (the reference's jit)
        self.stage = StageGraph(cfg, self.sam_params, self.device)
        self.clip_params = clip_params
        self.parser = parser or get_parser(rela_right_bug=cfg.compat.rela_right_bug)
        if tokenizer is None:
            from ..models.clip.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        self._sentence_rows = {}  # sentence -> parsed/tokenized row cache
        self.last_proposals: Optional[Proposals] = None  # run_image's bundle, for inspection
        self._warned_overflow = False
        self.timer = None  # optional utils.profiling.StageTimer: per-stage wall times
        self.survival_hook = None  # optional Proposals -> Proposals override after the proposal stage
        self._device_cleanup = cleanup_on_device()  # HYBRIDGL_CLEANUP=device, read once as the reference does

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
        return self._propose_with_image(sample)[0]

    def _propose_with_image(self, sample: ImageSample):
        """:meth:`propose`, and the canonical image's device copy that the
        dispatch uploaded, for the feature stage."""
        with self._span("proposals"):
            handoff, image_c = self._dispatch_proposals(sample)
        return self._finish_proposals(handoff, (sample.h, sample.w)), image_c

    def _dispatch_proposals(self, sample: ImageSample):
        """Upload the canonical image, launch the proposal stage and queue its
        hand-off (the reference's ``_dispatch_proposals``); waits for nothing.
        -> (Handoff, the canonical image on the device)."""
        image_c = upload(sample.image_canonical, self.device)
        props = self._launch_proposals(sample._replace(image_canonical=image_c))
        pack = self.cfg.amg.min_mask_region_area > 0 and not self._device_cleanup
        return hand_off(props, pack), image_c

    def _launch_proposals(self, sample: ImageSample) -> Proposals:
        """The proposal stage on the device (SAM encoder + AMG), launched and
        not waited for (``num`` and ``overflow`` device scalars): a replay of
        the pipeline's captured stage on a CUDA device."""
        return self.stage.launch(sample)

    def _finish_proposals(self, handoff: Handoff, hw) -> Proposals:
        """The host side of the proposal stage: one wait for the hand-off and
        its meta buffer, the overflow warning, the small-region cleanup and
        the survival hook."""
        cfg = self.cfg
        props, _ = receive(handoff)
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
                    props = (cleanup_device(cfg, props, hw, self.device) if self._device_cleanup
                             else self._cleanup_host(props, hw, handoff))
        if self.survival_hook is not None:
            # benchmarking and testing knob: random weights leave degenerate
            # NMS survival, a hook sets a representative bucket occupancy
            props = self.survival_hook(props)
        return props

    def _cleanup_host(self, props: Proposals, hw, handoff: Optional[Handoff] = None) -> Proposals:
        return cleanup_host(self.cfg, props, hw, self.device, handoff)

    @staticmethod
    def _bucket_props(props: Proposals) -> Proposals:
        """Slice to the smallest power-of-two bucket (min 8) covering the
        highest live index. Indices are unchanged."""
        return HybridGLPipeline._slice_props(props, bucket_size(props.valid, props.num))

    @staticmethod
    def _slice_props(props: Proposals, bucket: int) -> Proposals:
        """Slice the bundle to a known bucket size (no host reads)."""
        if bucket >= int(props.masks.shape[0]):
            return props
        return props._replace(**{f: getattr(props, f)[:bucket] for f in Proposals._fields[:7]})

    # ------------------------------------------------------------- stages
    def _feature_stage(self, props: Proposals, image_c: torch.Tensor, h: int, w: int):
        return feature_stage(self.cfg, self.clip_params, props, image_c, h, w)

    def _sentence_stage(self, sample, props, feats, gem_pf, rows, k1, k2, gt, state):
        """All sentences of an image: their ingredients in one batched call
        (:func:`sentence_ingredients`), then the selections and the IoU
        accumulation, sentence by sentence."""
        with self._span("sentence_stage"):
            ing = sentence_ingredients(self.cfg, self.clip_params, props, feats, gem_pf, rows, (sample.h, sample.w), gt)
            picks = select_sentences(self.cfg, ing, rows, k1, k2)
        iou = ing.iu[:, 2].tolist()  # one download for every sentence's two IoUs
        results = []
        for sentence, (pure_index, final_index) in zip(sample.sentences, picks):
            if sample.gt_mask is not None:
                state.pure = accumulate(state.pure, ing.iu[pure_index])
                state.final = accumulate(state.final, ing.iu[final_index])
            results.append(SentenceResult(sentence, pure_index, final_index, iou[pure_index], iou[final_index]))
        return results

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
        :meth:`run_image` gives image by image; mutates ``state``. The stage
        reads nothing back, so the whole of image i+1's stage is queued
        before image i's cleanup starts."""
        pending = None  # (sample, Handoff, canonical image on the device)
        for sample in samples:
            with self._span("proposals_dispatch"):
                launched = (sample, *self._dispatch_proposals(sample))
            if pending is not None:
                yield self._emit(*pending, state, yield_props)
            pending = launched
        if pending is not None:
            yield self._emit(*pending, state, yield_props)

    def _emit(self, sample: ImageSample, handoff: Handoff, image_c, state: PipelineState, yield_props: bool):
        props = self._finish_proposals(handoff, (sample.h, sample.w))
        self.last_proposals = props
        results = self._score_image(sample, props, state, image_c)
        return (sample, results, props) if yield_props else (sample, results)

    @torch.inference_mode()
    def run_image(self, sample: ImageSample, state: PipelineState) -> List[SentenceResult]:
        """Process one image; mutates the ``state`` accumulators and clamps."""
        props, image_c = self._propose_with_image(sample)
        self.last_proposals = props
        return self._score_image(sample, props, state, image_c)

    @torch.inference_mode()
    def _score_image(self, sample: ImageSample, props: Proposals, state: PipelineState,
                     image_c: Optional[torch.Tensor] = None) -> List[SentenceResult]:
        """Feature and sentence stages for one image's proposal bundle;
        ``image_c`` is the canonical image on the device, if the dispatch
        uploaded it."""
        num_props = int(props.num)
        C = self.cfg.canonical_size
        if num_props == 0:
            # no proposal survived: a miss per sentence (the reference would
            # crash on torch.stack([]))
            gt_area = float(np.sum(sample.gt_mask)) if sample.gt_mask is not None else 0.0
            out = []
            for s in sample.sentences:
                miss = tuple(upload(v, self.device) for v in (0.0, gt_area, 0.0))
                state.pure = accumulate(state.pure, miss)
                state.final = accumulate(state.final, miss)
                out.append(SentenceResult(s, -1, -1, 0.0, 0.0))
            return out

        props = self._bucket_props(props)
        if image_c is None:
            image_c = upload(sample.image_canonical, self.device)
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
            upload(sample.gt_mask, self.device)
            if has_gt
            else torch.zeros((C, C), dtype=torch.bool, device=self.device)
        )
        with self._span("parse+tokenize"):
            rows = [self._row(sentence) for sentence in sample.sentences]
        if not rows:
            return []
        return self._sentence_stage(sample, props, feats, gem_pf, rows, k1, k2, gt, state)


def materialize_results(results: List[SentenceResult]) -> List[SentenceResult]:
    """Plain Python values in every field (the reference's runner.py:804);
    the port's results already hold them, so this only normalises types."""
    return [
        SentenceResult(r.sentence, int(r.pure_index), int(r.final_index), float(r.pure_iou), float(r.final_iou))
        for r in results
    ]
