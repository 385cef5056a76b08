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

The feature and sentence stages (``pipeline/scoring.py``) read nothing back
either, as the reference's jitted ``feature_stage`` and
``sentence_stage_accum`` (runner.py:228-359): the image's (h, w), the
sentences' flags, the clamped k1/k2 (the sticky clamp stays on the host, as
ints) and the ground truth enter as device tensors, the selections and IoUs
stay device scalars in each ``SentenceResult`` until
:func:`materialize_results` reads an image's fields in one copy, and the
accumulators are updated on the device. On a CUDA device the pipeline's
``ScoreGraph`` (``pipeline/score_graph.py``) captures the feature stage once a
proposal bucket and the sentence stage once a (bucket, sentence bucket) and
replays them; off the card they run eagerly. All of an image's sentences go
through one sentence stage, padded to a power of two with row 0 repeated
(the reference's ``_sentences_batched``); the padding adds nothing. The
proposal bucket comes from the validity the hand-off's meta buffer brought
to the host. The small-region cleanup is the native host pass by default, on the live rows
of the hand-off. ``HYBRIDGL_CLEANUP=device`` (the reference's switch, read when the
pipeline is built; default ``host``) runs the pass on tensors instead
(kernels/connected.py:cleanup_proposals_jit) where the masks are, with the
same results. Its time follows the masks: it takes as many sweeps as their
components are wound, on an H100 from a fifth of the host pass's time (clean
rectangles) to ten times it (speckled blobs; ``PERF.md``), so the host pass
stays the default.
``survival_hook``, where set, replaces the proposal bundle after the proposal
stage: a benchmarking knob, whose bundle's count and validity are read once
to size its bucket, before the scoring stages, as are those of a bundle a
caller passes to ``_score_image`` itself.
``timer``, where set (``utils/profiling.py:StageTimer``), times the reference's
stage spans, and a ``host_wait`` span around each place where the host waits
on the device: the hand-off's wait, the rows past its prefetched head, and a
bundle whose count and validity are read from the device.
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
from ..kernels.resize import valid_mask
from ..models.sam.amg import Proposals
from ..models.sam.image_encoder import prepare_sam_params
from ..utils.transfer import upload
from .guidance import dir_flag_id, rela_flag_id
from .handoff import Handoff, fetch_rows, hand_off, receive, unpack_masks
from .postprocess import postprocess_small_regions
from .score_graph import ScoreGraph
from .scoring import (  # noqa: F401  (the stage functions' home; the data-parallel step imports them from here)
    Ingredients,
    SentenceInputs,
    bucket_size,
    feature_stage,
    fusion_features,
    select_sentences,
    sentence_arrays,
    sentence_ingredients,
    sentence_inputs,
    sentence_stage,
)
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
    """One sentence's selections and IoUs: device scalars out of the
    runner (:func:`materialize_results` reads them), Python numbers where
    no proposal survived."""

    sentence: str
    pure_index: torch.Tensor | int
    final_index: torch.Tensor | int
    pure_iou: torch.Tensor | float
    final_iou: torch.Tensor | float


@dataclass
class PipelineState:
    """Host-side mutable run state (sticky clamps + metric accumulators)."""

    k1: int
    k2: int
    pure: IoUAccum
    final: IoUAccum


def cleanup_host(cfg: PipelineConfig, props: Proposals, hw, device, handoff: Optional[Handoff] = None,
                 wait=contextlib.nullcontext) -> Proposals:
    """The small-region cleanup, the native host pass, on the live rows of
    the bundle's hand-off (``handoff``, made here from ``props`` when not
    given; the reference's runner.py:424-486): the packed rows up to the last
    live one are unpacked into this call's own buffer and cleaned in place.
    ``wait()`` encloses the host's wait for rows past the prefetched head.
    When nothing changed, ``props``' tensors come back as they are; else the
    live rows are packed again, uploaded and unpacked on the device, and the
    rows past the last live one are empty, and the hand-off's meta buffer
    takes the cleaned count and validity. ``num`` and ``overflow`` come back
    as ints, from the meta buffer."""
    if handoff is None:
        handoff = hand_off(props, pack=True)
    received, valid = receive(handoff)
    props = props._replace(num=received.num, overflow=received.overflow)
    C, P = cfg.canonical_size, props.masks.shape[0]
    live = np.nonzero(valid)[0]
    n_live = int(live[-1]) + 1 if live.size else 0
    masks = np.zeros((P, C, C), np.uint8)
    if n_live:
        with wait() if n_live > handoff.head.shape[0] else contextlib.nullcontext():  # rows past the head
            rows = fetch_rows(handoff, n_live)
        masks[:n_live] = np.unpackbits(rows, axis=-1, count=C)
    a = handoff.aux.numpy()
    host = Proposals(masks.view(np.bool_), a[: 4 * P].reshape(P, 4), a[4 * P : 5 * P], a[5 * P : 6 * P],
                     a[6 * P : 8 * P].reshape(P, 2), a[8 * P :], valid, num=props.num, overflow=props.overflow)
    amg = cfg.amg
    out, changed = postprocess_small_regions(host, amg.min_mask_region_area,
                                             max(amg.box_nms_thresh, amg.crop_nms_thresh), hw=hw, inplace_masks=True)
    if not changed:
        return props
    # the hand-off's host meta buffer describes the cleaned bundle from here on (its bucket)
    handoff.meta[0] = out.num
    handoff.meta[2:] = torch.from_numpy(np.asarray(out.valid, np.int32))
    cleaned = torch.zeros((P, C, C), dtype=torch.bool, device=device)
    if n_live:
        cleaned[:n_live] = unpack_masks(upload(np.packbits(out.masks[:n_live], axis=-1), device), C)
    return Proposals(cleaned, *(upload(np.ascontiguousarray(f), device) for f in out[1:7]), num=out.num,
                     overflow=props.overflow)


def meta_bucket(handoff: Handoff) -> int:
    """The scoring bucket of a received bundle, from the validity in the
    hand-off's host meta buffer (after the host cleanup, the cleaned one)."""
    meta = handoff.meta.numpy()
    return bucket_size(meta[2:] != 0, int(meta[0]))


def read_bucket(props: Proposals):
    """A bundle the hand-off did not bring to the host (the survival hook's,
    one cleaned on the device, a caller's own): its count and validity read
    once, outside the scoring stages. -> (the bundle with ``num`` an int,
    its scoring bucket)."""
    num, valid = int(props.num), props.valid.cpu().numpy()
    return props._replace(num=num), bucket_size(valid, num)


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
        # the feature and sentence stages, captured once a shape key on a CUDA device
        self.scorer = ScoreGraph(cfg, clip_params, self.device)
        self.parser = parser or get_parser(rela_right_bug=cfg.compat.rela_right_bug)
        if tokenizer is None:
            from ..models.clip.tokenizer import default_tokenizer

            tokenizer = default_tokenizer()
        self.tokenizer = tokenizer
        self._sentence_rows = {}  # sentence -> parsed/tokenized row cache
        self.last_proposals: Optional[Proposals] = None  # run_image's bundle, for inspection
        self._warned_overflow = False
        self.timer = None  # optional utils.profiling.StageTimer: per-stage wall times (and stream times on the card)
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
        """:meth:`propose`, the canonical image's device copy that the
        dispatch uploaded, for the feature stage, and the bundle's bucket."""
        with self._span("proposals"):
            handoff, image_c = self._dispatch_proposals(sample)
        props, bucket = self._finish_proposals(handoff, (sample.h, sample.w))
        return props, image_c, bucket

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

    def _finish_proposals(self, handoff: Handoff, hw):
        """The host side of the proposal stage: one wait for the hand-off and
        its meta buffer, the overflow warning, the small-region cleanup and
        the survival hook. -> (the bundle, ``num`` an int, and its scoring
        bucket, from the meta buffer's validity)."""
        cfg = self.cfg
        with self._span("host_wait"):
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
        host_valid = True
        if cfg.amg.min_mask_region_area > 0:
            with self._span("small_region_cleanup"):
                if props.num > 0:
                    if self._device_cleanup:
                        props, host_valid = cleanup_device(cfg, props, hw, self.device), False
                    else:
                        props = self._cleanup_host(props, hw, handoff, lambda: self._span("host_wait"))
        if self.survival_hook is not None:
            # benchmarking and testing knob: random weights leave degenerate
            # NMS survival, a hook sets a representative bucket occupancy
            props, host_valid = self.survival_hook(props), False
        # a bundle the meta buffer does not describe (the survival hook's, or
        # cleaned on the device, whose validity the reference's runner reads
        # back too) is read once, here
        return (props, meta_bucket(handoff)) if host_valid else self._read_bucket(props)

    def _cleanup_host(self, props: Proposals, hw, handoff: Optional[Handoff] = None,
                      wait=contextlib.nullcontext) -> Proposals:
        return cleanup_host(self.cfg, props, hw, self.device, handoff, wait)

    def _read_bucket(self, props: Proposals):
        """:func:`read_bucket`, in a ``host_wait`` span where it reads a tensor
        on the pipeline's device (a host ``num`` and ``valid`` are no wait)."""
        on_device = any(isinstance(v, torch.Tensor) and v.device.type == self.device.type
                        for v in (props.num, props.valid))
        with self._span("host_wait") if on_device else contextlib.nullcontext():
            return read_bucket(props)

    @staticmethod
    def _bucket_props(props: Proposals) -> Proposals:
        """Slice a caller's bundle to the smallest power-of-two bucket (min 8)
        covering the highest live index (its validity read once). Indices are
        unchanged."""
        return HybridGLPipeline._slice_props(*read_bucket(props))

    @staticmethod
    def _slice_props(props: Proposals, bucket: int) -> Proposals:
        """Slice the bundle to a known bucket size (no host reads)."""
        if bucket >= int(props.masks.shape[0]):
            return props
        return props._replace(**{f: getattr(props, f)[:bucket] for f in Proposals._fields[:7]})

    # ------------------------------------------------------------- stages
    @torch.inference_mode()
    def _feature_stage(self, props: Proposals, image_c, hw):
        """The feature stage of a bucketed bundle: (fusion features [B, E],
        GEM patch features), the score graph's buffers of the bucket."""
        return self.scorer.features(props, image_c, hw)

    @torch.inference_mode()
    def _sentence_stage(self, sample, props, feats, gem_pf, rows, k1, k2, gt, state):
        """All sentences of an image in one sentence stage, padded to a power
        of two (:func:`~hybridgl_tpu_torch.pipeline.scoring.sentence_stage`):
        the selections, their IoUs and the accumulators on the device. ``gt``
        the ground truth (host array, device tensor) or None; ``k1``/``k2``
        the clamped ints."""
        with self._span("sentence_stage"):
            acc = torch.stack([*state.pure, *state.final]).reshape(2, 4)
            out = self.scorer.sentences(props, feats, gem_pf, sentence_arrays(rows, gt is not None), (k1, k2), gt, acc)
        state.pure, state.final = IoUAccum(*out.acc[0]), IoUAccum(*out.acc[1])
        return [SentenceResult(sentence, out.picks[i, 0], out.picks[i, 1], out.iou[i, 0], out.iou[i, 1])
                for i, sentence in enumerate(sample.sentences)]

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
        props, bucket = self._finish_proposals(handoff, (sample.h, sample.w))
        self.last_proposals = props
        results = self._score_image(sample, props, state, image_c, bucket)
        return (sample, results, props) if yield_props else (sample, results)

    @torch.inference_mode()
    def run_image(self, sample: ImageSample, state: PipelineState) -> List[SentenceResult]:
        """Process one image; mutates the ``state`` accumulators and clamps."""
        props, image_c, bucket = self._propose_with_image(sample)
        self.last_proposals = props
        return self._score_image(sample, props, state, image_c, bucket)

    @torch.inference_mode()
    def _score_image(self, sample: ImageSample, props: Proposals, state: PipelineState,
                     image_c: Optional[torch.Tensor] = None, bucket: Optional[int] = None) -> List[SentenceResult]:
        """Feature and sentence stages for one image's proposal bundle, queued
        and not waited for; ``image_c`` is the canonical image on the device,
        if the dispatch uploaded it, and ``bucket`` the bundle's scoring
        bucket from :meth:`_finish_proposals`. A bundle without one (a
        caller's own) has its count and validity read once here, before the
        stages."""
        if bucket is None:
            props, bucket = self._read_bucket(props)
        num_props = props.num
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

        # sticky clamp on the host (reference: Hybridgl_main.py:178-181); its values enter the stage as device scalars
        if self.cfg.compat.k_clamp_sticky:
            state.k1 = min(state.k1, num_props)
            state.k2 = min(state.k2, num_props)
            k1, k2 = state.k1, state.k2
        else:
            k1 = min(self.cfg.guidance.k1, num_props)
            k2 = min(self.cfg.guidance.k2, num_props)
        with self._span("parse+tokenize"):
            rows = [self._row(sentence) for sentence in sample.sentences]
        if not rows:
            return []
        props = self._slice_props(props, bucket)
        with self._span("crops+fusion"):
            feats, gem_pf = self._feature_stage(props, sample.image_canonical if image_c is None else image_c,
                                                (sample.h, sample.w))
        return self._sentence_stage(sample, props, feats, gem_pf, rows, k1, k2, sample.gt_mask, state)


def materialize_results(results: List[SentenceResult]) -> List[SentenceResult]:
    """Plain Python values in every field (the reference's runner.py:804),
    the device scalars of all the results read in one copy: call it at the
    reporting boundary (once an image), not per field."""
    scalars = [v for r in results for v in r[1:] if isinstance(v, torch.Tensor)]
    host = iter(torch.stack([v.double() for v in scalars]).cpu().tolist() if scalars else [])
    plain = [[next(host) if isinstance(v, torch.Tensor) else v for v in r[1:]] for r in results]
    return [SentenceResult(r.sentence, int(p), int(f), float(pi), float(fi))
            for r, (p, f, pi, fi) in zip(results, plain)]
