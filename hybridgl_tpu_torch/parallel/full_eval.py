"""Full-parity multi-GPU evaluation (counterpart of
hybridgl_tpu/parallel/full_eval.py): the complete per-image pipeline (SAM
proposals -> small-region cleanup -> crops -> fusion -> text ensembles and
negatives -> GEM heatmap -> box-relation guidance -> selection -> IoU) with
the images sharded over the ``dp`` axis of a process mesh (``mesh.py``) and,
optionally, the fusion stage's proposal axis over ``mp``.

Parity with the sequential runner (``pipeline/runner.py``) is exact:

  * a rank runs the runner's own stage functions (the proposal stage's
    ``StageGraph``, ``cleanup_host``, and ``pipeline/scoring.py``'s
    ``feature_stage``, ``sentence_ingredients`` and
    ``select_sentences``, on the runner's proposal and sentence buckets): one
    body, so what holds the runner holds this step. The scoring functions run
    eagerly here, since the step ships its ingredients to the host by design,
    as the reference's does;
  * the small-region cleanup inside the step is the runner's native host
    pass on the proposal stage's hand-off (``pipeline/handoff.py``:
    bit-packed masks, only the live rows to the host, the count from one meta
    buffer), a plain call in eager PyTorch (the reference reaches the same
    pass from inside its compiled step through a host callback, with
    bit-packed masks);
  * the reference's *sticky* k1/k2 clamp (Hybridgl_main.py:178-181) is a
    sequential mutation over the whole dataset, so with ``sticky=True`` the
    step returns each image's scoring INGREDIENTS (:class:`Ingredients`: a few
    kilobytes, :func:`ingredients_nbytes_per_image`; the runner's
    ``Ingredients`` with a leading image axis, as numpy arrays padded to the
    batch's sentence bucket and to ``max_proposals`` slots), gathered over ``dp`` in
    dataset order, and :func:`finalize_sticky` replays the selection in that
    order with the evolving clamp. The heavy work stays data parallel, the
    semantics stay sequential;
  * sentences are parsed and tokenized on the host up front
    (:func:`prepare_records`) and padded to a per-batch bucket with validity
    masking; only the valid ones are computed.

Collectives: one gather of the ingredients (sticky) or one sum of eight
scalars and a gather of the per-sentence results (non-sticky) over ``dp`` a
step, and the [P, E] gather over ``mp`` an image when enabled.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..eval.metrics import IoUAccum
from ..models.clip import tokenizer as tok
from ..models.sam.amg import Proposals
from ..pipeline.guidance import dir_flag_id, rela_flag_id
from ..pipeline.handoff import hand_off, receive
from ..pipeline.runner import cleanup_host, meta_bucket, read_bucket
from ..pipeline.scoring import (
    Ingredients,
    SentenceInputs,
    bucket_size,
    feature_stage,
    select_sentences,
    sentence_arrays,
    sentence_ingredients,
    sentence_inputs,
)
from ..pipeline.stage_graph import StageGraph
from ..utils.transfer import upload
from ..utils.buckets import next_pow2
from .mesh import ProcessMesh, params_device, shard_batch


class FullEvalBatch(NamedTuple):
    """Host-prepared batch; the leading axis B shards over dp."""

    image_1024: np.ndarray  # [B, S, S, 3] uint8
    rh: np.ndarray  # [B]
    rw: np.ndarray
    image_canonical: np.ndarray  # [B, C, C, 3] uint8
    h: np.ndarray
    w: np.ndarray
    gt_mask: np.ndarray  # [B, C, C] bool
    tokens_sentence: np.ndarray  # [B, S_max, L]
    tokens_np: np.ndarray  # [B, S_max, L]
    tokens_others: np.ndarray  # [B, S_max, K, L]
    n_others: np.ndarray  # [B, S_max]
    dir_flag: np.ndarray  # [B, S_max]
    rela_flag: np.ndarray  # [B, S_max]
    black: np.ndarray  # [B, S_max] f32
    has_other: np.ndarray  # [B, S_max] bool
    sentence_valid: np.ndarray  # [B, S_max] bool


def ingredients_nbytes_per_image(max_proposals: int, max_sentences: int) -> int:
    """Bytes of one image's :class:`Ingredients`: three [S, P] f32 score
    tables, [P, 4] f32 boxes, [P] bool validity, [P, 3] f32 I/U/IoU and one
    i32: 8,004 bytes at the RefCOCO configuration (P = 64, S = 8). The row
    that the sticky step gathers (:func:`_pack`) carries the count and the
    validity as f32 too: (1 + 3SP + 8P) * 4 bytes, 8,196 at that configuration."""
    P, S = max_proposals, max_sentences
    return 3 * S * P * 4 + P * 4 * 4 + P + P * 3 * 4 + 4


def prepare_records(samples, parser, cfg: PipelineConfig, tokenizer=None, max_sentences: int | None = None) -> FullEvalBatch:
    """Host-side batch assembly: parse and tokenize every sentence, pad to
    the sentence bucket, stack the images. ``max_sentences`` defaults to the
    batch's true maximum (nothing is truncated)."""
    samples = list(samples)
    if max_sentences is None:
        max_sentences = max((len(s.sentences) for s in samples), default=1) or 1
    g = cfg.guidance
    L = cfg.clip.context_length
    K = g.max_other_nouns
    tk = tokenizer or tok.default_tokenizer()

    arrays = {k: [] for k in FullEvalBatch._fields}
    for s in samples:
        arrays["image_1024"].append(s.image_1024)
        arrays["rh"].append(s.rh)
        arrays["rw"].append(s.rw)
        arrays["image_canonical"].append(s.image_canonical)
        arrays["h"].append(s.h)
        arrays["w"].append(s.w)
        arrays["gt_mask"].append(s.gt_mask if s.gt_mask is not None else np.zeros((cfg.canonical_size,) * 2, bool))
        ts = np.zeros((max_sentences, L), np.int32)
        tn = np.zeros((max_sentences, L), np.int32)
        to = np.zeros((max_sentences, K, L), np.int32)
        no = np.zeros(max_sentences, np.int32)
        df = np.zeros(max_sentences, np.int32)
        rf = np.zeros(max_sentences, np.int32)
        bl = np.full(max_sentences, g.black_other, np.float32)
        ho = np.zeros(max_sentences, bool)
        sv = np.zeros(max_sentences, bool)
        for i, sentence in enumerate(list(s.sentences)[:max_sentences]):
            parsed = parser.parse(sentence)
            kwargs = dict(tokenizer=tk, context_length=L, truncate=True)
            ts[i] = tok.tokenize(parsed.sentence, **kwargs)[0]
            tn[i] = tok.tokenize(parsed.noun_phrase, **kwargs)[0]
            for j, noun in enumerate(parsed.other_noun_phrases[:K]):
                to[i, j] = tok.tokenize("a photo of " + noun, **kwargs)[0]
            no[i] = min(len(parsed.other_noun_phrases), K)
            df[i] = dir_flag_id(parsed.dir_flag)
            rf[i] = rela_flag_id(parsed.rela_flag)
            bl[i] = g.black_big if parsed.rela_flag == "big" else g.black_small if parsed.rela_flag == "small" else g.black_other
            ho[i] = parsed.has_other_nouns
            sv[i] = True
        arrays["tokens_sentence"].append(ts)
        arrays["tokens_np"].append(tn)
        arrays["tokens_others"].append(to)
        arrays["n_others"].append(no)
        arrays["dir_flag"].append(df)
        arrays["rela_flag"].append(rf)
        arrays["black"].append(bl)
        arrays["has_other"].append(ho)
        arrays["sentence_valid"].append(sv)
    return FullEvalBatch(**{k: np.stack(v) for k, v in arrays.items()})


def _rows(rec: FullEvalBatch):
    """The runner's sentence rows (``HybridGLPipeline._row``) of one record's
    valid sentences, and their positions in the sentence bucket."""
    at = [int(i) for i in np.nonzero(rec.sentence_valid)[0]]
    rows = [
        (np.concatenate([rec.tokens_sentence[i][None], rec.tokens_np[i][None], rec.tokens_others[i]]),
         int(rec.n_others[i]), int(rec.dir_flag[i]), int(rec.rela_flag[i]), float(rec.black[i]), bool(rec.has_other[i]))
        for i in at
    ]
    return rows, at


def _image_ingredients(stage: StageGraph, clip_params, rec: FullEvalBatch, cfg: PipelineConfig, mesh: ProcessMesh,
                       mp_axis, survival_hook=None):
    """Proposals -> cleanup -> crops -> fusion -> per-sentence score tables
    and the per-proposal IoU table for one image, through the sequential
    runner's stage functions; ``stage`` is the rank's :class:`StageGraph`.
    Returns one flat f32 row (:func:`_pack`)."""
    dev = stage.device
    h, w = int(rec.h), int(rec.w)
    S, P = rec.sentence_valid.shape[0], cfg.amg.max_proposals
    # the canonical image once, for both stages
    image_c = upload(rec.image_canonical, dev)
    min_area = cfg.amg.min_mask_region_area
    handoff = hand_off(stage.launch(rec._replace(image_canonical=image_c)), pack=min_area > 0)
    props, _ = receive(handoff)  # the count from the meta buffer
    if min_area > 0 and props.num > 0:
        props = cleanup_host(cfg, props, (h, w), dev, handoff)
    # the bucket as the runner takes it: from the meta buffer, or one read of
    # the bundle of the runner's testing knob, at the runner's place
    props, bucket = (props, meta_bucket(handoff)) if survival_hook is None else read_bucket(survival_hook(props))
    out = dict(num=int(props.num), score=torch.zeros((S, P)), score_neg=torch.zeros((S, P)), gem_scores=torch.zeros((S, P)),
               boxes_xywh=torch.zeros((P, 4)), prop_valid=torch.zeros(P, dtype=torch.bool), iu=torch.zeros((P, 3)))
    rows, at = _rows(rec)
    if props.num > 0 and rows:
        props = Proposals(*(f[:bucket] for f in props[:7]), num=props.num, overflow=props.overflow)
        hw = upload(np.asarray((h, w), np.int64), dev)
        feats, gem_pf = feature_stage(cfg, clip_params, props.masks, image_c, hw, mesh.mp_shard if mp_axis else None)
        gt = upload(rec.gt_mask, dev)
        # the runner's sentence bucket (padded with row 0), so the tables are its bits; k is the selection's
        sent = sentence_inputs(sentence_arrays(rows, True), (0, 0), dev)
        ing = sentence_ingredients(cfg, clip_params, props, feats, gem_pf, sent, hw, gt)
        for name in ("score", "score_neg", "gem_scores"):
            out[name][at, :bucket] = getattr(ing, name)[: len(rows)].float().cpu()
        out["boxes_xywh"][:bucket] = ing.boxes_xywh.float().cpu()
        out["prop_valid"][:bucket] = ing.prop_valid.cpu()
        out["iu"][:bucket] = ing.iu.cpu()
    return _pack(out)


_FIELDS = ("score", "score_neg", "gem_scores", "boxes_xywh", "prop_valid", "iu")


def _pack(out: dict) -> torch.Tensor:
    """One image's ingredients as a flat f32 row (the count and the validity
    bits are exact in f32)."""
    return torch.cat([torch.tensor([float(out["num"])])] + [out[k].float().reshape(-1) for k in _FIELDS])


def _unpack(flat: torch.Tensor, S: int, P: int) -> Ingredients:
    """[B, 1 + 3SP + 8P] gathered rows -> :class:`Ingredients` (numpy)."""
    B = flat.shape[0]
    shapes = {"score": (S, P), "score_neg": (S, P), "gem_scores": (S, P), "boxes_xywh": (P, 4), "prop_valid": (P,), "iu": (P, 3)}
    flat = flat.cpu().numpy()
    fields, at = {"num": flat[:, 0].astype(np.int32)}, 1
    for k in _FIELDS:
        n = int(np.prod(shapes[k]))
        fields[k] = flat[:, at : at + n].reshape((B,) + shapes[k])
        at += n
    fields["prop_valid"] = fields["prop_valid"] > 0.5
    return Ingredients(**fields)


def _select_and_accumulate(ing: Ingredients, b: int, rec: FullEvalBatch, cfg: PipelineConfig, k1: int, k2: int):
    """Selection over one image's ingredients (row ``b``) at the given clamp,
    sentence by sentence as the sequential runner: (pure sums [4], final sums
    [4], pure_idx [S], final_idx [S], pure_iou [S], final_iou [S]). A
    zero-proposal image records a miss a sentence (I = 0, U = gt area, IoU =
    0, count + 1), as ``runner._score_image`` does."""
    S = rec.sentence_valid.shape[0]
    pure, final = np.zeros(4, np.float64), np.zeros(4, np.float64)
    pidx, fidx = -np.ones(S, np.int32), -np.ones(S, np.int32)
    pious, fious = np.zeros(S, np.float32), np.zeros(S, np.float32)
    n = int(ing.num[b])
    if n == 0:
        miss = np.float64([0.0, float(np.asarray(rec.gt_mask).sum()), 0.0, 1.0])
        k = int(np.asarray(rec.sentence_valid).sum())
        return pure + k * miss, final + k * miss, pidx, fidx, pious, fious
    # the bucket the sequential runner scored: the same operands give the same bits
    bucket = bucket_size(ing.prop_valid[b], n)
    at = [int(i) for i in np.nonzero(rec.sentence_valid)[0]]
    tables = {k: getattr(ing, k)[b] for k in _FIELDS}
    for k in ("score", "score_neg", "gem_scores"):
        tables[k] = tables[k][at]
    one = Ingredients(n, *(torch.from_numpy(np.ascontiguousarray(tables[k][..., :bucket, :] if k in ("boxes_xywh", "iu")
                                                                  else tables[k][..., :bucket])) for k in _FIELDS))
    # the selection reads a sentence's relation flag and has-other-nouns flag only
    ints = np.zeros((len(at), 4), np.int64)
    ints[:, 2], ints[:, 3] = np.asarray(rec.rela_flag)[at], np.asarray(rec.has_other)[at]
    sel = select_sentences(cfg, one, SentenceInputs(None, torch.from_numpy(ints), None, torch.tensor([k1, k2])))
    iu = ing.iu[b]
    for si, pi, fi in zip(at, sel.pure_index.tolist(), sel.final_index.tolist()):
        pidx[si], fidx[si] = pi, fi
        pious[si], fious[si] = iu[pi, 2], iu[fi, 2]
        pure += np.float64([iu[pi, 0], iu[pi, 1], iu[pi, 2], 1.0])
        final += np.float64([iu[fi, 0], iu[fi, 1], iu[fi, 2], 1.0])
    return pure, final, pidx, fidx, pious, fious


def build_full_eval_step(cfg: PipelineConfig, mesh: ProcessMesh, axis: str = "dp", mp_axis: str | None = None,
                         sticky: bool = False, survival_hook=None):
    """``step(sam_params, clip_params, local_batch)`` over this rank's shard
    of the batch (``mesh.shard_batch``).

    Non-sticky (default): returns ``(pure IoUAccum, final IoUAccum, pure_idx
    [B, S], final_idx [B, S], pure_iou [B, S], final_iou [B, S])`` with the
    accumulators summed over ``axis``, the per-sentence arrays gathered in
    batch order, and the per-image (non-sticky) k1/k2 clamp.

    ``sticky=True``: returns the whole batch's :class:`Ingredients`, gathered
    over ``axis`` in batch order (every rank of the axis gets them; the rank
    that keeps the run's state passes them to :func:`finalize_sticky`).

    ``survival_hook`` is ``HybridGLPipeline.survival_hook``: where set, it
    replaces each image's proposal bundle after the cleanup.

    The step keeps one :class:`StageGraph` for the parameters it is given (a
    new one if they change): on a CUDA device each rank captures its
    proposal stage once and replays it for every image, as the sequential
    runner does."""
    g = cfg.guidance
    stages = []  # this rank's StageGraph

    @torch.no_grad()
    def step(sam_params, clip_params, batch: FullEvalBatch):
        S, P = batch.sentence_valid.shape[1], cfg.amg.max_proposals
        if not stages or stages[0].sam_params is not sam_params:
            stages[:] = [StageGraph(cfg, sam_params, params_device(sam_params))]
        recs = [FullEvalBatch(*(x[b] for x in batch)) for b in range(len(batch.rh))]
        flat = torch.stack([_image_ingredients(stages[0], clip_params, rec, cfg, mesh, mp_axis, survival_hook)
                            for rec in recs])
        if sticky:
            return _unpack(mesh.all_gather(flat, axis), S, P)
        ings = _unpack(flat, S, P)
        sums = np.zeros(8, np.float64)
        per_image = []
        for b, rec in enumerate(recs):
            n = max(int(ings.num[b]), 1)
            pa, fa, *rest = _select_and_accumulate(ings, b, rec, cfg, min(g.k1, n), min(g.k2, n))
            sums += np.concatenate([pa, fa])
            per_image.append(np.concatenate([np.asarray(r, np.float64) for r in rest]))
        sums = mesh.all_reduce_sum(torch.from_numpy(sums), axis).numpy()
        rest = mesh.all_gather(torch.from_numpy(np.stack(per_image)), axis).numpy().reshape(-1, 4, S)
        return (IoUAccum(*sums[:4]), IoUAccum(*sums[4:]), rest[:, 0].astype(np.int32), rest[:, 1].astype(np.int32),
                rest[:, 2].astype(np.float32), rest[:, 3].astype(np.float32))

    return step


def finalize_sticky(cfg: PipelineConfig, ings: Ingredients, batch: FullEvalBatch, k1: int, k2: int):
    """Sequential replay of the selection with the reference's sticky k1/k2
    clamp (Hybridgl_main.py:178-181): k only ever shrinks, in dataset order,
    and a zero-proposal image records a miss a sentence without clamping
    (``pipeline/runner.py``'s behaviour). ``batch`` is the whole batch.

    Returns (pure IoUAccum, final IoUAccum, pure_idx [B, S], final_idx [B, S],
    pure_iou [B, S], final_iou [B, S], k1, k2): the selections and IoUs of a
    sequential ``HybridGLPipeline`` run over the same samples in the same order."""
    B, S = np.asarray(batch.sentence_valid).shape
    pure, final = np.zeros(4, np.float64), np.zeros(4, np.float64)
    pidx, fidx = -np.ones((B, S), np.int32), -np.ones((B, S), np.int32)
    pious, fious = np.zeros((B, S), np.float32), np.zeros((B, S), np.float32)
    for b in range(B):
        n = int(ings.num[b])
        if n > 0:
            k1, k2 = min(k1, n), min(k2, n)
        pa, fa, pidx[b], fidx[b], pious[b], fious[b] = _select_and_accumulate(
            ings, b, FullEvalBatch(*(np.asarray(x)[b] for x in batch)), cfg, k1, k2)
        pure += pa
        final += fa
    return (IoUAccum(*(float(v) for v in pure)), IoUAccum(*(float(v) for v in final)), pidx, fidx, pious, fious, k1, k2)


def run_chunks(cfg: PipelineConfig, sam_params, clip_params, parser, tokenizer, mesh: ProcessMesh, sample_iter,
               k1: int, k2: int, mp_axis: str | None = None, survival_hook=None):
    """The data-parallel evaluation loop (the body of the reference's
    ``cli/main.py:_run_data_parallel``). Every rank walks the same sample
    stream in chunks of ``dp`` images and runs its own image of each chunk;
    the tail chunk is padded with inert copies (no sentences), so every rank
    joins every collective. With ``compat.k_clamp_sticky`` (the parity
    default) the step returns the chunk's ingredients and rank 0 replays the
    sticky k1/k2 selection in dataset order, carrying the clamp from
    ``(k1, k2)`` across chunks: the results are the sequential runner's.

    Yields ``(samples of the chunk, result)`` a chunk; ``result`` is
    ``(pure IoUAccum, final IoUAccum, pure_idx [B, S], final_idx, pure_iou,
    final_iou, k1, k2)`` on rank 0 and None on the others."""
    import itertools

    D = mesh.dp
    sticky = cfg.compat.k_clamp_sticky
    step = build_full_eval_step(cfg, mesh, mp_axis=mp_axis, sticky=sticky, survival_hook=survival_hook)
    it = iter(sample_iter)
    while True:
        chunk = list(itertools.islice(it, D))
        if not chunk:
            return
        real = len(chunk)
        while len(chunk) < D:  # pad the tail chunk with inert copies
            chunk.append(chunk[-1]._replace(sentences=[]))
        batch = prepare_records(chunk, parser, cfg, tokenizer=tokenizer, max_sentences=sentence_bucket(chunk))
        out = step(sam_params, clip_params, shard_batch(batch, mesh))
        result = None
        if mesh.rank == 0:
            result = finalize_sticky(cfg, out, batch, k1, k2) if sticky else (*out, k1, k2)
            k1, k2 = result[6], result[7]
        yield chunk[:real], result


def sentence_bucket(chunk) -> int:
    """The sentence bucket of a chunk of samples: a power of two >= the
    chunk's true maximum, at least 4, so nothing is truncated."""
    return next_pow2(max((len(c.sentences) for c in chunk), default=1) or 1, base=4)
