"""The comparison that decides ``correct``: what the timed path produced,
held against the plain float32 reference (``benchref``), which works it out
again from the sample's own image, ground truth and sentences and from the
seeded weights, and reads the program's outputs only to judge them.

* the proposal stage, on the rows it put out before the host cleanup (every
  image of the window's first cycle, the first ``ROWS`` rows of each): each
  row is matched to its own crop and mask channel, the reference's candidate
  at the row's grid point whose mask overlaps the row's mask most, and held
  against it: ``iou_pred_err`` (the predicted IoU), ``mask_err`` (1 - the
  masks' IoU), ``stab_err`` (the stability score), each the mean over the
  rows. Where overlaps tie, as they do at 0 for a mask of a pixel or two
  whose own channel in the reference is empty or elsewhere, the candidate
  nearest the row's mask in area is its match; ``tie_rows`` counts the rows
  where that is not the first of the tied candidates;
* the feature stage, on the proposal masks the stage was handed: ``feat_err``,
  the mean relative error of the live proposals' G2L features (a single
  feature of a tiny mask is ill-conditioned: its worst swings), and
  ``gem_err``, the worst distance of a GEM patch feature (unit rows), over the
  checked images;
* the sentence stage, the reference's text tower and guidance run on the
  program's own features: ``pure_gap``, the widest gap by which the
  reference's scores put the program's pure pick below their best, or the
  program's top k1 below their k1-th best (logits); ``final_gap``, the widest
  gap by which the reference's blend (box relations, the GEM heatmap with its
  direction prior) over the program's top k1 puts the program's final pick
  below its best; ``score_err``, the mean gap of the scores, is read beside
  them. Exact, 1 on any mismatch: ``pure_pick`` (the pure pick is the argmax
  of the program's own scores), ``final_topk`` (the final pick is among their
  top k1, with k1/k2 the sticky clamp of the images before), ``iou_exact``
  (each pick's IoU and the accumulators, recomputed in float32 in the same
  order).

A cell's limits file (``limits/<cell>.json``) names the numbers it compares.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from benchref.amg import ReferenceAMG, mask_boxes
from benchref.parser import HeuristicParser
from benchref.score import fusion_features, gem_patch_features, sentence
from benchref.tokenizer import tokenize

MISSING = 10.0
ROWS = 8  # the proposal stage's rows judged an image, in its order
# every number the comparison reads; the limits file of a cell holds those it compares
# numbers taken as the mean over all their readings in the checked images, those summed over the images;
# the others: the worst
MEAN_NUMBERS = ("iou_pred_err", "mask_err", "stab_err", "feat_err", "score_err")
SUM_NUMBERS = ("tie_rows",)
NUMBERS = ("iou_pred_err", "mask_err", "stab_err", "feat_err", "gem_err", "score_err", "pure_gap", "final_gap",
           "pure_pick", "final_topk", "iou_exact", "tie_rows")


@dataclass
class Rows:
    """The proposal stage's output rows of one image, before the host cleanup."""

    points: np.ndarray  # [n, 2] in image coordinates
    iou: np.ndarray  # [n] predicted IoUs
    stability: np.ndarray  # [n]
    masks: torch.Tensor  # [n, h, w] bool


@dataclass
class SentenceOut:
    score: torch.Tensor  # [L] over the live proposals
    pure: int  # index into the live proposals, -1 outside them
    final: int
    iou: tuple  # (pure, final) IoUs as produced, float32


@dataclass
class ImageOut:
    """What the timed path (or the control in its place) produced for one image."""

    rows: Optional[Rows]
    live_masks: torch.Tensor  # [L, h, w] bool: the proposals the feature stage was handed, live rows
    live_boxes: np.ndarray  # [L, 4] XYXY
    feats: torch.Tensor  # [L, E]
    gem: torch.Tensor  # [G*G, E]
    sentences: List[SentenceOut] = field(default_factory=list)
    acc: Optional[tuple] = None  # (accumulators in, accumulators out) [2, 4] float32
    k: tuple = (3, 6)


def parse_rows(sentences, cfg: dict, context_length: int):
    """(parsed, tokens [2 + K, L] int64, n_others) of each sentence, as the reference derives them."""
    parser = HeuristicParser(rela_right_bug=cfg["compat"]["rela_right_bug"])
    K = cfg["guidance"]["max_other_nouns"]
    out = []
    for s in sentences:
        p = parser.parse(s)
        others = p.other_noun_phrases[:K]
        toks = np.zeros((2 + K, context_length), np.int64)
        toks[0] = tokenize(p.sentence, context_length, truncate=True)[0]
        toks[1] = tokenize(p.noun_phrase, context_length, truncate=True)[0]
        for i, noun in enumerate(others):
            toks[2 + i] = tokenize("a photo of " + noun, context_length, truncate=True)[0]
        out.append((p, toks, len(others)))
    return out


def xywh(boxes: np.ndarray) -> np.ndarray:
    b = np.asarray(boxes, np.float32)
    return np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)


def top_k1(score: torch.Tensor, k1: int) -> list:
    """The k1 highest of ``score`` (ties to the lower index)."""
    return torch.sort(score, descending=True, stable=True).indices[:k1].tolist()


class Reference:
    """The float32 reference of one configuration: the proposal model, CLIP and the settings."""

    def __init__(self, sam, clip, cfg: dict, settings):
        self.sam, self.clip, self.cfg, self.settings = sam, clip, cfg, settings
        from benchlib.config import amg_settings

        self.amg = ReferenceAMG(sam, settings.sam, amg_settings(cfg), settings.family)
        self.device = next(clip.parameters()).device

    def image(self, sample):
        h, w = sample.h, sample.w
        return torch.from_numpy(np.ascontiguousarray(sample.image_canonical[:h, :w])).to(self.device)

    @torch.no_grad()
    def features(self, sample, live_masks):
        img = self.image(sample)
        feats = fusion_features(self.clip, img, live_masks, self.cfg)
        return feats, gem_patch_features(self.clip, img, self.cfg["gem"])

    @torch.no_grad()
    def sentences(self, sample, live_masks, live_boxes, feats, gem, k, handed=None):
        """The reference's sentence stage on the given features; ``handed``, if
        given, the top-k1 set a sentence's guidance blends, one list a sentence."""
        rows = parse_rows(sample.sentences, self.cfg, self.settings.clip.context_length)
        out = []
        for i, (parsed, toks, n_others) in enumerate(rows):
            out.append(sentence(self.clip, torch.from_numpy(toks).to(self.device), n_others, parsed, feats,
                                xywh(live_boxes), gem, live_masks, k[0], k[1], self.cfg,
                                topk=None if handed is None else handed[i]))
        return out

    @torch.no_grad()
    def proposals(self, sample):
        """The reference's AMG on the sample (call it inside ``benchref.quant.fp8`` for
        the control's): (its rows before the cleanup as ``Rows``, the cleaned survivors' masks)."""
        res = self.amg.run(self.image(sample).cpu().numpy(), frame_of(sample))
        kept = res.kept[:ROWS]
        pts = [res.crops[c].points[j // 3] + np.array(res.crops[c].box[:2]) for c, j in kept]
        rows = Rows(np.array(pts, np.float64).reshape(-1, 2),
                    np.array([float(res.crops[c].iou[j]) for c, j in kept], np.float32),
                    np.array([float(res.crops[c].stability[j]) for c, j in kept], np.float32),
                    torch.from_numpy(np.stack(res.kept_masks[:ROWS]) if kept else
                                     np.zeros((0, sample.h, sample.w), bool)).to(self.device))
        return rows, res.masks

    @torch.no_grad()
    def control_output(self, sample, rows, live_masks, live_boxes, k, acc_in) -> ImageOut:
        """The reference in the program's place (call it inside ``benchref.quant.fp8``): its features,
        scores, picks and IoUs on the proposals the feature stage would be handed."""
        feats, gem = self.features(sample, live_masks)
        refs = self.sentences(sample, live_masks, live_boxes, feats, gem, k)
        gt = torch.from_numpy(sample.gt_mask[: sample.h, : sample.w]).to(self.device)
        sents, acc = [], acc_in.clone()
        for r in refs:
            vals = [pick_iu(live_masks[j], gt) for j in (r.pure, r.final)]
            acc = acc + torch.stack([torch.cat([v, torch.ones_like(v[:1])]) for v in vals])
            sents.append(SentenceOut(r.score, r.pure, r.final, tuple(v[2] for v in vals)))
        return ImageOut(rows, live_masks, live_boxes, feats, gem, sents, (acc_in, acc), k)


def frame_of(sample) -> tuple:
    """The sample's frame of the proposal model, as the program is handed it: (frame, rh, rw)."""
    return sample.image_1024, sample.rh, sample.rw


def pick_iu(mask: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(I, U, IoU) of one mask against the ground truth in float32, as the accumulators take them."""
    i = (mask & gt).sum().float()
    u = (mask | gt).sum().float()
    return torch.stack([i, u, torch.where(u == 0, 0.0, i / torch.clamp(u, min=1.0))])


@torch.no_grad()
def proposal_gaps(ref: Reference, sample, rows: Rows) -> dict:
    """Each row against the reference's candidate of its own crop and mask
    channel: of the candidates at the row's grid point (every crop whose grid
    holds it), the one whose mask overlaps the row's mask most; of candidates
    that overlap it alike, the one nearest it in area, then the first."""
    image = ref.image(sample).cpu().numpy()
    out = {"iou_pred_err": [], "mask_err": [], "stab_err": [], "tie_rows": 0.0}
    ref.amg.forget()
    for pt, iou, stab, mask in zip(rows.points, rows.iou, rows.stability, rows.masks):
        cands = []  # (overlap, -area gap, iou, stability) of every candidate, in order
        area = float(mask.sum())
        for _, ious, stabs, masks in ref.amg.point_candidates(image, frame_of(sample), pt):
            inter = (masks & mask).flatten(1).sum(1).float()
            union = (masks | mask).flatten(1).sum(1).float()
            overlap = torch.where(union > 0, inter / union.clamp_min(1), 1.0)
            gap = (masks.flatten(1).sum(1).float() - area).abs()
            cands += [(float(o), -float(g), float(i), float(s)) for o, g, i, s in zip(overlap, gap, ious, stabs)]
        if not cands:  # no crop's grid holds the row's point
            cands = [(1.0 - MISSING, 0.0, float(iou) + MISSING, float(stab) + MISSING)]
        best = max(cands, key=lambda c: c[:2])  # the first of the highest
        out["tie_rows"] += float(max(cands, key=lambda c: c[0]) is not best)  # the area decided
        out["mask_err"].append(1.0 - best[0])
        out["iou_pred_err"].append(abs(best[2] - float(iou)))
        out["stab_err"].append(abs(best[3] - float(stab)))
    ref.amg.forget()
    return out


@torch.no_grad()
def judge(ref: Reference, sample, out: ImageOut, expected_k: tuple) -> dict:
    """The numbers of one image (``NUMBERS``), worst case over its rows and sentences."""
    h, w = sample.h, sample.w
    nums = dict.fromkeys(NUMBERS, 0.0)

    # ---- the proposal stage
    if out.rows is not None:
        nums.update(proposal_gaps(ref, sample, out.rows))

    # ---- the feature stage
    feats_ref, gem_ref = ref.features(sample, out.live_masks)
    nums["feat_err"] = ((out.feats.float() - feats_ref).norm(dim=-1) / feats_ref.norm(dim=-1)).tolist()
    nums["gem_err"] = float((out.gem.float() - gem_ref).norm(dim=-1).max())

    # ---- the sentence stage, on the features the program's feature stage handed it
    L = out.live_masks.shape[0]
    k1 = expected_k[0]
    handed = [top_k1(o.score.float(), k1) for o in out.sentences]
    refs = ref.sentences(sample, out.live_masks, out.live_boxes, out.feats.float(), out.gem.float(), expected_k,
                         handed=handed)
    gt = torch.from_numpy(sample.gt_mask[:h, :w]).to(ref.device)
    k_ok = tuple(out.k) == tuple(expected_k)
    acc = None if out.acc is None else out.acc[0].float().clone()
    score_gaps = []
    for o, r, top in zip(out.sentences, refs, handed):
        score_gaps += (o.score.float() - r.score).abs().tolist()
        own = o.score.float()
        # the picks against the reference's scores and blend (gaps in the reference's own values)
        best = torch.sort(r.score, descending=True).values
        gap = float(best[0] - r.score[o.pure]) if 0 <= o.pure < L else MISSING
        gap = max(gap, float(best[k1 - 1] - r.score[top].min()))
        nums["pure_gap"] = max(nums["pure_gap"], gap)
        gap = float(r.blend.max() - r.blend[top.index(o.final)]) if o.final in top else MISSING
        nums["final_gap"] = max(nums["final_gap"], gap)
        # the picks against the selection rule on the program's own scores (exact)
        if not (0 <= o.pure < L) or o.pure != int(torch.argmax(own)):
            nums["pure_pick"] = 1.0
        if not (0 <= o.final < L) or o.final not in top or not k_ok:
            nums["final_topk"] = 1.0
        vals = []
        for j, got in zip((o.pure, o.final), o.iou):
            v = pick_iu(out.live_masks[j], gt) if 0 <= j < L else torch.full((3,), float("nan"), device=ref.device)
            if not float(got) == float(v[2]):
                nums["iou_exact"] = 1.0
            vals.append(torch.cat([v, torch.ones_like(v[:1])]))
        if acc is not None:
            acc = acc + torch.stack(vals)
    if out.acc is not None and not torch.equal(acc, out.acc[1].float()):
        nums["iou_exact"] = 1.0
    nums["score_err"] = score_gaps
    return nums


def reduce(per_image: dict) -> dict:
    """The run's numbers from its checked images' readings: the mean of all
    readings for ``MEAN_NUMBERS``, the sum for ``SUM_NUMBERS``, the worst for
    the others."""
    out = {}
    for k in NUMBERS:
        if k in SUM_NUMBERS:
            out[k] = float(sum(n.get(k, 0.0) for n in per_image.values()))
        elif k in MEAN_NUMBERS:
            vals = [v for n in per_image.values() for v in n.get(k, [])]
            out[k] = float(np.mean(vals)) if vals else 0.0
        else:
            out[k] = max((n[k] for n in per_image.values() if k in n), default=0.0)
    return out


def boxes_of(masks: torch.Tensor) -> np.ndarray:
    return mask_boxes(masks).cpu().numpy()
