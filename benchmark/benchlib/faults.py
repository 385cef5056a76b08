"""Faults planted beneath the harness, in the timed path, each of which the
comparison has to find: ``FAULTS[name](pipe)`` breaks a pipeline object
before its warm-up. The CPU tests run each; ``readings.py fault`` reads a
cell's numbers under one on the card."""

import numpy as np
import torch


def answer_altered(pipe):
    sentences = pipe.scorer.sentences

    def wrong(props, feats, gem_pf, arrays, k, gt, acc):
        out = sentences(props, feats, gem_pf, arrays, k, gt, acc)
        valid = torch.as_tensor(props.valid).to(out.score.device)
        worst = torch.where(valid, out.score, float("inf")).argmin(-1)
        return out._replace(picks=torch.stack([worst, worst], -1))

    pipe.scorer.sentences = wrong


def half_the_batch(pipe):
    features = pipe.scorer.features

    def half(props, image_c, hw):
        feats, gem = features(props, image_c, hw)
        B = feats.shape[0]
        feats[B // 2:] = feats[: B - B // 2]
        return feats, gem

    pipe.scorer.features = half


def state_unchanged(pipe):
    sentences = pipe.scorer.sentences

    def same(props, feats, gem_pf, arrays, k, gt, acc):
        return sentences(props, feats, gem_pf, arrays, k, gt, acc)._replace(acc=acc.clone())

    pipe.scorer.sentences = same


def directions_swapped(pipe):
    """The guidance's direction prior mirrored: left taken for right and right for left."""
    from hybridgl_tpu_torch.pipeline.guidance import dir_flag_id

    sentences = pipe.scorer.sentences
    left, right = dir_flag_id("left"), dir_flag_id("right")

    def mirrored(props, feats, gem_pf, arrays, k, gt, acc):
        tokens, ints, floats = arrays
        ints = ints.copy()
        d = ints[:, 1].copy()
        ints[:, 1] = np.where(d == left, right, np.where(d == right, left, d))
        return sentences(props, feats, gem_pf, (tokens, ints, floats), k, gt, acc)

    pipe.scorer.sentences = mirrored


def noun_phrase_dropped(pipe):
    """The text tower's noun-phrase row replaced by the sentence's."""
    sentences = pipe.scorer.sentences

    def dropped(props, feats, gem_pf, arrays, k, gt, acc):
        tokens, ints, floats = arrays
        tokens = tokens.copy()
        tokens[:, 1] = tokens[:, 0]
        return sentences(props, feats, gem_pf, (tokens, ints, floats), k, gt, acc)

    pipe.scorer.sentences = dropped


def proposal_rows_shifted(pipe):
    """Each proposal row's predicted IoU and stability taken from the next row."""
    launch = pipe.stage.launch

    def shifted(sample):
        out = launch(sample)
        return out._replace(iou_preds=out.iou_preds.roll(1), stability=out.stability.roll(1))

    pipe.stage.launch = shifted


FAULTS = {"answer-altered": answer_altered, "half-the-batch": half_the_batch, "state-unchanged": state_unchanged,
          "directions-swapped": directions_swapped, "noun-phrase-dropped": noun_phrase_dropped,
          "proposal-rows-shifted": proposal_rows_shifted}
