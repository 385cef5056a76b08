"""A whole run of the harness on the CPU at a tiny size (the card's look
skipped): the result line, the reference against the port in float32, and
the comparison failing on a broken timed path."""

import json
import time

import pytest
import torch

import tiny
from benchlib.config import load_json
from benchlib.faults import FAULTS
from benchlib.harness import run

LIMITS = load_json("benchmark/limits/refcoco-occupancy.json")


def one_run(seed, cfg=None, lims=None, on_pipeline=None, seconds=4.0, mix=None):
    return run("tiny", seed, seconds, False, time.perf_counter(), device="cpu", bench=tiny.bench(),
               cfg=cfg or tiny.config(), mix=mix or tiny.mix(), lims=lims or LIMITS, on_pipeline=on_pipeline)


def test_result_line_keys():
    r = one_run(2**31 + 3)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown", "counts", "checks"}
    assert list(r["checks"]) == list(LIMITS)
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["counts"]["captures_in_window"] == 0 and r["attempted"] > 0
    assert r["correct"] == (r["failed"] == 0)
    json.dumps(r)


@pytest.mark.parametrize("multicrop", [False, True], ids=["single-crop", "crop-layer"])
def test_reference_agrees_with_the_port_in_float32(multicrop):
    cfg = dict(tiny.config(multicrop), compute_dtype="float32")
    r = one_run(11, cfg=cfg, mix=tiny.mix(stamped=not multicrop), seconds=1.0, lims=tiny.LIMITS)
    got = {k: v["value"] for k, v in r["checks"].items()}
    assert got["iou_pred_err"] < 1e-5 and got["stab_err"] < 1e-5 and got["mask_err"] < 1e-3, got
    assert got["feat_err"] < 5e-3 and got["gem_err"] < 1e-5, got
    assert got["score_err"] < 1e-4 and got["pure_gap"] < 1e-4 and got["final_gap"] < 1e-4, got
    assert got["pure_pick"] == got["final_topk"] == got["iou_exact"] == 0.0, got


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    cfg = dict(tiny.config(), compute_dtype="float32")  # the unbroken port reads ~0 on every number
    assert one_run(2**31 + 3, cfg=cfg)["correct"], "the unbroken run must pass first"
    r = one_run(2**31 + 3, cfg=cfg, on_pipeline=FAULTS[fault])
    assert not r["correct"] and r["failed"] > 0, r["checks"]


# PhraseCut's limits compare no gap between proposals: its cell leaves about one live proposal an image, so faults that
# only change which of several proposals is picked (half the batch, directions swapped, the noun phrase dropped) cannot
# show there; an answer altered (the rows' IoUs, a pick) and a state left unchanged meet the rows and the exact numbers
CROP_LAYER_FAULTS = ("answer-altered", "proposal-rows-shifted", "state-unchanged")


@pytest.mark.parametrize("fault", CROP_LAYER_FAULTS)
def test_a_broken_crop_layer_path_is_not_correct(fault):
    cfg = dict(tiny.config(multicrop=True), compute_dtype="float32")
    lims, mix = load_json("benchmark/limits/phrasecut-grid64.json"), tiny.mix(stamped=False)
    assert one_run(2**31 + 3, cfg=cfg, lims=lims, mix=mix)["correct"], "the unbroken run must pass first"
    r = one_run(2**31 + 3, cfg=cfg, lims=lims, mix=mix, on_pipeline=FAULTS[fault])
    assert not r["correct"] and r["failed"] > 0, r["checks"]


@pytest.mark.parametrize("row_pixel, want_ch, ties", [((3, 3), 2, 1.0), ((0, 1), 0, 0.0), ((2, 2), 1, 0.0)],
                         ids=["overlapping-none", "overlapping-channel-0", "overlapping-channel-1"])
def test_a_row_is_matched_by_overlap_then_by_area(row_pixel, want_ch, ties):
    """A one-pixel row that overlaps no candidate is matched to the candidate
    nearest it in area (its own empty channel), not to the first; one that
    overlaps a candidate is matched to it."""
    import numpy as np
    from types import SimpleNamespace

    from benchlib import check

    masks = torch.zeros(3, 4, 4, dtype=torch.bool)
    masks[0, 0], masks[1, 2] = True, True  # four pixels each; channel 2 empty
    ious, stabs = torch.tensor([0.31, -0.72, -0.13]), torch.tensor([0.9, 0.8, 0.1])

    class AMG:
        def forget(self):
            pass

        def point_candidates(self, image, frame, pt):
            yield None, ious, stabs, masks

    ref = SimpleNamespace(image=lambda s: torch.zeros(4, 4, 3, dtype=torch.uint8), amg=AMG())
    sample = SimpleNamespace(image_1024=None, rh=4, rw=4)
    row = torch.zeros(1, 4, 4, dtype=torch.bool)
    row[0, row_pixel[0], row_pixel[1]] = True
    out = check.proposal_gaps(ref, sample, check.Rows(np.array([[1.5, 1.5]]), np.array([float(ious[want_ch])]),
                                                      np.array([float(stabs[want_ch])]), row))
    assert out["iou_pred_err"] == [0.0] and out["stab_err"] == [0.0] and out["tie_rows"] == ties, out
