"""The port's data-parallel evaluation (hybridgl_tpu_torch/parallel/full_eval.py)
at world 2 over gloo on the CPU against the port's sequential ``run_image``
over the same samples in order (as tests/test_full_eval.py holds the reference's
step to its sequential runner): the same selections per sentence, IoUs within
1e-5, the same sticky clamp, accumulators to rtol 1e-5. Tiny f32 models from a
numpy-seeded torch generator; every rank loads the weights from an ``.npz``.
Each spawned run has its own time limit (180 s), so a hang is one failed test.
"""

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core import checkpoint
from hybridgl_tpu_torch.core.config import AmgConfig, CompatConfig, GemConfig, GuidanceConfig, PipelineConfig, clip_preset, sam_preset
from hybridgl_tpu_torch.core.params import init_clip, init_sam
from hybridgl_tpu_torch.lang import HeuristicParser
from hybridgl_tpu_torch.parallel import launch, workers
from hybridgl_tpu_torch.pipeline import runner
from hybridgl_tpu_torch.tools.dryrun import TinyVocabTokenizer

from test_torch_pipeline import make_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 180.0  # seconds a spawned run may take (a few seconds alone; the suite runs six workers at once)


def tiny_cfg(**amg):
    clip_cfg = clip_preset("test-tiny")
    fields = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                  min_mask_region_area=0, max_proposals=8)
    fields.update(amg)
    return PipelineConfig(clip_config=clip_cfg, sam_config=sam_preset("test-tiny"), fusion_mode="G2L", canonical_size=32,
                          crop_size=clip_cfg.image_size, amg=AmgConfig(**fields), gem=GemConfig(img_size=32, depth=2),
                          guidance=GuidanceConfig(masking_block=clip_cfg.vision_layers - 2))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(sam tree, clip tree, {"sam": path, "clip": path}) at test-tiny, f32."""
    cfg = tiny_cfg()
    g = torch.Generator().manual_seed(int(np.random.default_rng(5).integers(1 << 30)))
    sam_p, clip_p = init_sam(g, cfg.sam), init_clip(g, cfg.clip)
    for blk in sam_p["encoder"]["blocks"]:  # nonzero rel-pos so the bias matters
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.2
    root = tmp_path_factory.mktemp("weights")
    paths = {"sam": str(root / "sam.npz"), "clip": str(root / "clip.npz")}
    checkpoint.save(paths["sam"], sam_p)
    checkpoint.save(paths["clip"], clip_p)
    return sam_p, clip_p, paths


@contextlib.contextmanager
def one_thread():
    """The ranks run one intra-op thread each; so does the sequential run they are held to."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def sequential(cfg, weights, samples, survival=None):
    pipe = runner.HybridGLPipeline(cfg, weights[0], weights[1], parser=HeuristicParser(), tokenizer=TinyVocabTokenizer(),
                                   device="cpu")
    if survival:
        pipe.survival_hook = workers.survival_stamp(cfg, survival, (samples[0].h, samples[0].w), "cpu")
    state = pipe.init_state()
    with one_thread():
        results = [pipe.run_image(s, state) for s in samples]
        pipe.survival_hook = None
        nums = [int(pipe.propose(s).num) for s in samples]
    return results, state, nums


def parallel(cfg, weights, samples, world=2, mp=1, survival=None):
    spec = dict(cfg=cfg, samples=samples, tokenizer="tiny", mp=mp, **weights[2])
    if survival:
        spec.update(survival=survival, survival_hw=(samples[0].h, samples[0].w))
    out = launch.spawn_workers(workers.eval_worker, world, (spec,), "cpu", timeout=LIMIT)
    assert [o["rank"] for o in out] == list(range(world))
    return out[0]


def check(seq, par, n_images):
    results, state, _ = seq
    assert par["images"] == n_images
    want = [(b, si, r.pure_index, r.final_index) for b, rs in enumerate(results) for si, r in enumerate(rs)]
    assert [rec[:4] for rec in par["records"]] == want
    ious = [(r.pure_iou, r.final_iou) for rs in results for r in rs]
    for rec, (pi, fi) in zip(par["records"], ious):
        assert abs(rec[4] - pi) < 1e-5 and abs(rec[5] - fi) < 1e-5
    assert int(par["pure"][3]) == int(state.pure.count) == len(want)
    np.testing.assert_allclose(par["pure"], [float(v) for v in state.pure], rtol=1e-5)
    np.testing.assert_allclose(par["final"], [float(v) for v in state.final], rtol=1e-5)


def test_sticky_with_cleanup_is_exact(weights):
    """The --data_parallel default: sticky clamp replayed on rank 0, the
    in-step host cleanup on (min_mask_region_area = 6): the sequential
    runner's selections, IoUs (equal, not close) and clamp trajectory."""
    cfg = tiny_cfg(min_mask_region_area=6)
    samples = [make_sample(runner, seed) for seed in (21, 22, 23, 24)]
    seq, par = sequential(cfg, weights, samples), parallel(cfg, weights, samples)
    check(seq, par, 4)
    assert (par["k1"], par["k2"]) == (seq[1].k1, seq[1].k2)
    assert [rec[4:] for rec in par["records"]] == [
        (float(np.float32(r.pure_iou)), float(np.float32(r.final_iou))) for rs in seq[0] for r in rs]


def test_stamped_survivors_move_the_clamp(weights):
    """Stamped bundles of 7, 5, 8 and 2 live proposals (the same on both
    sides, seeded by the image): the selections range over the slots and the
    sticky clamp shrinks twice, (3, 6) -> (3, 5) -> (2, 2)."""
    cfg = tiny_cfg(min_mask_region_area=6)
    samples = [make_sample(runner, seed) for seed in (61, 62, 63, 64)]
    pattern = [7, 5, 8, 2]
    seq, par = sequential(cfg, weights, samples, pattern), parallel(cfg, weights, samples, survival=pattern)
    check(seq, par, 4)
    assert (par["k1"], par["k2"]) == (seq[1].k1, seq[1].k2) == (2, 2)
    picked = {rec[2] for rec in par["records"]} | {rec[3] for rec in par["records"]}
    assert len(picked) >= 3, f"the selections do not range over the proposals: {picked}"
    finals = [rec[3] for rec in par["records"]]
    assert max(finals[: len(finals) // 2]) >= 2, "no early selection beyond what the last clamp would allow"


def test_non_sticky_matches_sequential(weights):
    cfg = tiny_cfg().replace(compat=CompatConfig(k_clamp_sticky=False))
    samples = [make_sample(runner, seed) for seed in (11, 12, 13, 14)]
    check(sequential(cfg, weights, samples), parallel(cfg, weights, samples), 4)


@pytest.mark.parametrize("sticky", [False, True])
def test_zero_proposal_image_counts_as_misses(weights, sticky):
    """An image with no proposal records a miss a sentence (I = 0, U = gt
    area, IoU = 0, count + 1) and does not clamp k1/k2."""
    cfg = tiny_cfg(pred_iou_thresh=0.999, stability_score_thresh=0.999).replace(compat=CompatConfig(k_clamp_sticky=sticky))
    samples = [make_sample(runner, seed) for seed in (21, 22)]
    seq, par = sequential(cfg, weights, samples), parallel(cfg, weights, samples)
    assert any(n == 0 for n in seq[2]), "precondition lost: no zero-proposal image"
    check(seq, par, 2)
    assert (par["k1"], par["k2"]) == (seq[1].k1, seq[1].k2) or not sticky


def test_multicrop_dispatch(weights):
    """crop_n_layers >= 1 routes the step through the multicrop AMG, as the sequential runner."""
    cfg = tiny_cfg(crop_n_layers=1, max_candidates_per_crop=8)
    samples = [make_sample(runner, seed) for seed in (31, 32)]
    seq, par = sequential(cfg, weights, samples), parallel(cfg, weights, samples)
    check(seq, par, 2)
    single = sequential(tiny_cfg(), weights, samples)
    assert [int(v) for v in single[1].pure] != [int(v) for v in seq[1].pure]  # the multicrop AMG gives other proposals


def test_ragged_sentences_and_tail_chunk(weights):
    """Three images at world 2 (the tail chunk is padded with an inert copy)
    with 3, 1 and 5 sentences (the bucket grows to 8)."""
    cfg = tiny_cfg(min_mask_region_area=6)
    long = ["the cup on the left", "the dog to the right of the bench", "the biggest box", "small bird above the water",
            "person in the middle next to a car"]
    samples = [make_sample(runner, 41), make_sample(runner, 42)._replace(sentences=["the red cup on the left"]),
               make_sample(runner, 43)._replace(sentences=long)]
    seq, par = sequential(cfg, weights, samples), parallel(cfg, weights, samples)
    check(seq, par, 3)
    assert len(par["records"]) == 9 and (par["k1"], par["k2"]) == (seq[1].k1, seq[1].k2)


def test_dp_by_mp_matches_sequential(weights):
    """A 2 x 2 mesh (world 4): the fusion stage's proposal axis shards over
    mp; the same selections, accumulators to rtol 1e-5."""
    cfg = tiny_cfg(min_mask_region_area=6)
    samples = [make_sample(runner, seed) for seed in (51, 52)]
    check(sequential(cfg, weights, samples), parallel(cfg, weights, samples, world=4, mp=2), 2)


def test_cli_data_parallel_matches_sequential_cli(tmp_path, monkeypatch):
    """``--data_parallel --device cpu`` with HYBRIDGL_WORLD_SIZE=2 on a
    synthetic REFER tree (3 images, 7 sentences: the tail chunk is padded;
    sticky clamp and cleanup on) writes the sequential CLI's result log and
    parity records."""
    sys.path.insert(0, REPO)
    from chip_smoke import _write_refer_tree
    from hybridgl_tpu_torch.cli.main import main as cli_main

    root = str(tmp_path / "refer")
    os.makedirs(root)
    n_sentences = _write_refer_tree(root)
    monkeypatch.chdir(tmp_path)
    out = {}
    for tag, extra in (("seq", []), ("dp", ["--data_parallel"])):
        monkeypatch.setenv("HYBRIDGL_WORLD_SIZE", "2")
        monkeypatch.setattr("hybridgl_tpu_torch.cli.main.DATA_PARALLEL_LIMIT", 2 * LIMIT)
        logs, parity = str(tmp_path / tag / "logs"), str(tmp_path / tag / "parity.json")
        with one_thread():
            cli_main(["--dataset", "refcoco", "--split", "val", "--refer_data_root", root, "--clip_model", "test-tiny",
                      "--sam_model", "test-tiny", "--random-weights", "--device", "cpu", "--log_dir", logs,
                      "--parity_log", parity, *extra])
        with open(parity) as f:
            records = json.load(f)["records"]
        with open(os.path.join(logs, "result_log_refcoco_val.txt")) as f:
            out[tag] = (records, f.read())
    (seq_records, seq_log), (dp_records, dp_log) = out["seq"], out["dp"]
    assert len(seq_records) == n_sentences == 7
    assert [(r["ref_id"], r["sentence"], r["pure_index"], r["final_index"]) for r in dp_records] == \
        [(r["ref_id"], r["sentence"], r["pure_index"], r["final_index"]) for r in seq_records]
    for a, b in zip(dp_records, seq_records):
        assert abs(a["pure_iou"] - b["pure_iou"]) < 1e-5 and abs(a["final_iou"] - b["final_iou"]) < 1e-5
    assert dp_log == seq_log and "pure hybridgl:" in dp_log


def test_failed_rank_fails_the_run():
    """A rank that raises ends the run with its traceback; a rank that hangs
    ends it at the time limit; nothing carries on."""
    with pytest.raises(RuntimeError, match="rank 1 of fail_on_rank_one failed"):
        launch.spawn_workers(workers.fail_on_rank_one, 2, (), "cpu", timeout=LIMIT)
    with pytest.raises(TimeoutError):
        launch.spawn_workers(workers.sleep_forever, 2, (), "cpu", timeout=8.0)
