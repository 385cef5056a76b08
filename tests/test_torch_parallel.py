"""The port's process mesh and the host halves of its data-parallel step
(hybridgl_tpu_torch/parallel/{mesh,full_eval}.py).

``build_sharded_eval_step`` at world 2 against world 1 and ``dp x mp`` = 2 x 2
against ``dp`` = 2 over gloo on the CPU (accumulators rtol 1e-5, equal
selections: the bars of tests/test_parallel.py); ``prepare_records``,
``finalize_sticky`` and ``ingredients_nbytes_per_image`` against the JAX
package's on the same inputs (equal). Inputs from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax

from hybridgl_tpu.core.config import AmgConfig, GemConfig, PipelineConfig
from hybridgl_tpu.lang import HeuristicParser as JaxHeuristicParser
from hybridgl_tpu.parallel import full_eval as jfull
from hybridgl_tpu.pipeline import runner as jrunner
from hybridgl_tpu_torch.core import checkpoint
from hybridgl_tpu_torch.core.params import init_clip, init_sam
from hybridgl_tpu_torch.lang import HeuristicParser
from hybridgl_tpu_torch.parallel import full_eval, launch, workers
from hybridgl_tpu_torch.parallel.mesh import EvalBatch
from hybridgl_tpu_torch.pipeline import runner
from hybridgl_tpu_torch.tools.dryrun import TinyVocabTokenizer

from test_torch_pipeline import make_sample
from torch_port_config import to_port
from torch_ref import tiny_clip_config
from torch_ref_sam import tiny_sam_config

LIMIT = 180.0  # seconds a spawned run may take (a few seconds alone; the suite runs six workers at once)


def jax_cfg():
    clip_cfg, sam_cfg = tiny_clip_config(), tiny_sam_config()
    cfg = PipelineConfig(
        clip_config=clip_cfg, sam_config=sam_cfg, fusion_mode="G2L", canonical_size=32, crop_size=clip_cfg.image_size,
        amg=AmgConfig(points_per_side=2, points_per_batch=4, pred_iou_thresh=0.0, stability_score_thresh=0.0, max_proposals=4),
        gem=GemConfig(img_size=32, depth=1),
    )
    return cfg.replace(guidance=cfg.guidance.__class__(masking_block=clip_cfg.vision_layers - 2))


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The short step's inputs: config, weights as .npz, a global batch of 4."""
    cfg = to_port(jax_cfg())
    g = torch.Generator().manual_seed(int(np.random.default_rng(9).integers(1 << 30)))
    root = tmp_path_factory.mktemp("weights")
    paths = {"sam": str(root / "sam.npz"), "clip": str(root / "clip.npz")}
    checkpoint.save(paths["sam"], init_sam(g, cfg.sam))
    checkpoint.save(paths["clip"], init_clip(g, cfg.clip))
    rng = np.random.default_rng(1)
    B, S, C, L = 4, cfg.sam.img_size, cfg.canonical_size, cfg.clip.context_length
    toks = np.zeros((B, L), np.int32)
    toks[:, 0], toks[:, 1], toks[:, 2] = cfg.clip.vocab_size - 2, 5, cfg.clip.vocab_size - 1
    batch = EvalBatch(
        image_1024=rng.integers(0, 255, (B, S, S, 3)).astype(np.uint8), rh=np.full(B, S, np.int32), rw=np.full(B, S, np.int32),
        image_canonical=rng.integers(0, 255, (B, C, C, 3)).astype(np.uint8), h=np.full(B, C, np.int32),
        w=np.full(B, C, np.int32), gt_mask=rng.random((B, C, C)) > 0.5, tokens_sentence=toks, tokens_np=toks.copy(),
    )
    return dict(cfg=cfg, batch=batch, **paths)


@pytest.fixture(scope="module")
def dp2(spec):
    out = launch.spawn_workers(workers.sharded_step_worker, 2, (spec,), "cpu", timeout=LIMIT)
    assert out[0]["acc"] == out[1]["acc"] and np.array_equal(out[0]["sels"], out[1]["sels"])  # replicated results
    return out[0]


def same_step_result(a, b):
    assert int(a["acc"][3]) == int(b["acc"][3]) == 4  # one update per image, summed
    np.testing.assert_allclose(a["acc"], b["acc"], rtol=1e-5)
    np.testing.assert_array_equal(a["sels"], b["sels"])
    assert a["sels"].shape == (4,) and a["acc"][1] >= a["acc"][0] >= 0.0


def test_sharded_step_world_2_matches_world_1(spec, dp2):
    threads = torch.get_num_threads()
    one = launch.run_in_process(workers.sharded_step_worker, (spec,), "cpu", timeout=LIMIT)[0]
    assert torch.get_num_threads() == threads and not torch.distributed.is_initialized()
    same_step_result(dp2, one)


def test_sharded_step_dp_by_mp_matches_dp(spec, dp2):
    """(dp, mp) = (2, 2): proposal-axis sharding of the fusion stage reproduces the 1D result."""
    out = launch.spawn_workers(workers.sharded_step_worker, 4, (dict(spec, mp=2),), "cpu", timeout=LIMIT)
    same_step_result(out[0], dp2)
    assert all(np.array_equal(o["sels"], out[0]["sels"]) for o in out)


def test_prepare_records_equal_reference():
    """Parsed, tokenized and padded records: every array equal to the JAX
    package's on the same samples (ragged sentence counts, a missing ground
    truth, an explicit bucket and the default one)."""
    cfg_j = jax_cfg()
    cfg_t = to_port(cfg_j)
    long = ["the cup on the left", "the dog to the right of the bench", "the biggest box", "small bird above the water",
            "person in the middle next to a car and a bus and a truck"]
    for max_sentences in (None, 8):
        batches = []
        for module, parser, cfg, mod in ((jrunner, JaxHeuristicParser(), cfg_j, jfull), (runner, HeuristicParser(), cfg_t, full_eval)):
            samples = [make_sample(module, 1), make_sample(module, 2)._replace(sentences=long),
                       make_sample(module, 3)._replace(sentences=[], gt_mask=None)]
            batches.append(mod.prepare_records(samples, parser, cfg, tokenizer=TinyVocabTokenizer(), max_sentences=max_sentences))
        want, got = batches
        assert got._fields == want._fields
        for name in want._fields:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.sentence_valid.sum() == 8 and got.tokens_sentence.shape[1] == (5 if max_sentences is None else 8)
    assert full_eval.sentence_bucket([make_sample(runner, 1)]) == 4
    assert full_eval.sentence_bucket([make_sample(runner, 1)._replace(sentences=long)]) == 8


def random_ingredients(rng, B=6, S=4, P=8):
    num = np.array([5, 2, 0, 8, 1, 6], np.int32)[:B]
    valid = np.zeros((B, P), bool)
    for b in range(B):
        valid[b, : num[b]] = True
    valid[0, 2] = False  # a suppressed duplicate in the middle: validity is no prefix
    num[0] = 4
    boxes = np.concatenate([rng.uniform(0, 20, (B, P, 2)), rng.uniform(2, 12, (B, P, 2))], -1).astype(np.float32)
    inter = rng.integers(0, 200, (B, P)).astype(np.float32)
    union = inter + rng.integers(1, 300, (B, P)).astype(np.float32)
    fields = dict(
        num=num, score=rng.standard_normal((B, S, P)).astype(np.float32) * 3,
        score_neg=rng.standard_normal((B, S, P)).astype(np.float32) * 3,
        gem_scores=rng.standard_normal((B, S, P)).astype(np.float32), boxes_xywh=boxes, prop_valid=valid,
        iu=np.stack([inter, union, inter / union], -1).astype(np.float32),
    )
    sv = np.ones((B, S), bool)
    sv[1, 2:] = False
    sv[4, 1:] = False
    batch = dict(sentence_valid=sv, rela_flag=rng.integers(0, 8, (B, S)).astype(np.int32), has_other=rng.random((B, S)) > 0.5,
                 gt_mask=rng.random((B, 16, 16)) > 0.5)
    return fields, batch


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finalize_sticky_equal_reference(seed):
    """The host replay of the sticky clamp on the same numpy ingredients:
    equal indices, IoUs, k1/k2 and accumulators (a zero-proposal image
    records misses without clamping; a 1-proposal image clamps for good)."""
    fields, batch = random_ingredients(np.random.default_rng(seed))
    cfg_j = jax_cfg()
    filler = {k: np.zeros((6, 1), np.int32) for k in jfull.FullEvalBatch._fields if k not in batch}
    want = jfull.finalize_sticky(cfg_j, jfull.Ingredients(**fields), jfull.FullEvalBatch(**filler, **batch), 3, 6)
    got = full_eval.finalize_sticky(to_port(cfg_j), full_eval.Ingredients(**fields),
                                    full_eval.FullEvalBatch(**filler, **batch), 3, 6)
    assert got[6:] == want[6:] == (1, 1)
    for a, b in zip(got[2:6], want[2:6]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose([float(v) for v in a], [float(v) for v in b], rtol=1e-12)
    assert int(got[0].count) == int(batch["sentence_valid"].sum())
    assert (got[2][2] == -1).all() and len({int(v) for v in got[3].ravel()}) > 3


def test_ingredients_nbytes_equal_reference_and_real():
    for P, S in ((64, 8), (128, 4), (8, 2)):
        assert full_eval.ingredients_nbytes_per_image(P, S) == jfull.ingredients_nbytes_per_image(P, S)
        ing = full_eval.Ingredients(
            num=np.zeros(1, np.int32), score=np.zeros((1, S, P), np.float32), score_neg=np.zeros((1, S, P), np.float32),
            gem_scores=np.zeros((1, S, P), np.float32), boxes_xywh=np.zeros((1, P, 4), np.float32),
            prop_valid=np.zeros((1, P), bool), iu=np.zeros((1, P, 3), np.float32))
        assert sum(x.nbytes for x in ing) == full_eval.ingredients_nbytes_per_image(P, S)
    assert full_eval.ingredients_nbytes_per_image(64, 8) == 8004
    row = full_eval._pack(dict(num=3, **{k: torch.zeros(s) for k, s in (
        ("score", (8, 64)), ("score_neg", (8, 64)), ("gem_scores", (8, 64)), ("boxes_xywh", (64, 4)),
        ("prop_valid", (64,)), ("iu", (64, 3)))}))
    assert row.numel() * row.element_size() == (1 + 3 * 8 * 64 + 8 * 64) * 4 == 8196  # what the sticky step gathers
    # the step's own gathered row unpacks to the same fields
    flat = torch.arange(2 * (1 + 3 * 2 * 8 + 8 * 8), dtype=torch.float32).reshape(2, -1)
    un = full_eval._unpack(flat, 2, 8)
    assert un.score.shape == (2, 2, 8) and un.iu.shape == (2, 8, 3) and un.prop_valid.dtype == bool and un.num.dtype == np.int32
