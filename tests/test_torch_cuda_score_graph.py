"""The scoring stages' CUDA graphs on the card (``pipeline/score_graph.py``):
at the short and the ragged key (proposal bucket 8; sentence buckets 1 and
4, the latter holding 3 sentences and one padded row), each replay equal bit
for bit to the eager stages on the same inputs on every output (fusion
features, GEM patch features, scores, picks, IoUs, accumulators) with the
eager run's launch counts; one capture a key across image sizes and flags;
and ``_score_image`` without a stream synchronisation under
``torch.cuda.set_sync_debug_mode("error")``. The small f32 configuration of
``tests/test_torch_cuda_stage_graph.py`` (test-tiny CLIP, canonical 128),
and the same with the CLIP weights in bf16; in both every glue operator of
the CLIP blocks (``kernels/clip_glue.py``) launches its kernel.
Marked ``cuda``; each test skips where no CUDA card is present."""

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core.params import cast_tree
from hybridgl_tpu_torch.kernels import GLUE, launch_counts, reset_launch_counts
from hybridgl_tpu_torch.lang import HeuristicParser
from hybridgl_tpu_torch.models.sam.amg import Proposals
from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline, materialize_results
from hybridgl_tpu_torch.tools.dryrun import TinyVocabTokenizer

from test_torch_cuda_stage_graph import SINGLE, SIZES, _config, _params, _sample

pytestmark = pytest.mark.cuda

C = 128
SENTENCES = ["the red cup on the left", "dog under the table", "the big one next to a person"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pipeline(dev, clip_dtype=torch.float32):
    sam_p, clip_p = _params(dev)
    return HybridGLPipeline(_config(SINGLE), sam_p, cast_tree(clip_p, clip_dtype), HeuristicParser(),
                            TinyVocabTokenizer(), device=dev)


def _bundle(dev, h, w, P=8, live=6, seed=0):
    """``live`` rectangles inside an h x w image, in P slots (bucket 8)."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((P, C, C), bool)
    boxes = np.zeros((P, 4), np.float32)
    for i in range(live):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        y1, x1 = y0 + rng.integers(4, h // 2), x0 + rng.integers(4, w // 2)
        masks[i, y0:y1, x0:x1] = True
        boxes[i] = [x0, y0, x1 - 1, y1 - 1]
    valid = np.arange(P) < live
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    z = t(np.zeros(P, np.float32))
    return Proposals(t(masks), t(boxes), z, z, t(np.zeros((P, 2), np.float32)), t(masks.sum((-2, -1)).astype(np.float32)),
                     t(valid), num=live, overflow=0)


@pytest.mark.parametrize("clip_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16_clip"])
@pytest.mark.parametrize("n_sentences", [1, 3], ids=["short_key", "ragged_key"])
def test_replay_equals_eager_bit_for_bit(dev, n_sentences, clip_dtype):
    pipe = _pipeline(dev, clip_dtype)
    scorer = pipe.scorer
    for seed, (h, w) in enumerate(SIZES):
        sample = _sample(seed, h, w)._replace(sentences=SENTENCES[:n_sentences])
        props = _bundle(dev, h, w, seed=seed)
        state = pipe.init_state()
        reset_launch_counts()
        results = pipe._score_image(sample, props, state, bucket=8)
        replayed = launch_counts()
        bk, sent = scorer.last
        feats, gem_pf, out = bk.feats.clone(), bk.gem_pf.clone(), scorer.outputs
        reset_launch_counts()
        e_feats, e_gem, e_out = scorer.eager()
        eager = launch_counts()
        torch.cuda.synchronize()
        assert replayed == eager and replayed["clip_attention"] > 0
        assert all(replayed[k] > 0 for k in GLUE)
        assert torch.equal(feats, e_feats) and torch.equal(gem_pf, e_gem)
        for name, a, b in zip(out._fields, out, e_out):
            assert torch.equal(a, b), name
        assert out.picks.shape[0] == (1 if n_sentences == 1 else 4)
        assert torch.equal(torch.stack([*state.pure, *state.final]).reshape(2, 4), out.acc)
        assert float(state.pure.count) == n_sentences  # the padded row adds nothing
        assert [[r.pure_index, r.final_index] for r in materialize_results(results)] == out.picks[:n_sentences].tolist()
    S_b = 1 if n_sentences == 1 else 4
    assert dict(scorer.captures) == {"features 8": 1, f"sentences 8 x {S_b}": 1}
    st = scorer.stats()
    assert all(v["nodes"] > 0 and v["pool_bytes"] > 0 and v["capture_ms"] > 0 for v in st.values())
    # the glue's launches shown in every key's stats
    assert all(v["launches"].get("residual_layer_norm", 0) > 0 for v in st.values())


def test_sentence_outputs_outlive_the_next_replay(dev):
    """An image's results are copies: the next image's replay of the same
    key leaves them as they were."""
    pipe = _pipeline(dev)
    first = pipe._score_image(_sample(0, *SIZES[0])._replace(sentences=SENTENCES[:2]), _bundle(dev, *SIZES[0], seed=0),
                              pipe.init_state(), bucket=8)
    kept = materialize_results(first)
    pipe._score_image(_sample(1, *SIZES[2])._replace(sentences=SENTENCES[1:]), _bundle(dev, *SIZES[2], seed=5),
                      pipe.init_state(), bucket=8)
    torch.cuda.synchronize()
    assert materialize_results(first) == kept


def test_score_image_makes_no_stream_synchronisation(dev):
    """Once a key is captured, ``_score_image`` queues its copies and replays
    without making the host wait: the sync debug mode raises on any
    synchronising call."""
    pipe = _pipeline(dev)
    props = _bundle(dev, *SIZES[1])
    sample = _sample(1, *SIZES[1])._replace(sentences=SENTENCES)
    pipe._score_image(sample, props, pipe.init_state(), bucket=8)  # the capture
    torch.cuda.synchronize()
    state = pipe.init_state()
    torch.cuda.set_sync_debug_mode("error")
    try:
        results = pipe._score_image(sample, props, state, bucket=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(materialize_results(results)) == 3 and float(state.pure.count) == 3
