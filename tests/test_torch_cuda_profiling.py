"""The port's stage spans on the card (``utils/profiling.py:StageTimer``): over
a ``run_dataset`` of the small f32 configuration of
``tests/test_torch_cuda_stage_graph.py``, with its graphs captured, the
top-level spans' stream and gap times cover the stream's time from before
the first image to after the last within 2%, every span's events are folded
in, and the timer adds no stream synchronisation (the iteration runs under
``torch.cuda.set_sync_debug_mode("error")``). Marked ``cuda``; skips where
no CUDA card is present."""

import pytest
import torch

from hybridgl_tpu_torch.lang import HeuristicParser
from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline
from hybridgl_tpu_torch.tools.dryrun import TinyVocabTokenizer
from hybridgl_tpu_torch.utils.profiling import StageTimer

from test_torch_cuda_stage_graph import SINGLE, SIZES, _config, _params, _sample

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_stream_spans_cover_the_stream_without_a_sync(dev):
    sam_p, clip_p = _params(dev)
    pipe = HybridGLPipeline(_config(SINGLE), sam_p, clip_p, HeuristicParser(), TinyVocabTokenizer(), device=dev)
    samples = [_sample(seed, h, w) for seed, (h, w) in enumerate(SIZES)] * 2
    for _ in pipe.run_dataset(iter(samples), pipe.init_state()):  # the captures
        pass
    torch.cuda.synchronize()
    pipe.timer = StageTimer(block=False, device=dev)
    before, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        before.record()
        for _ in pipe.run_dataset(iter(samples), pipe.init_state()):
            pass
        after.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    totals, counts = dict(pipe.timer.totals), dict(pipe.timer.counts)
    stream_ms = before.elapsed_time(after)
    top_ms = 1e3 * sum(v for k, v in totals.items() if k.endswith("@gap") or (k.endswith("@device") and "/" not in k))
    assert abs(top_ms - stream_ms) <= 0.02 * stream_ms, (top_ms, stream_ms)
    n = len(samples)
    assert counts["proposals_dispatch"] == counts["proposals_dispatch@device"] == n
    assert counts["host_wait"] == n  # the hand-off's wait, once an image
    for name in ("proposals_dispatch", "small_region_cleanup", "parse+tokenize", "crops+fusion", "sentence_stage",
                 "host_wait"):
        assert counts[f"{name}@device"] == counts[name], name
    assert totals["proposals_dispatch@device"] > 0 and totals["crops+fusion@device"] > 0
    # the feature graph's device spans (G2L blocks, GEM): a pair each a replay, folded, or missed where the graph
    # replayed again before it was read (nothing here reads an image's results between its replays)
    spans = [counts.get(f"crops+fusion/{k}@device", 0) for k in ("g2l", "gem")]
    assert sum(spans) + counts.get("span_missed", 0) == 2 * counts["crops+fusion"]
    assert spans[0] == 0 or 0 < totals["crops+fusion/g2l@device"] < totals["crops+fusion@device"]
