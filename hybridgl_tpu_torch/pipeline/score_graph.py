"""The feature and sentence stages captured as CUDA graphs, one per shape
key, and replayed for every image: the port's counterpart of the reference's
``jax.jit(feature_stage)`` and ``jax.jit(sentence_stage_accum)``
(hybridgl_tpu/pipeline/runner.py:361-373), which compile once per proposal
bucket and sentence bucket (:603-621, :760-801) because the image's (h, w),
the sentences' flags and the clamped k1/k2 are traced.

The stages (``pipeline/scoring.py``) take those as device tensors and read
nothing back, so one capture serves every image and sentence of its key:

* the feature stage, keyed by the proposal bucket B (8, 16, 32, 64; up to
  128 at PhraseCut): it reads the bucket's masks, the canonical frame and
  the [2] (h, w) table, and writes the bucket's fusion features [B, E] and
  GEM patch features into buffers of the bucket;
* the sentence stage, keyed by (B, S_b), S_b the sentence count padded to a
  power of two: it reads the bucket's masks, boxes, validity and features,
  the (h, w) table, the sentences' tokens [S_b, 2 + K, L], their counts and
  flags, the clamped (k1, k2), the ground truth and the [2, 4] accumulators,
  and gives the score table, the picks, their IoUs and the accumulators
  with the image's sentences added.

A :class:`ScoreGraph` owns those static inputs. Each image is copied into
them before its replays (``utils/transfer.py:upload_into``: host arrays
through pinned memory of the call's own, device tensors in stream order),
so no host array is read inside a capture; a pinned buffer captured as a
copy node would replay the first image's data. A key is captured at its
first image (``stage_graph.capture``: an eager warm-up on a side stream,
then the capture in ``thread_local`` mode in a private pool, then the
instantiation); a capture that fails raises, and nothing falls back to
eager on the card. Each graph has its own pool, so a replay of one key
cannot overwrite another key's buffers; the sentence stage's outputs are
copied out of its pool, since the runner keeps them past the next replay.
The kernel launch counters (K6 and the CLIP block's fused glue in the
feature stage, the glue in the sentence stage's text tower) add what the
capture counted at each replay. The feature graph holds two device spans
(``utils/profiling.py:device_span``), ``g2l`` (the G2L blocks) and ``gem``
(GEM's patch features), handed to the pipeline's timer after each replay:
``crops+fusion/g2l@device`` and ``crops+fusion/gem@device``. Off the card the
same stage functions run eagerly on the same static inputs.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..utils.profiling import GraphSpans, before_replay, recording, replayed
from ..utils.transfer import upload_into
from .scoring import SentenceInputs, SentenceOutputs, feature_stage, sentence_stage
from .stage_graph import Captured, capture, replay


class _Bucket:
    """A proposal bucket's static inputs (the fields the stages read of a
    bundle) and the feature graph's output buffers."""

    num = None  # the scoring stages pass a bundle's ``num`` through; a bucket has none

    def __init__(self, B: int, C: int, device):
        self.masks = torch.zeros((B, C, C), dtype=torch.bool, device=device)
        self.boxes_xyxy = torch.zeros((B, 4), dtype=torch.float32, device=device)
        self.valid = torch.zeros((B,), dtype=torch.bool, device=device)
        self.feats: Optional[torch.Tensor] = None  # made at the first run, outside any capture
        self.gem_pf: Optional[torch.Tensor] = None
        self.loaded = None  # the bundle's masks copied in by the last features() call
        self.graph: Optional[Captured] = None
        self.spans: Optional[GraphSpans] = None  # the graph's device spans (g2l, gem)


class ScoreGraph:
    """The scoring stages of one configuration, one set of CLIP parameters
    and one device: :meth:`features` then :meth:`sentences` for an image,
    replayed from one graph a key on a CUDA device, run eagerly elsewhere.

    ``captures`` counts the captures by key (each key once); :meth:`stats`
    gives each graph's warm-up, capture and instantiate ms, nodes, pool
    bytes and launches a replay; :meth:`eager` reruns the last image's
    stages eagerly on the inputs its replays read."""

    def __init__(self, cfg: PipelineConfig, clip_params, device):
        self.cfg, self.clip_params, self.device = cfg, clip_params, torch.device(device)
        C = cfg.canonical_size
        self.image_c = torch.zeros((C, C, 3), dtype=torch.uint8, device=self.device)
        self.hw = torch.zeros((2,), dtype=torch.int64, device=self.device)
        self.k = torch.zeros((2,), dtype=torch.int64, device=self.device)
        self.gt = torch.zeros((C, C), dtype=torch.bool, device=self.device)
        self.acc = torch.zeros((2, 4), dtype=torch.float32, device=self.device)
        self.buckets: dict = {}  # B -> _Bucket
        self.sentence_inputs: dict = {}  # S_b -> SentenceInputs of static tensors
        self.sentence_graphs: dict = {}  # (B, S_b) -> Captured
        self.captures = collections.Counter()
        self.last = None  # (bucket, sentence inputs) of the last sentences() call
        self.outputs: Optional[SentenceOutputs] = None  # what it returned

    def _bucket(self, props, fresh: bool) -> _Bucket:
        """The bucket of ``props`` with its masks, boxes and validity copied
        in: always for an image's feature stage (``fresh``), and for its
        sentence stage unless that feature stage copied in this very bundle."""
        B = int(props.masks.shape[0])
        bk = self.buckets.get(B)
        if bk is None:
            bk = self.buckets[B] = _Bucket(B, self.cfg.canonical_size, self.device)
        if fresh or props.masks is not bk.loaded:
            upload_into(bk.masks, props.masks)
            upload_into(bk.boxes_xyxy, props.boxes_xyxy)
            upload_into(bk.valid, props.valid)
        bk.loaded = props.masks if fresh else None
        return bk

    def _features(self, bk: _Bucket):
        feats, gem_pf = feature_stage(self.cfg, self.clip_params, bk.masks, self.image_c, self.hw)
        if bk.feats is None:
            bk.feats, bk.gem_pf = torch.empty_like(feats), torch.empty_like(gem_pf)
        bk.feats.copy_(feats)
        bk.gem_pf.copy_(gem_pf)

    def _sentences(self, bk: _Bucket, sent: SentenceInputs) -> SentenceOutputs:
        return sentence_stage(self.cfg, self.clip_params, bk, bk.feats, bk.gem_pf, sent, self.hw, self.gt, self.acc)

    @torch.inference_mode()
    def features(self, props, image_c, hw):
        """The feature stage of a bucketed bundle (``masks``, ``boxes_xyxy``,
        ``valid``), the canonical frame (host array or device tensor) and the
        image's (h, w): (features [B, E], GEM patch features), the bucket's
        buffers, which the next image of the bucket overwrites."""
        bk = self._bucket(props, fresh=True)
        upload_into(self.image_c, image_c)
        upload_into(self.hw, np.asarray(hw, np.int64))
        if self.device.type != "cuda":
            self._features(bk)
        else:
            if bk.graph is None:
                with recording(GraphSpans()) as bk.spans:
                    bk.graph = capture(lambda: self._features(bk), self.device)
                self.captures[f"features {bk.masks.shape[0]}"] += 1
            before_replay(bk.spans)
            replay(bk.graph)
            replayed(bk.spans)
        return bk.feats, bk.gem_pf

    @torch.inference_mode()
    def sentences(self, props, feats, gem_pf, arrays, k, gt, acc: torch.Tensor) -> SentenceOutputs:
        """The sentence stage of the bundle :meth:`features` took (or any
        bundle of a bucket, with its features): ``arrays`` from
        ``scoring.sentence_arrays``, the clamped (k1, k2), the ground truth
        (host array, device tensor or None) and the accumulators [2, 4]."""
        bk = self._bucket(props, fresh=False)
        if bk.feats is None:
            bk.feats, bk.gem_pf = torch.empty_like(feats), torch.empty_like(gem_pf)
        if feats is not bk.feats:
            bk.feats.copy_(feats)
        if gem_pf is not bk.gem_pf:
            bk.gem_pf.copy_(gem_pf)
        tokens, ints, floats = arrays
        S_b = tokens.shape[0]
        sent = self.sentence_inputs.get(S_b)
        if sent is None:
            sent = self.sentence_inputs[S_b] = SentenceInputs(
                torch.zeros(tokens.shape, dtype=torch.int32, device=self.device),
                torch.zeros(ints.shape, dtype=torch.int64, device=self.device),
                torch.zeros(floats.shape, dtype=torch.float32, device=self.device), self.k)
        for dst, src in zip(sent, (tokens, ints, floats, np.asarray(k, np.int64))):
            upload_into(dst, src)
        if gt is None:
            self.gt.zero_()
        else:
            upload_into(self.gt, gt)
        upload_into(self.acc, acc)
        self.last = (bk, sent)
        if self.device.type != "cuda":
            self.outputs = self._sentences(bk, sent)
            return self.outputs
        key = (int(bk.masks.shape[0]), S_b)
        graph = self.sentence_graphs.get(key)
        if graph is None:
            graph = self.sentence_graphs[key] = capture(lambda: self._sentences(bk, sent), self.device)
            self.captures[f"sentences {key[0]} x {key[1]}"] += 1
        self.outputs = SentenceOutputs(*(t.clone() for t in replay(graph)))
        return self.outputs

    @torch.inference_mode()
    def eager(self):
        """The last image's feature and sentence stages run eagerly on the
        inputs its replays read, the kernels counting their launches: the
        yardstick a replay is held to. -> (feats, gem_pf, SentenceOutputs)."""
        bk, sent = self.last
        feats, gem_pf = feature_stage(self.cfg, self.clip_params, bk.masks, self.image_c, self.hw)
        return feats, gem_pf, sentence_stage(self.cfg, self.clip_params, bk, feats, gem_pf, sent, self.hw, self.gt,
                                             self.acc)

    def stats(self) -> dict:
        """{"features B" or "sentences B x S_b": the capture's numbers}."""
        out = {f"features {B}": bk.graph.stats() for B, bk in self.buckets.items() if bk.graph is not None}
        out.update({f"sentences {B} x {S}": g.stats() for (B, S), g in self.sentence_graphs.items()})
        return out
