"""The scoring stages as capturable dispatches (``pipeline/scoring.py``,
``pipeline/score_graph.py``, ``pipeline/guidance.py``), on the CPU at
test-tiny, against the JAX package's jitted stages with the same inputs
traced:

* the feature stage with the image's (h, w) as a device table against the
  reference's jitted ``feature_stage`` with ``h, w`` traced, at three image
  sizes in a 640 canonical frame: fusion features and GEM patch features
  within 1e-4 (f32);
* the batched selection against the reference's ``select_candidates``
  (jitted, vmapped over sentences, flags and k1/k2 traced) for every relation
  flag, both has-other-nouns values and every k1 <= 3, k2 <= 6: pure and
  final index exactly;
* ``normalize_heatmap`` with a device flag per heatmap and the device (h, w)
  against the reference's for the six direction flags at three sizes: within
  1e-6 relative, 1e-6 absolute (f32 sums over up to 640^2 pixels in another
  order);
* capturability: a dispatch mode records every operator of ``_score_image``
  with its shapes, dtypes and non-tensor arguments; three image sizes and two
  sets of flags give one record, every tensor an operator takes is a named
  input (the parameters, the bundle, the accumulators, the per-device
  constants, the score graph's static inputs and what ``upload_into`` copies
  into them) or made inside, nothing uploads a host array, and nothing reads
  a tensor back;
* the runner: ``run_image`` and ``run_dataset`` against the reference's
  runner through ``materialize_results`` over images of mixed sizes with 1,
  2, 3 and 5 sentences (padded to 1, 2, 4 and 8), the sticky clamp on and
  off, and a zero-proposal image: selections exactly, IoUs within 1e-4,
  accumulators within 1e-6 relative (the bars of tests/test_torch_pipeline.py).
"""

import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import AmgConfig, GemConfig, PipelineConfig
from hybridgl_tpu.core.params import init_clip, init_sam
from hybridgl_tpu.kernels import resize as jresize
from hybridgl_tpu.lang import HeuristicParser
from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu.pipeline import guidance as jguid
from hybridgl_tpu.pipeline import runner as jrunner
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.kernels.resize import valid_mask
from hybridgl_tpu_torch.models.gem import gem
from hybridgl_tpu_torch.models.sam import amg as tamg
from hybridgl_tpu_torch.pipeline import guidance, preprocess, runner, score_graph, scoring
from hybridgl_tpu_torch.utils import transfer

from test_torch_pipeline import SENTENCES, WordTokenizer, build_pipelines, make_sample, synthetic_props
from test_torch_stage_graph import StageRecord
from torch_port_config import to_port
from torch_ref import tiny_clip_config
from torch_ref_sam import tiny_sam_config

WIDE = 640  # the RefCOCO canonical frame
SIZES = [(480, 640), (640, 427), (240, 640)]  # landscape, portrait, one side below half the frame


# ------------------------------------------------------------ feature stage
@functools.lru_cache(maxsize=None)
def _wide_pipelines():
    """The reference's runner and the port's stage inputs at test-tiny CLIP
    in a 640 canonical frame (G2L, masking block depth - 2): (JAX pipeline,
    port config, port CLIP parameters)."""
    clip_cfg, sam_cfg = tiny_clip_config(), tiny_sam_config()
    cfg = PipelineConfig(clip_config=clip_cfg, sam_config=sam_cfg, fusion_mode="G2L", canonical_size=WIDE,
                         crop_size=clip_cfg.image_size, amg=AmgConfig(points_per_side=4, max_proposals=8),
                         gem=GemConfig(img_size=32, depth=2))
    cfg = cfg.replace(guidance=cfg.guidance.__class__(masking_block=clip_cfg.vision_layers - 2))
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    clip_np, sam_np = to_np(init_clip(keys[0], clip_cfg)), to_np(init_sam(keys[1], sam_cfg))
    jax_pipe = jrunner.HybridGLPipeline(cfg, jax.tree_util.tree_map(jnp.asarray, sam_np),
                                        jax.tree_util.tree_map(jnp.asarray, clip_np), parser=HeuristicParser(),
                                        tokenizer=WordTokenizer())
    return jax_pipe, to_port(cfg), from_numpy_tree(clip_np)


def _wide_inputs(seed, h, w, P=8):
    """A random h x w image in the canonical frame and P rectangle masks inside it."""
    rng = np.random.default_rng(seed)
    image = np.zeros((WIDE, WIDE, 3), np.uint8)
    image[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    masks = np.zeros((P, WIDE, WIDE), bool)
    for i in range(P):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        masks[i, y0 : y0 + rng.integers(10, h - y0), x0 : x0 + rng.integers(10, w - x0)] = True
    return image, masks


@pytest.mark.parametrize("hw", SIZES, ids=["landscape", "portrait", "small"])
def test_feature_stage_with_device_hw_matches_jax_traced(hw):
    """Fusion features and GEM patch features within 1e-4 (f32) of the
    reference's jitted ``feature_stage`` with h, w traced (one compile for
    every size)."""
    h, w = hw
    jax_pipe, cfg, clip_params = _wide_pipelines()
    image, masks = _wide_inputs(h + w, h, w)
    P = masks.shape[0]
    z = jnp.zeros(P, jnp.float32)
    props = jamg.Proposals(jnp.asarray(masks), jnp.zeros((P, 4)), z, z, jnp.zeros((P, 2)), z, jnp.ones(P, bool),
                           num=jnp.int32(P), overflow=jnp.int32(0))
    want_f, want_g = jax_pipe._feature_stage(jax_pipe.clip_params, props, jnp.asarray(image), jnp.int32(h), jnp.int32(w))
    got_f, got_g = scoring.feature_stage(cfg, clip_params, torch.from_numpy(masks), torch.from_numpy(image),
                                         torch.tensor([h, w]))
    assert got_f.shape == want_f.shape and got_g.shape == want_g.shape
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-4, rtol=0)


# ---------------------------------------------------------------- guidance
@functools.lru_cache(maxsize=None)
def _jax_select():
    return jax.jit(jax.vmap(jguid.select_candidates, in_axes=(0, 0, None, 0, None, 0, 0, None, None)))


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_selection_matches_jax_exactly(seed):
    """16 sentences (8 relation flags x has-other-nouns false/true) in one
    call, for every (k1, k2) with k1 <= 3 and k2 <= 6: pure and final index
    equal to the reference's. The scores hold ties and invalid slots."""
    rng = np.random.default_rng(seed)
    P, S = 12, 16
    score = rng.standard_normal((S, P)).astype(np.float32)
    score[:, 5] = score[:, 2]  # a tie: lower index first
    score_neg = rng.standard_normal((S, P)).astype(np.float32)
    gem_scores = rng.standard_normal((S, P)).astype(np.float32)
    xy = rng.uniform(0, 50, (P, 2))
    boxes = np.concatenate([xy, rng.uniform(1, 40, (P, 2))], 1).astype(np.float32)
    valid = rng.random(P) > 0.25
    valid[:2] = True
    rela = np.tile(np.arange(len(guidance.RELA_FLAGS)), 2)
    has_other = np.repeat([False, True], len(guidance.RELA_FLAGS))
    for k1 in range(guidance.K1_MAX + 1):
        for k2 in range(guidance.K2_MAX + 1):
            want = _jax_select()(*(jnp.asarray(a) for a in (score, score_neg, boxes, gem_scores, valid, rela, has_other)),
                                 jnp.int32(k1), jnp.int32(k2))
            got = guidance.select_candidates(*(torch.from_numpy(a) for a in (score, score_neg, boxes, gem_scores, valid,
                                                                               rela, has_other)),
                                             torch.tensor(k1), torch.tensor(k2))
            assert got.pure_index.dtype == torch.int64 and got.pure_index.shape == (S,)
            np.testing.assert_array_equal(got.pure_index.numpy(), np.asarray(want.pure_index), err_msg=f"{k1} {k2}")
            np.testing.assert_array_equal(got.final_index.numpy(), np.asarray(want.final_index), err_msg=f"{k1} {k2}")


@pytest.mark.parametrize("hw", SIZES, ids=["landscape", "portrait", "small"])
def test_normalize_heatmap_with_device_flags_matches_jax(hw):
    """Six heatmaps with the six direction flags in one call (flags a [6]
    tensor, (h, w) a device table) against the reference's, one flag each."""
    h, w = hw
    heat = np.random.default_rng(h * w).standard_normal((len(guidance.DIR_FLAGS), WIDE, WIDE)).astype(np.float32)
    hw_t = torch.tensor([h, w])
    got = guidance.normalize_heatmap(torch.from_numpy(heat), valid_mask((WIDE, WIDE), hw_t), torch.arange(6), hw_t)
    jnorm = jax.jit(jguid.normalize_heatmap)
    vm = jresize.valid_mask((WIDE, WIDE), (h, w))
    for flag in range(len(guidance.DIR_FLAGS)):
        want = np.asarray(jnorm(jnp.asarray(heat[flag]), vm, jnp.int32(flag)))
        np.testing.assert_allclose(got[flag].numpy(), want, rtol=1e-6, atol=1e-6, err_msg=guidance.DIR_FLAGS[flag])


# -------------------------------------------------------- capturability
@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines("G2L")


class ScoreRecord(StageRecord):
    """:class:`StageRecord`, with the reads of a tensor back to the host;
    host data that enters through ``upload_into`` (``entering`` set) is a
    named input, not a foreign tensor."""

    READS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero", "aten.is_nonzero")

    def __init__(self, inputs):
        super().__init__(inputs)
        self.reads, self.entering = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.READS):
            self.reads.append(str(func))
        if self.entering and func in self.HOST_DATA:
            self.ops.append((str(func), []))
            out = func(*args, **(kwargs or {}))
            self.known[id(out)] = out
            return out
        return super().__torch_dispatch__(func, types, args, kwargs)


def _record_score(monkeypatch, pipe, sample, props, state):
    """``_score_image`` of one image under :class:`ScoreRecord`, with host
    reads through ``tolist``, ``numpy``, ``item`` and the number conversions
    recorded too: (record, host arrays uploaded, reads)."""
    scorer = pipe.scorer
    statics = [scorer.image_c, scorer.hw, scorer.k, scorer.gt, scorer.acc]
    for bk in scorer.buckets.values():
        statics += [bk.masks, bk.boxes_xyxy, bk.valid, bk.feats, bk.gem_pf]
    for sent in scorer.sentence_inputs.values():
        statics += list(sent)
    consts = [*preprocess.constants(pipe.device), *gem.norm_constants(pipe.device)]
    inputs = [*pytree.tree_flatten(pipe.clip_params)[0], *props[:7], *state.pure, *state.final, *statics, *consts]
    mode = ScoreRecord(inputs)
    uploads, reads = [], []
    real_upload, real_into = transfer.upload, transfer.upload_into

    def counting(x, device, dtype=None):
        if not isinstance(x, (int, float, bool, np.generic, torch.Tensor)):
            uploads.append(type(x).__name__)
        return real_upload(x, device, dtype)

    def into(dst, x):  # the sanctioned entry of host data: a copy into a static input
        mode.entering = True
        try:
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        finally:
            mode.entering = False
        mode.known[id(t)] = t
        return real_into(dst, t)

    for name, module in list(sys.modules.items()):
        if name.startswith("hybridgl_tpu_torch"):
            if getattr(module, "upload", None) is real_upload:
                monkeypatch.setattr(module, "upload", counting)
            if getattr(module, "upload_into", None) is real_into:
                monkeypatch.setattr(module, "upload_into", into)
    for attr in ("tolist", "numpy", "item", "__int__", "__float__", "__bool__", "__index__"):
        real = getattr(torch.Tensor, attr)
        monkeypatch.setattr(torch.Tensor, attr,
                            lambda self, *a, _real=real, _attr=attr, **k: reads.append(_attr) or _real(self, *a, **k))
    with mode:
        results = pipe._score_image(sample, props, state, bucket=8)
    monkeypatch.undo()
    return mode, uploads, reads, results


def test_score_image_launches_the_same_operators_for_every_image_and_flag(pipelines, monkeypatch):
    """Three image sizes x two sets of three sentences (different relation,
    direction and other-noun flags) through ``_score_image`` give one
    operator record; no tensor enters but the named inputs and
    ``upload_into``'s copies, no host array is uploaded, nothing is read
    back. So one captured pair of graphs (bucket 8, sentence bucket 4)
    serves them all."""
    _, _, pipe = pipelines
    props = synthetic_props(tamg, torch.from_numpy)
    flag_sets = (SENTENCES[:3], SENTENCES[2:])
    pipe._score_image(make_sample(runner, 3)._replace(sentences=flag_sets[0]), props, pipe.init_state(), bucket=8)
    assert len({pipe._row(s)[3] for s in flag_sets[0] + flag_sets[1]}) > 1
    records = []
    for h, w in ((24, 32), (32, 20), (12, 32)):
        for sentences in flag_sets:
            sample = make_sample(runner, h + w, h=h, w=w)._replace(sentences=sentences)
            mode, uploads, reads, results = _record_score(monkeypatch, pipe, sample, props, pipe.init_state())
            assert uploads == [] and reads == [] and mode.reads == [], (uploads, reads, mode.reads)
            assert mode.foreign == [], sorted(set(mode.foreign))
            assert len(results) == 3 and all(isinstance(r.pure_index, torch.Tensor) for r in results)
            records.append(mode.ops)
    assert len(records[0]) > 200
    for other in records[1:]:
        assert len(other) == len(records[0])
        diff = [(a, b) for a, b in zip(records[0], other) if a != b]
        assert diff == [], diff[:3]


# --------------------------------------------------------------- runner
def picks(results):
    return [(r.pure_index, r.final_index) for r in results]


def agree(got, want, got_state, want_state):
    assert picks(got) == picks(want)
    for a, b in zip(got, want):
        assert abs(a.pure_iou - b.pure_iou) <= 1e-4 and abs(a.final_iou - b.final_iou) <= 1e-4
    assert (got_state.k1, got_state.k2) == (want_state.k1, want_state.k2)
    np.testing.assert_allclose([float(v) for v in (*got_state.pure, *got_state.final)],
                               [float(v) for v in (*want_state.pure, *want_state.final)], rtol=1e-6)


def _empty(module, to_array, P=8, C=32):
    """A bundle where no proposal survived."""
    z = np.zeros(P, np.float32)
    return module.Proposals(to_array(np.zeros((P, C, C), bool)), to_array(np.zeros((P, 4), np.float32)), to_array(z),
                            to_array(z), to_array(np.zeros((P, 2), np.float32)), to_array(z),
                            to_array(np.zeros(P, bool)), num=0, overflow=0)


def _mixed_samples(module):
    """Four images of mixed sizes with 1, 2, 3 and 5 sentences."""
    return [make_sample(module, seed, h=h, w=w)._replace(sentences=SENTENCES[:n])
            for seed, (h, w), n in zip((0, 1, 2, 3), ((24, 32), (32, 20), (12, 32), (32, 32)), (1, 2, 3, 5))]


@pytest.mark.parametrize("sticky", [True, False], ids=["sticky", "per_image_clamp"])
def test_run_image_and_run_dataset_match_jax(pipelines, sticky):
    """Mixed sizes, 1-5 sentences, then a zero-proposal image (the survival
    hook empties its bundle): run_image and run_dataset, each against the
    reference's runner image by image, through materialize_results."""
    cfg, jax_pipe, port_pipe = pipelines
    compat = dataclasses.replace(cfg.compat, k_clamp_sticky=sticky)
    saved = jax_pipe.cfg, port_pipe.cfg
    jax_pipe.cfg, port_pipe.cfg = cfg.replace(compat=compat), port_pipe.cfg.replace(compat=to_port(compat))
    try:
        for run in ("run_image", "run_dataset"):
            js, ts = jax_pipe.init_state(), port_pipe.init_state()
            want = [jrunner.materialize_results(jax_pipe.run_image(s, js)) for s in _mixed_samples(jrunner)]
            if run == "run_image":
                got = [runner.materialize_results(port_pipe.run_image(s, ts)) for s in _mixed_samples(runner)]
            else:
                got = [runner.materialize_results(r) for _, r in port_pipe.run_dataset(iter(_mixed_samples(runner)), ts)]
            assert [len(r) for r in got] == [1, 2, 3, 5]
            for g, w_ in zip(got, want):
                agree(g, w_, ts, js)
            assert float(ts.pure.count) == 11
            # a zero-proposal image: a miss per sentence, no clamp
            jax_pipe.survival_hook = lambda props: _empty(jamg, jnp.asarray)
            port_pipe.survival_hook = lambda props: _empty(tamg, torch.from_numpy)
            sample_j, sample_t = (make_sample(m, 9)._replace(sentences=SENTENCES[:2]) for m in (jrunner, runner))
            want = jrunner.materialize_results(jax_pipe.run_image(sample_j, js))
            got = runner.materialize_results(port_pipe.run_image(sample_t, ts))
            jax_pipe.survival_hook = port_pipe.survival_hook = None
            assert got == want == [runner.SentenceResult(s, -1, -1, 0.0, 0.0) for s in SENTENCES[:2]]
            agree(got, want, ts, js)
            assert float(ts.pure.count) == 13
    finally:
        jax_pipe.cfg, port_pipe.cfg = saved
        jax_pipe.survival_hook = port_pipe.survival_hook = None


def test_padded_sentences_add_nothing(pipelines):
    """Three sentences run padded to four (row 0 repeated, enable 0): the
    accumulators count three, and each result equals that sentence alone."""
    _, _, pipe = pipelines
    props = synthetic_props(tamg, torch.from_numpy)
    sample = make_sample(runner, 3)._replace(sentences=SENTENCES[:3])
    tokens, ints, floats = scoring.sentence_arrays([pipe._row(s) for s in sample.sentences], True)
    assert tokens.shape[0] == 4 and floats[:, 1].tolist() == [1, 1, 1, 0] and (tokens[3] == tokens[0]).all()
    state = pipe.init_state()
    together = runner.materialize_results(pipe._score_image(sample, props, state))
    assert float(state.pure.count) == float(state.final.count) == 3
    alone = [r for s in sample.sentences for r in runner.materialize_results(
        pipe._score_image(sample._replace(sentences=[s]), props, pipe.init_state()))]
    assert picks(together) == picks(alone)


def test_score_graph_runs_eagerly_off_the_card(pipelines):
    """Off the card the ScoreGraph captures nothing; its buffers are keyed by
    bucket and sentence bucket, and ``eager()`` reruns the last image's
    stages to the same picks, IoUs and accumulators."""
    _, _, pipe = pipelines
    props = synthetic_props(tamg, torch.from_numpy)
    sample = make_sample(runner, 3)._replace(sentences=SENTENCES[:2])
    state = pipe.init_state()
    results = pipe._score_image(sample, props, state)
    scorer = pipe.scorer
    assert isinstance(scorer, score_graph.ScoreGraph) and not scorer.captures and scorer.stats() == {}
    assert 8 in scorer.buckets and 2 in scorer.sentence_inputs
    feats, gem_pf, out = scorer.eager()
    assert torch.equal(feats, scorer.buckets[8].feats) and torch.equal(gem_pf, scorer.buckets[8].gem_pf)
    assert out.picks[:, 0].tolist() == [int(r.pure_index) for r in results]
    assert out.picks[:, 1].tolist() == [int(r.final_index) for r in results]
    assert torch.equal(out.acc, torch.stack([*state.pure, *state.final]).reshape(2, 4))
