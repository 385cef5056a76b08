"""The runner's paths in the port against each other and against the JAX
runner under the matching switch, on the tiny pipeline of
tests/test_torch_pipeline.py (CPU, f32, same weights): the batched sentence
stage (the port's only one; HYBRIDGL_BATCH_SENTENCES=1 in JAX), proposal
buckets (against HYBRIDGL_NO_BUCKETING=1 in JAX), the survival hook, the
cleanup on tensors (kernels/connected.py, which the runner takes under
HYBRIDGL_CLEANUP=device, as JAX does) against the runner's host pass, the
cleanup threads and the default expression parser. Selections must
be equal; IoUs agree to 1e-4 and accumulator sums to 1e-6 relative (1e-5
absolute between one call and one call a sentence, which differ only in the
shape of their matmuls)."""

import warnings

import numpy as np
import pytest
import torch

import jax

from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu.pipeline import runner as jrunner
from hybridgl_tpu_torch.models.sam import amg as tamg
from hybridgl_tpu_torch.pipeline import postprocess, runner

from test_torch_pipeline import SENTENCES, build_pipelines, make_sample, synthetic_props
from torch_port_config import to_port


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines("G2L")


def picks(results):
    return [(int(r.pure_index), int(r.final_index)) for r in results]


def sums(state):
    return [float(v) for v in (*state.pure, *state.final)]


def score(pipe, module, props_module, to_array, sentences):
    """_score_image on the 16-slot synthetic bundle -> (results, state)."""
    state = pipe.init_state()
    sample = make_sample(module, 3)._replace(sentences=sentences)
    results = pipe._score_image(sample, synthetic_props(props_module, to_array), state)
    return module.materialize_results(results), state


def agree(got, want, got_state, want_state, atol=0.0):
    assert picks(got) == picks(want)
    for a, b in zip(got, want):
        assert abs(a.pure_iou - b.pure_iou) <= 1e-4 and abs(a.final_iou - b.final_iou) <= 1e-4
    assert (got_state.k1, got_state.k2) == (want_state.k1, want_state.k2)
    np.testing.assert_allclose(sums(got_state), sums(want_state), rtol=1e-6, atol=atol)


def score_one_by_one(pipe, sentences):
    """One _score_image call a sentence on the synthetic bundle, one state."""
    state = pipe.init_state()
    results = []
    for sentence in sentences:
        sample = make_sample(runner, 3)._replace(sentences=[sentence])
        results += pipe._score_image(sample, synthetic_props(tamg, torch.from_numpy), state)
    return runner.materialize_results(results), state


@pytest.mark.parametrize("n_sentences", [5, 3, 1])
def test_batched_sentences_match_the_loop_and_jax(pipelines, monkeypatch, n_sentences):
    """All of an image's sentences go through one sentence stage with a
    leading sentence dimension (no power-of-two sentence padding): the same
    selections and accumulator sums as one call a sentence, as the JAX
    runner's per-sentence loop and as its batched stage."""
    _, jax_pipe, port_pipe = pipelines
    sentences = SENTENCES[:n_sentences]
    loop, loop_state = score_one_by_one(port_pipe, sentences)
    calls = []
    original = runner.HybridGLPipeline._sentence_stage
    monkeypatch.setattr(runner.HybridGLPipeline, "_sentence_stage",
                        lambda self, *a: calls.append(len(a[4])) or original(self, *a))
    got, got_state = score(port_pipe, runner, tamg, torch.from_numpy, sentences)
    assert calls == [n_sentences] and len(got) == n_sentences
    agree(got, loop, got_state, loop_state, atol=1e-5)
    assert float(got_state.pure.count) == n_sentences
    if n_sentences == 5:
        assert len({r.final_index for r in got}) > 1  # not degenerate
        want, want_state = score(jax_pipe, jrunner, jamg, jax.numpy.asarray, sentences)
        agree(got, want, got_state, want_state)
        monkeypatch.setenv("HYBRIDGL_BATCH_SENTENCES", "1")
        want, want_state = score(jax_pipe, jrunner, jamg, jax.numpy.asarray, sentences)
        agree(got, want, got_state, want_state)


def test_batched_sentences_run_image_matches_the_loop(pipelines):
    """run_image on all of an image's sentences against one run_image a
    sentence (the sticky clamps and the accumulators carried along)."""
    _, _, port_pipe = pipelines
    a, b = port_pipe.init_state(), port_pipe.init_state()
    want = []
    for seed in (0, 1):
        sample = make_sample(runner, seed)
        want.append([r for s in sample.sentences
                     for r in runner.materialize_results(port_pipe.run_image(sample._replace(sentences=[s]), a))])
    got = [runner.materialize_results(port_pipe.run_image(make_sample(runner, seed), b)) for seed in (0, 1)]
    for g, w in zip(got, want):
        assert picks(g) == picks(w) and [r.sentence for r in g] == [r.sentence for r in w]
    np.testing.assert_allclose(sums(b), sums(a), rtol=1e-6, atol=1e-5)


def test_no_sentences_give_no_results(pipelines):
    _, _, port_pipe = pipelines
    got, state = score(port_pipe, runner, tamg, torch.from_numpy, [])
    assert got == [] and float(state.pure.count) == 0


def test_batched_guidance_functions_equal_one_by_one():
    """normalize_heatmap and gem_mask_scores with a leading sentence
    dimension against one call a sentence: max|d| <= 1e-5."""
    from hybridgl_tpu_torch.kernels.resize import valid_mask
    from hybridgl_tpu_torch.pipeline.guidance import DIR_FLAGS, gem_mask_scores, normalize_heatmap

    rng = np.random.default_rng(0)
    C, S, P = 32, len(DIR_FLAGS), 7
    heat = torch.from_numpy(rng.standard_normal((S, C, C)).astype(np.float32))
    vm = valid_mask((C, C), (24, 31))
    flags = list(range(S))
    batched = normalize_heatmap(heat, vm, flags)
    masks = torch.from_numpy(rng.random((P, C, C)) > 0.6)
    black = torch.tensor([0.1 * i for i in range(S)])
    scores = gem_mask_scores(batched, masks, vm, black)
    assert batched.shape == (S, C, C) and scores.shape == (S, P)
    for i in range(S):
        one = normalize_heatmap(heat[i], vm, flags[i])
        assert float((batched[i] - one).abs().max()) <= 1e-5
        assert float((scores[i] - gem_mask_scores(one, masks, vm, float(black[i]))).abs().max()) <= 1e-5


def test_no_bucketing_matches_the_default_and_jax(pipelines, monkeypatch):
    """The 16-slot bundle with 6 live proposals scores in a bucket of 8 in
    the port, always (it bounds work, not compiled shapes); the JAX runner
    under HYBRIDGL_NO_BUCKETING=1 scores the whole bundle and in its default
    bucket: the same selections either way, and HYBRIDGL_NO_BUCKETING is no
    switch of the port."""
    _, jax_pipe, port_pipe = pipelines
    props = synthetic_props(tamg, torch.from_numpy)
    assert port_pipe._bucket_props(props).masks.shape[0] == 8
    default, default_state = score(port_pipe, runner, tamg, torch.from_numpy, SENTENCES)
    want, want_state = score(jax_pipe, jrunner, jamg, jax.numpy.asarray, SENTENCES)
    agree(default, want, default_state, want_state)
    monkeypatch.setenv("HYBRIDGL_NO_BUCKETING", "1")
    assert port_pipe._bucket_props(props).masks.shape[0] == 8
    got, got_state = score(port_pipe, runner, tamg, torch.from_numpy, SENTENCES)
    agree(got, default, got_state, default_state)
    want, want_state = score(jax_pipe, jrunner, jamg, jax.numpy.asarray, SENTENCES)
    agree(got, want, got_state, want_state)


def test_slice_props():
    props = synthetic_props(tamg, torch.from_numpy)
    cut = runner.HybridGLPipeline._slice_props(props, 8)
    assert all(getattr(cut, f).shape[0] == 8 for f in tamg.Proposals._fields[:7])
    assert (cut.num, cut.overflow) == (props.num, props.overflow)
    assert torch.equal(cut.masks, props.masks[:8]) and torch.equal(cut.valid, props.valid[:8])
    assert runner.HybridGLPipeline._slice_props(props, 16) is props
    assert runner.HybridGLPipeline._slice_props(props, 64) is props


def test_survival_hook_replaces_the_bundle_as_in_jax(pipelines):
    """The hook runs once per image at the end of the proposal stage, in
    run_image and in run_dataset; what it returns is what gets scored."""
    _, jax_pipe, port_pipe = pipelines
    seen = []

    def hook(props):
        seen.append(int(props.num))
        return synthetic_props(tamg, torch.from_numpy)

    want, want_state = score(port_pipe, runner, tamg, torch.from_numpy, SENTENCES)
    sample = make_sample(runner, 3)._replace(sentences=SENTENCES)
    try:
        port_pipe.survival_hook = hook
        jax_pipe.survival_hook = lambda props: synthetic_props(jamg, jax.numpy.asarray)
        state = port_pipe.init_state()
        got = runner.materialize_results(port_pipe.run_image(sample, state))
        assert len(seen) == 1 and seen[0] > 0 and port_pipe.last_proposals.num == 6
        agree(got, want, state, want_state)
        state_d = port_pipe.init_state()
        (_, piped), = list(port_pipe.run_dataset(iter([sample]), state_d))
        assert len(seen) == 2
        agree(runner.materialize_results(piped), want, state_d, want_state)
        js = jax_pipe.init_state()
        ref = jrunner.materialize_results(
            jax_pipe.run_image(make_sample(jrunner, 3)._replace(sentences=SENTENCES), js))
        agree(got, ref, state, js)
    finally:
        port_pipe.survival_hook = None
        jax_pipe.survival_hook = None
    assert len(seen) == 2


@pytest.fixture(scope="module")
def cleanup_pipelines(pipelines):
    """The tiny pipelines with min_mask_region_area = 12 (the default 800
    exceeds the 24 x 32 image, so every mask takes the keep-largest fallback):
    (the port, whose runner takes the host pass; JAX on its device pass)."""
    import dataclasses
    import os

    cfg, jax_pipe, port_pipe = pipelines
    cfg = cfg.replace(amg=dataclasses.replace(cfg.amg, min_mask_region_area=12))
    host = runner.HybridGLPipeline(to_port(cfg), port_pipe.sam_params, port_pipe.clip_params,
                                   parser=port_pipe.parser, tokenizer=port_pipe.tokenizer, device="cpu")
    saved = os.environ.get("HYBRIDGL_CLEANUP")
    os.environ["HYBRIDGL_CLEANUP"] = "device"
    try:
        jax_device = jrunner.HybridGLPipeline(cfg, jax_pipe.sam_params, jax_pipe.clip_params,
                                              parser=jax_pipe.parser, tokenizer=jax_pipe.tokenizer)
    finally:
        if saved is None:
            os.environ.pop("HYBRIDGL_CLEANUP")
        else:
            os.environ["HYBRIDGL_CLEANUP"] = saved
    assert jax_device._device_cleanup
    return host, jax_device


def tensor_pass(pipe, props, sample):
    """kernels/connected.py on a raw proposal bundle, with the runner's arguments."""
    from hybridgl_tpu_torch.kernels.connected import cleanup_proposals_jit
    from hybridgl_tpu_torch.kernels.resize import valid_mask

    amg, C = pipe.cfg.amg, pipe.cfg.canonical_size
    return cleanup_proposals_jit(props, valid_mask((C, C), (sample.h, sample.w)), amg.min_mask_region_area,
                                 max(amg.box_nms_thresh, amg.crop_nms_thresh))


@pytest.mark.parametrize("seed", [0, 1])
def test_device_cleanup_matches_the_host_pass_and_jax(cleanup_pipelines, seed):
    """The cleanup on tensors (kernels/connected.py) of the runner's raw
    proposals equals the runner's host pass and the JAX runner's proposals
    under HYBRIDGL_CLEANUP=device, and scores to the same selections."""
    host, jax_device = cleanup_pipelines
    sample = make_sample(runner, seed)
    want = host.propose(sample)
    got = tensor_pass(host, host._launch_proposals(sample), sample)
    ref = jax_device.propose(make_sample(jrunner, seed))
    assert got.num == want.num == int(ref.num) and got.num > 0
    for name in ("valid", "boxes_xyxy"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    # a dead slot keeps its pixels on the host pass and loses them on the device pass
    assert torch.equal(got.masks, want.masks & want.valid[:, None, None])
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(ref.masks))
    a, b, js = host.init_state(), host.init_state(), jax_device.init_state()
    r_host = runner.materialize_results(host.run_image(sample, a))
    r_dev = runner.materialize_results(host._score_image(sample, got, b))
    r_jax = jrunner.materialize_results(jax_device.run_image(make_sample(jrunner, seed), js))
    agree(r_dev, r_host, b, a)
    agree(r_dev, r_jax, b, js)


def test_device_cleanup_changes_something(cleanup_pipelines):
    """The comparison above is not vacuous: at min_mask_region_area = 12 the
    cleanup alters or suppresses at least one raw proposal of the two images."""
    host, _ = cleanup_pipelines
    differs = False
    for seed in (0, 1):
        sample = make_sample(runner, seed)
        raw = host._launch_proposals(sample)
        cleaned = tensor_pass(host, raw, sample)
        differs |= not torch.equal(raw.masks & raw.valid[:, None, None], cleaned.masks) or raw.num != cleaned.num
    assert differs


@pytest.mark.parametrize("value", [None, "host", "cpu"])
def test_cleanup_is_the_host_pass_whatever_the_environment(cleanup_pipelines, monkeypatch, value):
    """Unless HYBRIDGL_CLEANUP is ``device`` (unset, ``host`` or any other
    value) the runner takes the native host pass, once an image, and never
    the pass on tensors."""
    from hybridgl_tpu_torch.kernels import connected

    host, _ = cleanup_pipelines
    if value is None:
        monkeypatch.delenv("HYBRIDGL_CLEANUP", raising=False)
    else:
        monkeypatch.setenv("HYBRIDGL_CLEANUP", value)
    pipe = device_pipeline(host)
    calls = []
    original = pipe._cleanup_host
    monkeypatch.setattr(pipe, "_cleanup_host", lambda *a: calls.append(1) or original(*a))
    monkeypatch.setattr(connected, "label_components", lambda *a: pytest.fail("the runner labelled on tensors"))
    sample = make_sample(runner, 0)
    got = pipe.propose(sample)
    want = host.propose(sample)
    assert calls == [1] and got.num == want.num and torch.equal(got.masks, want.masks)


def device_pipeline(host):
    """A runner on the host pipeline's config and weights, built now (it reads HYBRIDGL_CLEANUP once)."""
    return runner.HybridGLPipeline(host.cfg, host.sam_params, host.clip_params, parser=host.parser,
                                   tokenizer=host.tokenizer, device="cpu")


def speckled_survivors(cfg, n_live, seed, hw):
    """``workers.stamped_survivors`` with 2% of the image's pixels flipped in
    every live mask: one-pixel holes and islands for the cleanup to repair."""
    from hybridgl_tpu_torch.kernels.masks import mask_to_box
    from hybridgl_tpu_torch.parallel.workers import stamped_survivors

    props = stamped_survivors(cfg, n_live, seed, hw, "cpu")
    (h, w), C = hw, cfg.canonical_size
    flip = torch.zeros_like(props.masks)
    flip[:n_live, :h, :w] = torch.from_numpy(np.random.default_rng(seed).random((n_live, h, w)) < 0.02)
    masks = props.masks ^ flip
    return props._replace(masks=masks, boxes_xyxy=mask_to_box(masks) * props.valid[:, None].float(),
                          areas=masks.sum((-2, -1)).float())


@pytest.mark.parametrize("seed", [0, 1])
def test_device_cleanup_switch_in_run_image(cleanup_pipelines, monkeypatch, seed):
    """HYBRIDGL_CLEANUP=device: the runner cleans on tensors (never the host
    pass) and run_image gives the host pass's selections, IoUs and sums, on
    its own proposals, as the JAX runner does under the same switch."""
    host, jax_device = cleanup_pipelines
    monkeypatch.setenv("HYBRIDGL_CLEANUP", "device")
    pipe = device_pipeline(host)
    monkeypatch.setattr(pipe, "_cleanup_host", lambda *a: pytest.fail("the runner took the host pass"))
    sample = make_sample(runner, seed)
    a, b, js = host.init_state(), pipe.init_state(), jax_device.init_state()
    r_host = runner.materialize_results(host.run_image(sample, a))
    r_dev = runner.materialize_results(pipe.run_image(sample, b))
    r_jax = jrunner.materialize_results(jax_device.run_image(make_sample(jrunner, seed), js))
    assert pipe.last_proposals.num == host.last_proposals.num
    assert torch.equal(pipe.last_proposals.valid, host.last_proposals.valid)
    agree(r_dev, r_host, b, a)
    agree(r_dev, r_jax, b, js)


@pytest.mark.parametrize("n_live", [7, 5, 8])
def test_device_cleanup_switch_on_stamped_survivors(cleanup_pipelines, monkeypatch, n_live):
    """The stamped survivors of the parallel tests (``workers.stamped_survivors``),
    speckled, in place of the runner's proposals: under HYBRIDGL_CLEANUP=device
    run_image cleans them on tensors to the host pass's masks, boxes and
    validity, and selects as the host runner does."""
    host, _ = cleanup_pipelines
    sample = make_sample(runner, 30 + n_live)
    hw = (sample.h, sample.w)
    stamp = lambda _: speckled_survivors(host.cfg, n_live, 100 + n_live, hw)  # noqa: E731
    monkeypatch.setenv("HYBRIDGL_CLEANUP", "device")
    pipe = device_pipeline(host)
    out = {}
    for name, p in (("host", host), ("device", pipe)):
        monkeypatch.setattr(p, "_launch_proposals", stamp)
        state = p.init_state()
        out[name] = (runner.materialize_results(p.run_image(sample, state)), state, p.last_proposals)
    (r_host, s_host, p_host), (r_dev, s_dev, p_dev) = out["host"], out["device"]
    raw = stamp(None)
    assert not torch.equal(p_host.masks & p_host.valid[:, None, None], raw.masks), "the cleanup changed nothing"
    assert torch.equal(p_dev.masks, p_host.masks & p_host.valid[:, None, None])
    assert torch.equal(p_dev.boxes_xyxy, p_host.boxes_xyxy) and torch.equal(p_dev.valid, p_host.valid)
    assert p_dev.num == p_host.num
    agree(r_dev, r_host, s_dev, s_host)


def test_cleanup_threads_env_and_equal_results(monkeypatch):
    """HYBRIDGL_CLEANUP_THREADS: the bundle's rows split between that many
    native calls give the one call's result exactly."""
    from test_torch_connected import _bundle, _bundle_masks

    monkeypatch.delenv("HYBRIDGL_CLEANUP_THREADS", raising=False)
    import os

    assert postprocess.cleanup_threads() == (os.cpu_count() or 1)
    monkeypatch.setenv("HYBRIDGL_CLEANUP_THREADS", "0")
    assert postprocess.cleanup_threads() == 1
    C, h, w = 64, 56, 64
    props = _bundle(tamg, lambda v: v, _bundle_masks(5, C, h, w), 8, C)
    calls = []
    original = postprocess.postprocess_native.cleanup_batch
    monkeypatch.setattr(postprocess.postprocess_native, "cleanup_batch",
                        lambda masks, *a: calls.append(len(masks)) or original(masks, *a))
    monkeypatch.setenv("HYBRIDGL_CLEANUP_THREADS", "1")
    want, changed = postprocess.postprocess_small_regions(props, 12, 0.7, hw=(h, w))
    assert changed and calls == [8]
    for threads, n_calls in (("3", 3), ("64", 6)):  # never more calls than live rows
        calls.clear()
        monkeypatch.setenv("HYBRIDGL_CLEANUP_THREADS", threads)
        got, _ = postprocess.postprocess_small_regions(props, 12, 0.7, hw=(h, w))
        assert len(calls) == n_calls and sum(calls) == 8
        for name in ("masks", "boxes_xyxy", "valid", "areas"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert got.num == want.num


@pytest.mark.parametrize("bug", [True, False])
def test_default_parser_is_get_parser(pipelines, monkeypatch, bug):
    """With no parser given the runner asks lang.get_parser, with the
    config's rela_right_bug, as the reference's runner does (spaCy where it
    is installed, the heuristic parser with a warning otherwise)."""
    import dataclasses

    cfg, _, port_pipe = pipelines
    cfg = to_port(cfg)
    cfg = cfg.replace(compat=dataclasses.replace(cfg.compat, rela_right_bug=bug))
    asked = []
    sentinel = object()
    monkeypatch.setattr(runner, "get_parser", lambda **kw: asked.append(kw) or sentinel)
    pipe = runner.HybridGLPipeline(cfg, port_pipe.sam_params, port_pipe.clip_params, tokenizer=port_pipe.tokenizer,
                                   device="cpu")
    assert pipe.parser is sentinel and asked == [dict(rela_right_bug=bug)]
    given = runner.HybridGLPipeline(cfg, port_pipe.sam_params, port_pipe.clip_params, parser=port_pipe.parser,
                                    tokenizer=port_pipe.tokenizer, device="cpu")
    assert given.parser is port_pipe.parser and len(asked) == 1


def test_default_parser_falls_back_with_a_warning_without_spacy(pipelines):
    from hybridgl_tpu_torch.lang import HeuristicParser, get_parser

    try:
        import spacy  # noqa: F401
    except ImportError:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            parser = get_parser(rela_right_bug=False)
        assert isinstance(parser, HeuristicParser) and any("spaCy parser unavailable" in str(w.message) for w in caught)
    else:
        assert get_parser(prefer_spacy=False) is not None
