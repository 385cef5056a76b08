"""The runner's paths in the port against each other and against the JAX
runner under the matching switch, on the tiny pipeline of
tests/test_torch_pipeline.py (CPU, f32, same weights): the batched sentence
stage (the port's only one; HYBRIDGL_BATCH_SENTENCES=1 in JAX), proposal
buckets (against HYBRIDGL_NO_BUCKETING=1 in JAX), the survival hook, the
runner's one cleanup, its native host pass, against the JAX runner's
cleanup on tensors (under HYBRIDGL_CLEANUP=device, which the port does not
read), the cleanup threads and the default expression parser. Selections must
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
    (the port, whose runner takes its host pass; JAX under
    HYBRIDGL_CLEANUP=device, on its pass on tensors)."""
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


def jax_tensor_pass(cfg, props, hw):
    """The JAX package's cleanup on tensors (what its runner runs under
    HYBRIDGL_CLEANUP=device) on a port bundle, with the runner's arguments."""
    from hybridgl_tpu.kernels.connected import cleanup_proposals_jit
    from hybridgl_tpu.kernels.resize import valid_mask

    amg, C = cfg.amg, cfg.canonical_size
    bundle = jamg.Proposals(*(jax.numpy.asarray(t.numpy()) for t in props[:7]),
                            num=jax.numpy.asarray(int(props.num), jax.numpy.int32), overflow=props.overflow)
    return cleanup_proposals_jit(bundle, valid_mask((C, C), hw), amg.min_mask_region_area,
                                 max(amg.box_nms_thresh, amg.crop_nms_thresh))


def assert_same_bundle(got, want):
    """A port bundle from the host pass against a JAX bundle cleaned on tensors
    (which clears a dead slot's pixels, where the host pass leaves them)."""
    assert got.num == int(want.num) and got.num > 0
    for name in ("valid", "boxes_xyxy"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal((got.masks & got.valid[:, None, None]).numpy(), np.asarray(want.masks))


@pytest.mark.parametrize("seed", [0, 1])
def test_device_cleanup_matches_the_host_pass_and_jax(cleanup_pipelines, seed):
    """The JAX runner under HYBRIDGL_CLEANUP=device (its cleanup on tensors)
    against the port's runner and its host pass: the same proposals (count,
    validity, boxes, masks), and run_image's selections, IoUs and sums."""
    host, jax_device = cleanup_pipelines
    sample = make_sample(runner, seed)
    ref = jax_device.propose(make_sample(jrunner, seed))
    assert_same_bundle(host.propose(sample), ref)
    a, js = host.init_state(), jax_device.init_state()
    r_host = runner.materialize_results(host.run_image(sample, a))
    r_jax = jrunner.materialize_results(jax_device.run_image(make_sample(jrunner, seed), js))
    assert_same_bundle(host.last_proposals, ref)
    agree(r_host, r_jax, a, js)


def test_cleanup_changes_something(cleanup_pipelines):
    """The comparison above is not vacuous: at min_mask_region_area = 12 the
    host pass alters or suppresses at least one raw proposal of the two images."""
    host, _ = cleanup_pipelines
    differs = False
    for seed in (0, 1):
        sample = make_sample(runner, seed)
        raw = host._launch_proposals(sample)
        cleaned = host.propose(sample)
        live = lambda p: p.masks & p.valid[:, None, None]  # noqa: E731
        differs |= not torch.equal(live(raw), live(cleaned)) or int(raw.num) != cleaned.num
    assert differs


@pytest.mark.parametrize("name,value", [
    pytest.param(None, None, id="None"),
    pytest.param("HYBRIDGL_CLEANUP", "host", id="host"),
    pytest.param("HYBRIDGL_CLEANUP", "cpu", id="cpu"),
    pytest.param("HYBRIDGL_CLEANUP", "device", id="device"),
    pytest.param("HYBRIDGL_NO_NATIVE_CLEANUP", "1", id="no_native"),
    pytest.param("HYBRIDGL_FORCE_NATIVE_CLEANUP", "0", id="force_native_0"),
])
def test_cleanup_is_the_host_pass_whatever_the_environment(cleanup_pipelines, monkeypatch, name, value):
    """The reference's cleanup switches change nothing in the port: with any
    of them set when the pipeline is built and its library loaded, the
    runner takes its native host pass, once an image, through the native
    library, and cleans as a runner built without them."""
    host, _ = cleanup_pipelines
    sample = make_sample(runner, 0)
    want = host.propose(sample)
    for var in ("HYBRIDGL_CLEANUP", "HYBRIDGL_NO_NATIVE_CLEANUP", "HYBRIDGL_FORCE_NATIVE_CLEANUP"):
        monkeypatch.delenv(var, raising=False)
    if name is not None:
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(postprocess.postprocess_native, "_lib", None)  # loaded anew under this environment
    pipe = runner.HybridGLPipeline(host.cfg, host.sam_params, host.clip_params, parser=host.parser,
                                   tokenizer=host.tokenizer, device="cpu")
    calls, native = [], []
    original, batch = pipe._cleanup_host, postprocess.postprocess_native.cleanup_batch
    monkeypatch.setattr(pipe, "_cleanup_host", lambda *a: calls.append(1) or original(*a))
    monkeypatch.setattr(postprocess.postprocess_native, "cleanup_batch", lambda *a: native.append(1) or batch(*a))
    got = pipe.propose(sample)
    assert calls == [1] and native and postprocess.postprocess_native._lib is not None
    assert got.num == want.num and torch.equal(got.masks, want.masks) and torch.equal(got.valid, want.valid)


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


@pytest.mark.parametrize("n_live", [7, 5, 8])
def test_host_cleanup_matches_jax_on_stamped_survivors(cleanup_pipelines, monkeypatch, n_live):
    """The stamped survivors of the parallel tests (``workers.stamped_survivors``),
    speckled, in place of the runner's proposals: run_image's host pass
    cleans them to the masks, boxes and validity of the JAX package's cleanup
    on tensors, and selects as the JAX runner does on that cleaned bundle."""
    host, jax_device = cleanup_pipelines
    sample = make_sample(runner, 30 + n_live)
    hw = (sample.h, sample.w)
    raw = speckled_survivors(host.cfg, n_live, 100 + n_live, hw)
    monkeypatch.setattr(host, "_launch_proposals", lambda _: raw)
    state = host.init_state()
    r_host = runner.materialize_results(host.run_image(sample, state))
    cleaned = host.last_proposals
    assert not torch.equal(cleaned.masks & cleaned.valid[:, None, None], raw.masks), "the cleanup changed nothing"
    want = jax_tensor_pass(host.cfg, raw, hw)
    assert_same_bundle(cleaned, want)
    monkeypatch.setattr(jax_device, "survival_hook", lambda _: want)
    js = jax_device.init_state()
    r_jax = jrunner.materialize_results(jax_device.run_image(make_sample(jrunner, 30 + n_live), js))
    agree(r_host, r_jax, state, js)


def test_cleanup_threads_env_and_equal_results(monkeypatch):
    """HYBRIDGL_CLEANUP_THREADS: the bundle's rows split between that many
    native calls give the one call's result exactly."""
    from test_torch_region_cleanup import _bundle, _bundle_masks

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
