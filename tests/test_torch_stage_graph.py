"""The proposal stage as one capturable dispatch (``pipeline/stage_graph.py``,
``models/sam/amg.py:proposal_stage``), on the CPU at test-tiny.

* Against the JAX package: the port's stage with its geometry as tensors
  (the static inputs of a ``StageGraph``) against the reference's
  ``generate_proposals`` and ``generate_proposals_multicrop`` under
  ``jax.jit`` with ``rh, rw, h, w`` traced, as the reference's runner
  compiles its proposal stage once for every image size (runner.py:361), at
  three image sizes a path: landscape, portrait, and one side below half the
  canonical frame. The bar is ``tests/test_torch_multicrop.py``'s.
* Capturability: a dispatch mode records every operator of the stage with
  its shapes, dtypes and non-tensor arguments; images of different sizes
  give the same record (so one CUDA graph serves them all), every tensor an
  operator takes is a named input of the stage (the frames, the geometry
  table, the configuration's constants, the parameters) or made inside it
  from those, and the stage uploads no host array.
* The runner: ``run_dataset`` equal to ``run_image`` over images of mixed
  sizes, single crop and multicrop.
"""

import dataclasses
import functools
import numbers
import sys

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import AmgConfig, GemConfig, PipelineConfig, sam_preset
from hybridgl_tpu.core.params import init_clip, init_sam
from hybridgl_tpu.models.sam import amg as jamg
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.lang import HeuristicParser as PortHeuristicParser
from hybridgl_tpu_torch.models.sam import amg
from hybridgl_tpu_torch.pipeline import runner
from hybridgl_tpu_torch.pipeline.stage_graph import StageGraph
from hybridgl_tpu_torch.utils import transfer

from test_torch_pipeline import WordTokenizer, make_sample
from test_torch_sam import jax_tree, noisy_params
from torch_port_config import to_port
from torch_ref import tiny_clip_config
from torch_ref_sam import tiny_sam_config

CANONICAL = 32
SAM = sam_preset("test-tiny")  # S = 64
AMG_SC = AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                   max_proposals=8)
AMG_MC = AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                   crop_n_layers=1, crop_n_points_downscale_factor=2, min_mask_region_area=0,
                   max_proposals=16, max_candidates_per_crop=16)
# (h, w): landscape, portrait, one side below half the canonical frame
SIZES = [(24, 32), (32, 20), (12, 32)]


def _image(seed, h, w):
    """(padded S x S frame, canonical frame, rh, rw) of a random h x w image."""
    rng = np.random.default_rng(seed)
    S = SAM.img_size
    rh, rw = S * h // max(h, w), S * w // max(h, w)
    img = np.zeros((S, S, 3), np.uint8)
    img[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((CANONICAL, CANONICAL, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    return img, imgc, rh, rw


@functools.lru_cache(maxsize=None)
def _params(seed):
    return noisy_params(SAM, seed)


@functools.lru_cache(maxsize=None)
def _jax_stage(multicrop: bool):
    """The reference's AMG jitted with the image geometry traced: one
    compile serves every image size, as its runner's proposal stage."""
    if multicrop:
        return jax.jit(lambda p, im, rh, rw, imc, h, w: jamg.generate_proposals_multicrop(
            p, im, rh, rw, imc, h, w, SAM, AMG_MC, CANONICAL))
    return jax.jit(lambda p, im, rh, rw, h, w: jamg.generate_proposals(p, im, rh, rw, h, w, SAM, AMG_SC, CANONICAL))


def _port_config(amg_cfg):
    return to_port(PipelineConfig(sam_config=SAM, amg=amg_cfg, canonical_size=CANONICAL))


@pytest.mark.parametrize("multicrop", [False, True], ids=["single_crop", "multicrop"])
@pytest.mark.parametrize("hw", SIZES, ids=["landscape", "portrait", "small"])
def test_stage_with_tensor_geometry_matches_jax_traced(multicrop, hw):
    """Every Proposals field against the reference's traced stage: num,
    overflow, valid, boxes, masks and areas exactly; iou_preds within 1e-4,
    stability 1e-5 and points 1e-4 (tests/test_torch_multicrop.py's bar)."""
    h, w = hw
    params = _params(6 if multicrop else 4)
    img, imgc, rh, rw = _image(h * 100 + w, h, w)
    i32 = jnp.int32
    if multicrop:
        want = _jax_stage(True)(jax_tree(params), jnp.asarray(img), i32(rh), i32(rw), jnp.asarray(imgc), i32(h), i32(w))
    else:
        want = _jax_stage(False)(jax_tree(params), jnp.asarray(img), i32(rh), i32(rw), i32(h), i32(w))
    cfg = _port_config(AMG_MC if multicrop else AMG_SC)
    stage = StageGraph(cfg, from_numpy_tree(params), "cpu")
    got = stage(img, imgc, amg.geometry(rh, rw, h, w, cfg.sam, cfg.amg))
    assert int(got.num) == int(want.num) and int(got.num) > 0
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.iou_preds.numpy(), np.asarray(want.iou_preds), atol=1e-4)
    np.testing.assert_allclose(got.stability.numpy(), np.asarray(want.stability), atol=1e-5)
    np.testing.assert_array_equal(got.boxes_xyxy.numpy(), np.asarray(want.boxes_xyxy))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4)
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.areas.numpy(), np.asarray(want.areas))


class StageRecord(TorchDispatchMode):
    """Records every operator with its argument signature, and every tensor
    an operator takes that is neither a named input of the stage nor made by
    an operator recorded before it (``lift_fresh`` is how a tensor built from
    host data, ``torch.tensor`` or ``torch.as_tensor``, enters)."""

    HOST_DATA = (torch.ops.aten.lift_fresh.default, torch.ops.aten.lift_fresh_copy.default)

    def __init__(self, inputs):
        super().__init__()
        self.known = {id(t): t for t in inputs}
        self.ops, self.foreign = [], []

    @staticmethod
    def _sig(x):
        if isinstance(x, torch.Tensor):
            return ("tensor", tuple(x.shape), x.dtype, x.device.type)
        if isinstance(x, torch.device):
            return ("device", x.type)
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = pytree.tree_flatten((args, kwargs))
        self.ops.append((str(func), [self._sig(x) for x in flat]))
        for x in flat:
            if isinstance(x, torch.Tensor) and id(x) not in self.known:
                self.foreign.append(str(func))
        out = func(*args, **kwargs)
        if func not in self.HOST_DATA:
            for x in pytree.tree_flatten(out)[0]:
                if isinstance(x, torch.Tensor):
                    self.known[id(x)] = x
        else:
            self.foreign.append(str(func))
        return out


def _record(monkeypatch, cfg, params, img, imgc, geo):
    """The stage of one image under :class:`StageRecord`: (record, host arrays uploaded inside)."""
    consts = amg.stage_constants(cfg.sam, cfg.amg, "cpu")
    inputs = [img, imgc, geo, *consts.chunks, *pytree.tree_flatten(params)[0]]
    uploads = []
    real = transfer.upload

    def counting(x, device, dtype=None):
        if not isinstance(x, (numbers.Number, torch.Tensor)):
            uploads.append(type(x).__name__)
        return real(x, device, dtype)

    for name, module in list(sys.modules.items()):
        if name.startswith("hybridgl_tpu_torch") and getattr(module, "upload", None) is real:
            monkeypatch.setattr(module, "upload", counting)
    mode = StageRecord(inputs)
    with mode:
        props = amg.proposal_stage(params, img, imgc, geo, consts, cfg.sam, cfg.amg, cfg.canonical_size)
    monkeypatch.undo()
    return mode, uploads, props


@pytest.mark.parametrize("multicrop", [False, True], ids=["single_crop", "multicrop"])
def test_stage_launches_the_same_operators_for_every_image_size(monkeypatch, multicrop):
    """Three image sizes give one operator record (names, shapes, dtypes,
    non-tensor arguments): what a CUDA graph captures for one image holds
    for all. No tensor enters the stage but its named inputs, and no host
    array is uploaded inside it (the point grids are the configuration's
    constants, made once)."""
    cfg = _port_config(AMG_MC if multicrop else AMG_SC)
    params = from_numpy_tree(_params(6 if multicrop else 4))
    records = []
    for h, w in SIZES:
        img, imgc, rh, rw = _image(h + w, h, w)
        geo = torch.from_numpy(amg.geometry(rh, rw, h, w, cfg.sam, cfg.amg))
        mode, uploads, props = _record(monkeypatch, cfg, params, torch.from_numpy(img), torch.from_numpy(imgc), geo)
        assert uploads == [], uploads
        assert mode.foreign == [], sorted(set(mode.foreign))
        assert int(props.num) > 0
        records.append(mode.ops)
    assert len(records[0]) > 100
    for other in records[1:]:
        assert len(other) == len(records[0])
        diff = [(a, b) for a, b in zip(records[0], other) if a != b]
        assert diff == [], diff[:3]


def test_geometry_table_is_the_reference_traced_arithmetic():
    """The host's geometry rows equal the crops the reference traces: its
    _crop_boxes_layer1 and the long-side-resized extents of its multicrop
    loop (amg.py:423-441), computed in jnp f32 from traced h and w."""
    cfg = _port_config(AMG_MC)
    S = cfg.sam.img_size

    @jax.jit
    def traced(h, w):
        rows = []
        for cy0, cx0, ch, cw in jamg._crop_boxes_layer1(h, w, AMG_MC.crop_overlap_ratio):
            scale = S / jnp.maximum(ch, cw)
            crh = jnp.floor(ch * scale + 0.5).astype(jnp.int32)
            crw = jnp.floor(cw * scale + 0.5).astype(jnp.int32)
            rows.append(jnp.stack([crh.astype(jnp.float32), crw.astype(jnp.float32), cy0, cx0, ch, cw]))
        return jnp.stack(rows)

    for h, w in SIZES + [(480, 640), (640, 427), (333, 500), (1, 1024)]:
        got = amg.geometry(7, 9, h, w, cfg.sam, cfg.amg)
        assert got.dtype == np.float32 and got.shape == (5, 6)
        np.testing.assert_array_equal(got[0], np.float32([7, 9, 0, 0, h, w]))
        np.testing.assert_array_equal(got[1:], np.asarray(traced(jnp.int32(h), jnp.int32(w))))
    assert amg.geometry(7, 9, 24, 32, cfg.sam, dataclasses.replace(cfg.amg, crop_n_layers=0)).shape == (1, 6)


def _port_pipeline(amg_cfg):
    clip_cfg, sam_cfg = tiny_clip_config(), tiny_sam_config()
    cfg = PipelineConfig(clip_config=clip_cfg, sam_config=sam_cfg, fusion_mode="G2L", canonical_size=CANONICAL,
                         crop_size=clip_cfg.image_size, amg=amg_cfg, gem=GemConfig(img_size=32, depth=2))
    cfg = cfg.replace(guidance=cfg.guidance.__class__(masking_block=clip_cfg.vision_layers - 2))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    clip_np, sam_np = to_np(init_clip(keys[0], clip_cfg)), to_np(init_sam(keys[1], sam_cfg))
    return runner.HybridGLPipeline(to_port(cfg), from_numpy_tree(sam_np), from_numpy_tree(clip_np),
                                   parser=PortHeuristicParser(), tokenizer=WordTokenizer(), device="cpu")


@pytest.mark.parametrize("amg_cfg", [dataclasses.replace(AMG_SC, min_mask_region_area=10),
                                     dataclasses.replace(AMG_MC, min_mask_region_area=10)],
                         ids=["single_crop", "multicrop"])
def test_run_dataset_equals_run_image_over_mixed_sizes(amg_cfg):
    """Images of four sizes through run_dataset (image i+1's stage queued
    before image i's cleanup and scoring) and one run_image an image: the
    same bundles, selections, IoUs and accumulators."""
    pipe = _port_pipeline(amg_cfg)
    samples = [make_sample(runner, seed, h=h, w=w) for seed, (h, w) in enumerate(SIZES + [(32, 32)])]
    want_state, got_state = pipe.init_state(), pipe.init_state()
    want = []
    for s in samples:
        results = runner.materialize_results(pipe.run_image(s, want_state))
        want.append((results, pipe.last_proposals))
    got = list(pipe.run_dataset(iter(samples), got_state, yield_props=True))
    assert [s for s, _, _ in got] == samples
    assert any(int(p.num) > 0 for _, p in want)
    for (_, results, props), (want_results, want_props) in zip(got, want):
        assert runner.materialize_results(results) == want_results
        assert int(props.num) == int(want_props.num)
        for name in amg.Proposals._fields[:7]:
            assert torch.equal(getattr(props, name), getattr(want_props, name)), name
    for a, b in ((got_state.pure, want_state.pure), (got_state.final, want_state.final)):
        assert [float(v) for v in a] == [float(v) for v in b]
