"""Checkpoint forms and stage timing of the port against the JAX package's.

The converter (core/convert.py), the .npz archive (core/checkpoint.py), the
conversion tool and StageTimer (utils/profiling.py) are each held to their
counterpart in hybridgl_tpu on the same synthetic inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from hybridgl_tpu.core import checkpoint as jax_checkpoint
from hybridgl_tpu.core import convert as jax_convert
from hybridgl_tpu.utils.profiling import StageTimer as JaxStageTimer
from hybridgl_tpu_torch.core import checkpoint, convert
from hybridgl_tpu_torch.core.params import from_numpy_tree, init_clip, init_sam
from hybridgl_tpu_torch.utils.profiling import StageTimer, capture_trace, trace_span

from torch_port_config import to_port
from torch_ref import make_tiny_clip
from torch_ref_sam import make_tiny_sam


def _paths(tree, prefix=""):
    """{'/'-joined path: numpy leaf} of a dict/list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) if isinstance(tree, (list, tuple)) else None
    if items is None:
        return {prefix[:-1]: np.asarray(tree)}
    for k, v in items:
        out.update(_paths(v, f"{prefix}{k}/"))
    return out


def _assert_trees_equal(got, want, ordered=True):
    got, want = _paths(got), _paths(want)
    if ordered:
        assert list(got) == list(want)  # the same keys in the same order
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def state_dicts():
    clip_model, clip_cfg = make_tiny_clip()
    sam_model, sam_cfg = make_tiny_sam()
    return clip_model.openai_state_dict(), clip_cfg, sam_model.state_dict_upstream(), sam_cfg


def test_convert_clip_equals_reference(state_dicts):
    sd, cfg, _, _ = state_dicts
    _assert_trees_equal(convert.convert_clip(sd, to_port(cfg)), jax_convert.convert_clip(sd, cfg))
    _assert_trees_equal(convert.convert_clip(sd), jax_convert.convert_clip(sd))  # config inferred


def test_convert_sam_equals_reference(state_dicts):
    _, _, sd, cfg = state_dicts
    _assert_trees_equal(convert.convert_sam(sd, to_port(cfg)), jax_convert.convert_sam(sd, cfg))


def test_infer_clip_config_equals_reference(state_dicts):
    sd, _, _, _ = state_dicts
    got = convert.infer_clip_config(convert.normalize_state_dict(sd))
    want = jax_convert.infer_clip_config(jax_convert.normalize_state_dict(sd))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__module__.startswith("hybridgl_tpu_torch.")


@pytest.mark.parametrize("depth,width", [(12, 768), (24, 1024), (32, 1280)])
def test_infer_sam_config_equals_reference(depth, width):
    """The three published SAM sizes, recognised from key names and one shape alone."""
    sd = {f"image_encoder.blocks.{i}.norm1.weight": np.zeros(1, np.float32) for i in range(depth)}
    sd["image_encoder.patch_embed.proj.weight"] = np.zeros((width, 3, 1, 1), np.float32)
    got, want = convert.infer_sam_config(sd), jax_convert.infer_sam_config(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.encoder_depth, got.encoder_width) == (depth, width)


def test_converted_tree_matches_init_layout(state_dicts):
    """The converter's tree has the keys and shapes of the port's own init, so
    every forward pass takes it."""
    sd_clip, clip_cfg, sd_sam, sam_cfg = state_dicts
    gen = torch.Generator().manual_seed(0)
    for got, want in (
        (convert.convert_clip(sd_clip, to_port(clip_cfg)), init_clip(gen, to_port(clip_cfg))),
        (convert.convert_sam(sd_sam, to_port(sam_cfg)), init_sam(gen, to_port(sam_cfg))),
    ):
        got, want = _paths(from_numpy_tree(got)), _paths(want)
        assert sorted(got) == sorted(want)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_load_torch_checkpoints_from_files(state_dicts, tmp_path):
    sd_clip, clip_cfg, sd_sam, sam_cfg = state_dicts
    torch.save(sd_clip, str(tmp_path / "clip.pt"))
    torch.save(sd_sam, str(tmp_path / "sam.pth"))
    got, cfg = convert.load_torch_clip(str(tmp_path / "clip.pt"))
    want, want_cfg = jax_convert.load_torch_clip(str(tmp_path / "clip.pt"))
    _assert_trees_equal(got, want)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    # the tiny SAM is no published size: the caller names its config
    got, cfg = convert.load_torch_sam(str(tmp_path / "sam.pth"), to_port(sam_cfg))
    _assert_trees_equal(got, jax_convert.convert_sam(sd_sam, sam_cfg))
    assert cfg == to_port(sam_cfg)
    with pytest.raises(KeyError):
        convert.load_torch_sam(str(tmp_path / "sam.pth"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_round_trip(state_dicts, tmp_path, writer):
    """save -> load gives the tree back; an archive written by either package
    reads the same through both."""
    _, _, sd, cfg = state_dicts
    tree = convert.convert_sam(sd, to_port(cfg))
    path = str(tmp_path / "sub" / "sam.npz")
    (checkpoint.save if writer == "port" else jax_checkpoint.save)(path, tree)
    # the reference's writer sorts the keys; the port's keeps the tree's order
    _assert_trees_equal(checkpoint.load(path), tree, ordered=writer == "port")
    _assert_trees_equal(checkpoint.load(path), jax_checkpoint.load(path))
    assert checkpoint._unflatten(checkpoint._flatten(tree)).keys() == tree.keys()


def test_npz_save_takes_tensor_leaves(tmp_path):
    """A tree of tensors (bf16 included) is stored as f32 and reads back equal."""
    tree = {"a": [torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), torch.tensor([1, 2], dtype=torch.int32)],
            "b": {"c": torch.tensor(0.5)}}
    path = str(tmp_path / "t.npz")
    checkpoint.save(path, tree)
    got = checkpoint.load(path)
    assert got["a"][0].dtype == np.float32 and got["a"][1].dtype == np.int32
    np.testing.assert_array_equal(got["a"][0], np.arange(6, dtype=np.float32).reshape(2, 3))
    assert float(got["b"]["c"]) == 0.5


@pytest.mark.parametrize("fn", ["save", "load"])
def test_orbax_directory_is_refused(tmp_path, fn):
    with pytest.raises(ValueError, match="does not read orbax directories"):
        if fn == "save":
            checkpoint.save(str(tmp_path / "ckpt_dir"), {"a": np.zeros(1)})
        else:
            checkpoint.load(str(tmp_path / "ckpt_dir"))


def test_convert_tool(state_dicts, tmp_path, capsys):
    from hybridgl_tpu_torch.tools import convert_checkpoints

    sd_clip, clip_cfg, _, _ = state_dicts
    src = str(tmp_path / "tiny_clip.pt")
    torch.save(sd_clip, src)
    convert_checkpoints.main(["--clip", src, "--out-dir", str(tmp_path / "out")])
    assert f"CLIP ({clip_cfg.vision_layers} blocks, width {clip_cfg.vision_width})" in capsys.readouterr().out
    _assert_trees_equal(checkpoint.load(str(tmp_path / "out" / "tiny_clip.npz")), jax_convert.convert_clip(sd_clip))
    with pytest.raises(SystemExit):
        convert_checkpoints.main(["--out-dir", str(tmp_path)])


def test_stage_timer_summary_equals_reference():
    """The same totals and counts print the same table, line for line."""
    got, want = StageTimer(), JaxStageTimer()
    for name, total, count in (("proposals", 1.25, 3), ("crops+fusion", 0.5, 3), ("sentence_stage", 2.0, 7),
                               ("parse+tokenize", 0.0004, 3), ("small_region_cleanup", 0.0, 0)):
        for t in (got, want):
            t.totals[name] += total
            t.counts[name] += count
    assert got.summary() == want.summary()
    assert StageTimer().summary() == JaxStageTimer().summary()  # the empty table: the header alone


@pytest.mark.parametrize("block", [False, True])
def test_stage_timer_span_accumulates(block):
    """On the CPU block=True has nothing to wait for and must not raise."""
    t = StageTimer(block=block, device="cpu")
    for _ in range(3):
        with t.span("a"):
            pass
    with t.span("b"):
        pass
    assert t.counts == {"a": 3, "b": 1} and t.totals["a"] >= 0.0


def test_trace_span_and_capture_trace(tmp_path):
    with capture_trace(None):  # no directory: nothing written
        pass
    with capture_trace(str(tmp_path / "trace")):
        with trace_span("stage_under_test"):
            torch.ones(4).sum()
    assert "stage_under_test" in (tmp_path / "trace" / "trace.json").read_text()


@pytest.mark.parametrize("entry", ["run_image", "run_dataset"])
def test_pipeline_timer_records_reference_stage_names(entry):
    """A tiny-config run with a timer records the reference's stage names for
    that entry point (hybridgl_tpu/pipeline/runner.py), and none without one."""
    from hybridgl_tpu_torch.core.config import tiny_smoke_config
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline, ImageSample

    cfg = tiny_smoke_config(min_mask_region_area=4)
    gen = torch.Generator().manual_seed(0)
    pipe = HybridGLPipeline(cfg, init_sam(gen, cfg.sam), init_clip(gen, cfg.clip), device="cpu")
    rng = np.random.default_rng(0)
    C, S = cfg.canonical_size, cfg.sam.img_size
    sample = ImageSample(
        image_1024=rng.integers(0, 255, (S, S, 3)).astype(np.uint8), rh=S, rw=S,
        image_canonical=rng.integers(0, 255, (C, C, 3)).astype(np.uint8), h=C, w=C,
        gt_mask=rng.random((C, C)) > 0.5, sentences=("the left square", "a thing"),
    )
    assert pipe.timer is None
    pipe.timer = StageTimer(block=True, device="cpu")
    state = pipe.init_state()
    if entry == "run_image":
        pipe.run_image(sample, state)
        first = "proposals"
    else:
        list(pipe.run_dataset([sample, sample], state))
        first = "proposals_dispatch"
    n = 1 if entry == "run_image" else 2
    assert pipe.last_proposals.num > 0
    assert dict(pipe.timer.counts) == {
        first: n, "small_region_cleanup": n, "crops+fusion": n, "parse+tokenize": n, "sentence_stage": 2 * n,
    }
