"""The port's dataset path: REFER samples, run_dataset, the result log and
the CLI (``python -m hybridgl_tpu_torch.cli.main``) on CPU, against the JAX
package where the two produce the same thing, on the synthetic REFER tree
of tests/test_data_layer.py (two images, one val ref with one sentence).
"""

import json
import os

import numpy as np
import pytest
import torch

from hybridgl_tpu.core.config import AmgConfig, GemConfig, PipelineConfig
from hybridgl_tpu.data.datasets import ReferDataset as JaxReferDataset
from hybridgl_tpu.eval.logging import write_result_log as jax_write_result_log
from hybridgl_tpu.eval.metrics import IoUAccum as JaxIoUAccum
from hybridgl_tpu_torch.cli.main import main as cli_main
from hybridgl_tpu_torch.core.params import init_clip, init_sam
from hybridgl_tpu_torch.data.datasets import ReferDataset, build_image_sample
from hybridgl_tpu_torch.eval.logging import ProgressCheckpoint, write_result_log
from hybridgl_tpu_torch.eval.metrics import IoUAccum
from hybridgl_tpu_torch.lang import HeuristicParser
from hybridgl_tpu_torch.pipeline import runner

from test_data_layer import refer_root  # noqa: F401 (fixture)
from test_torch_pipeline import WordTokenizer, make_sample
from torch_port_config import to_port
from torch_ref import tiny_clip_config
from torch_ref_sam import tiny_sam_config


@pytest.mark.parametrize("split", ["val", "testA"])
def test_refer_dataset_matches_reference(refer_root, split):
    """Same samples, field by field (one with a polygon GT, one with RLE)."""
    want = JaxReferDataset(refer_root, "refcoco", "unc", split, sam_img_size=64, canonical=64)
    got = ReferDataset(refer_root, "refcoco", "unc", split, sam_img_size=64, canonical=64)
    assert got.ref_ids == want.ref_ids and len(got) == len(want) == 1
    a, b = got[0], want[0]
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name
    assert a.gt_mask.any()


def test_build_image_sample_downscales_oversized():
    from hybridgl_tpu.data.datasets import build_image_sample as jax_build

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (200, 100, 3), np.uint8)
    gt = np.zeros((200, 100), bool)
    gt[50:100] = True
    a, b = build_image_sample(img, ["x"], gt, 64, 128), jax_build(img, ["x"], gt, 64, 128)
    assert (a.h, a.w, a.rh, a.rw) == (b.h, b.w, b.rh, b.rw) == (128, 64, 64, 32)
    for name in ("image_1024", "image_canonical", "gt_mask"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.fixture(scope="module")
def port_pipeline():
    clip_cfg, sam_cfg = tiny_clip_config(), tiny_sam_config()
    cfg = PipelineConfig(
        clip_config=clip_cfg, sam_config=sam_cfg, fusion_mode="G2L", canonical_size=32,
        crop_size=clip_cfg.image_size,
        amg=AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                      max_proposals=8),
        gem=GemConfig(img_size=32, depth=2),
    )
    cfg = to_port(cfg.replace(guidance=cfg.guidance.__class__(masking_block=clip_cfg.vision_layers - 2)))
    g = torch.Generator().manual_seed(0)
    return runner.HybridGLPipeline(cfg, init_sam(g, cfg.sam), init_clip(g, cfg.clip), parser=HeuristicParser(),
                                   tokenizer=WordTokenizer(), device="cpu")


def test_run_dataset_matches_run_image(port_pipeline):
    """The software-pipelined iteration gives run_image's results image by
    image (as tests/test_run_dataset.py for the reference)."""
    samples = [make_sample(runner, seed) for seed in (0, 1, 2)]
    state_a = port_pipeline.init_state()
    seq = [(runner.materialize_results(port_pipeline.run_image(s, state_a)), port_pipeline.last_proposals)
           for s in samples]
    state_b = port_pipeline.init_state()
    piped = list(port_pipeline.run_dataset(iter(samples), state_b, yield_props=True))
    assert len(piped) == len(seq) == 3
    for (results_a, props_a), (sample, results_b, props_b), s in zip(seq, piped, samples):
        assert sample is s
        assert runner.materialize_results(results_b) == results_a
        assert torch.equal(props_a.masks, props_b.masks) and props_a.num == props_b.num
    assert (state_a.k1, state_a.k2) == (state_b.k1, state_b.k2)
    for x, y in zip((*state_a.pure, *state_a.final), (*state_b.pure, *state_b.final)):
        assert float(x) == float(y)
    assert int(state_b.final.count) == 9


def test_write_result_log_byte_identical(tmp_path):
    """The reference's format, byte for byte, for the same accumulators;
    appended, not overwritten."""
    pure, final = (1234.0, 5678.0, 3.25, 7.0), (2345.0, 5678.0, 4.5, 7.0)
    args = ("refcoco", "val", "unc", "G2L")
    for _ in range(2):
        jax_write_result_log(str(tmp_path / "jax"), *args, JaxIoUAccum(*pure), JaxIoUAccum(*final), echo=False)
        write_result_log(str(tmp_path / "port"), *args, IoUAccum(*map(torch.tensor, pure)),
                         IoUAccum(*map(torch.tensor, final)), echo=False)
    a = (tmp_path / "port" / "result_log_refcoco_val.txt").read_bytes()
    b = (tmp_path / "jax" / "result_log_refcoco_val.txt").read_bytes()
    assert a == b and a.count(b"pure hybridgl:") == 2


def test_progress_checkpoint_roundtrip(tmp_path):
    state = runner.PipelineState(3, 6, IoUAccum(*map(torch.tensor, (1.0, 2.0, 0.5, 1.0))), IoUAccum.zeros())
    ckpt = ProgressCheckpoint(str(tmp_path / "progress.json"))
    ckpt.save(4, state)
    fresh = runner.PipelineState(9, 9, IoUAccum.zeros(), IoUAccum.zeros())
    assert ckpt.load(fresh) == 5
    assert (fresh.k1, fresh.k2) == (3, 6)
    assert [float(v) for v in fresh.pure] == [1.0, 2.0, 0.5, 1.0]
    assert all(isinstance(v, torch.Tensor) for v in fresh.final)
    assert ProgressCheckpoint(None).load(fresh) == 0


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "refcoco", "--split", "testA", "--fusion_mode", "L2G", "--num-gpus", "8", "--config-file", "c.yaml"],
    ["--dataset", "phrasecut", "--split", "test", "--max_proposals", "32", "--no-bug-compat"],
    ["--clip_model", "test-tiny", "--sam_model", "test-tiny", "--fusion_mode", "attn_masking"],
])
def test_cli_flags_and_config_match_reference(argv):
    """The reference's flag surface and build_config, exactly; the port
    adds --device and the three settings it derives from the CLIP tower
    unless named (--crop_size, --masking_block, --gem_img_size), which at
    their defaults give the reference's config."""
    from hybridgl_tpu.cli.main import build_config as jax_build_config
    from hybridgl_tpu.cli.main import default_argument_parser as jax_parser
    from hybridgl_tpu_torch.cli.main import build_config, default_argument_parser

    a, b = default_argument_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert (a.device, a.crop_size, a.masking_block, a.gem_img_size) == ("cuda", 0, -1, 0)
    port_only = {k: vars(a).pop(k) for k in ("device", "crop_size", "masking_block", "gem_img_size")}
    assert vars(a) == vars(b)
    vars(a).update(port_only)
    assert build_config(a) == to_port(jax_build_config(b)) and a.splitBy == b.splitBy


def tiny_cli_args(refer_root, tmp_path, *extra):
    return [
        "--dataset", "refcoco", "--split", "val", "--fusion_mode", "G2L", "--refer_data_root", refer_root,
        "--clip_model", "test-tiny", "--sam_model", "test-tiny", "--random-weights", "--device", "cpu",
        "--log_dir", str(tmp_path / "logs"), *extra,
    ]


def test_cli_end_to_end(refer_root, tmp_path, monkeypatch):
    """The port's CLI on CPU runs the synthetic set to the end: both result
    rows, one parity record per sentence, the progress file, the overlays
    and a profiler trace that names the stage spans."""
    monkeypatch.chdir(tmp_path)
    parity, progress = str(tmp_path / "parity.json"), str(tmp_path / "progress.json")
    cli_main(tiny_cli_args(refer_root, tmp_path, "--parity_log", parity, "--progress_file", progress,
                           "--show_results", "--trace_dir", str(tmp_path / "trace")))
    text = (tmp_path / "logs" / "result_log_refcoco_val.txt").read_text()
    assert "fusion_mode=G2L" in text and "Dataset: refcoco / val / unc" in text
    assert "pure hybridgl:" in text and "hybridgl w/ spatial guidance:" in text
    with open(parity) as f:
        log = json.load(f)
    assert [r["sentence"] for r in log["records"]] == ["the left square"]
    assert log["records"][0]["ref_id"] == 101
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert all(f'"{name}"' in trace for name in ("proposals_dispatch", "host_wait", "crops+fusion", "sentence_stage"))
    if log["records"][0]["final_index"] >= 0:
        assert len(os.listdir(tmp_path / "logs" / "results_viz")) == 1


@pytest.mark.parametrize("extra,error,match", [
    (("--data_parallel",), SystemExit, "--sam_checkpoint and --clip_checkpoint are required"),
    (("--sam_checkpoint", "ckpts/sam_orbax", "--clip_checkpoint", "ckpts/clip_orbax"), SystemExit,
     "does not read orbax directories"),
])
def test_cli_unported_options_raise(refer_root, tmp_path, extra, error, match):
    """What the port does not take stops the run with its reason: the
    reference's orbax checkpoint directories; and ``--data_parallel``, which
    is ported (tests/test_torch_full_eval.py), stops like the sequential run
    where no weights are named, leaving no process group behind."""
    args = [a for a in tiny_cli_args(refer_root, tmp_path) if a != "--random-weights"]
    with pytest.raises(error, match=match):
        cli_main(args + list(extra))
    assert not torch.distributed.is_initialized()


def test_cli_loads_torch_checkpoints(refer_root, tmp_path, monkeypatch, capsys):
    """--sam_checkpoint/--clip_checkpoint take synthetic .pth/.pt state dicts
    (written with torch.save in the published layouts) through the converter:
    load_params gives the converter's tree, and the run reaches its end."""
    import argparse

    from hybridgl_tpu_torch.cli.main import load_params
    from hybridgl_tpu_torch.core.config import tiny_smoke_config
    from torch_ref import make_tiny_clip
    from torch_ref_sam import make_tiny_sam

    clip_model, _ = make_tiny_clip()
    sam_model, _ = make_tiny_sam()
    sam_path, clip_path = str(tmp_path / "sam.pth"), str(tmp_path / "clip.pt")
    torch.save(sam_model.state_dict_upstream(), sam_path)
    torch.save(clip_model.openai_state_dict(), clip_path)
    ns = argparse.Namespace(random_weights=False, sam_checkpoint=sam_path, clip_checkpoint=clip_path)
    sam, clip = load_params(ns, tiny_smoke_config(), torch.device("cpu"))
    assert clip["visual"]["conv1"].dtype == torch.bfloat16 and clip["logit_scale"].dtype == torch.float32
    want = clip_model.token_embedding.weight.detach().to(torch.bfloat16)
    assert torch.equal(clip["text"]["token_embedding"], want)
    want = sam_model.state_dict_upstream()["image_encoder.blocks.0.attn.qkv.weight"].detach().T.to(torch.bfloat16)
    assert torch.equal(sam["encoder"]["blocks"][0]["attn"]["qkv_w"], want)

    monkeypatch.chdir(tmp_path)
    args = [a for a in tiny_cli_args(refer_root, tmp_path) if a != "--random-weights"]
    cli_main(args + ["--sam_checkpoint", sam_path, "--clip_checkpoint", clip_path])
    assert "done: 1 images" in capsys.readouterr().out


def test_cli_profile_prints_stage_summary(refer_root, tmp_path, monkeypatch, capsys):
    """--profile prints StageTimer.summary() under the reference's stage names
    (run_dataset's: proposals_dispatch, crops+fusion, parse+tokenize,
    sentence_stage), then the operator table."""
    monkeypatch.chdir(tmp_path)
    cli_main(tiny_cli_args(refer_root, tmp_path, "--profile"))
    out = capsys.readouterr().out
    header = f"{'stage':<24}{'total_s':>10}{'calls':>8}{'avg_ms':>10}{'pct':>7}"
    assert header in out
    table = out[out.index(header):]
    for stage in ("proposals_dispatch", "crops+fusion", "parse+tokenize", "sentence_stage"):
        assert any(line.startswith(stage) for line in table.splitlines()), stage
    assert table.index("sentence_stage") < table.index("Self CPU")  # the operator table comes after


def test_cli_without_card_refuses_cuda(refer_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card refusal")
    args = tiny_cli_args(refer_root, tmp_path)
    args[args.index("cpu")] = "cuda"
    with pytest.raises(SystemExit, match="no CUDA card"):
        cli_main(args)


def test_cli_loads_reference_npz(refer_root, tmp_path):
    """--sam_checkpoint/--clip_checkpoint take the reference's converted .npz
    layout: the JAX package's tiny params saved by core/checkpoint.save."""
    import jax

    from hybridgl_tpu.core import checkpoint
    from hybridgl_tpu.core.config import tiny_smoke_config
    from hybridgl_tpu.core.params import init_clip as jax_init_clip, init_sam as jax_init_sam
    from hybridgl_tpu_torch.core.checkpoint import load as load_npz
    from hybridgl_tpu_torch.core.params import from_numpy_tree

    cfg = tiny_smoke_config()
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    sam, clip = jax_init_sam(k1, cfg.sam), jax_init_clip(k2, cfg.clip)
    checkpoint.save(str(tmp_path / "sam.npz"), sam)
    checkpoint.save(str(tmp_path / "clip.npz"), clip)
    loaded = from_numpy_tree(load_npz(str(tmp_path / "clip.npz")))
    want = jax.tree_util.tree_leaves(clip)
    got = [loaded]
    flat = []
    while got:  # the same leaves in the same order
        x = got.pop(0)
        if isinstance(x, dict):
            got = [x[k] for k in sorted(x)] + got
        elif isinstance(x, list):
            got = list(x) + got
        else:
            flat.append(x)
    assert len(flat) == len(want)
    for a, b in zip(flat, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    args = [a for a in tiny_cli_args(refer_root, tmp_path) if a != "--random-weights"]
    cli_main(args + ["--sam_checkpoint", str(tmp_path / "sam.npz"), "--clip_checkpoint", str(tmp_path / "clip.npz")])
    assert "pure hybridgl:" in (tmp_path / "logs" / "result_log_refcoco_val.txt").read_text()


def test_demo_end_to_end(tmp_path):
    from PIL import Image

    from hybridgl_tpu_torch.cli.demo import main as demo_main

    img_path, out = str(tmp_path / "img.jpg"), str(tmp_path / "result.jpg")
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (48, 64, 3), np.uint8)).save(img_path)
    demo_main(["--img_path", img_path, "--ref_text", "the thing on the left", "--clip_model", "test-tiny",
               "--sam_model", "test-tiny", "--random-weights", "--device", "cpu", "--out", out])
    assert os.path.exists(out)
