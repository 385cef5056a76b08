"""The proposal model's family seam (``benchlib/families``): the default
family gives the readings the harness gave before the seam, exactly; a
family added as a file alone runs the harness end to end; an unknown family
stops the set-up; and no shared module of the harness knows a family.

``seam_golden.json`` holds the readings of the harness before the seam, on
the tiny single-crop and crop-layer configurations: one digest of the
program's whole parameter tree, one of the proposal launches with their
count, one of the samples' frames, and the FLOP model. A seeded CPU run of
each is held to the cell's own limits (one thread: the CPU's kernels split
their sums by the thread count; a window long enough to finish the first
cycle, whose images the checks read, on a loaded CPU)."""

import hashlib
import importlib
import json
import os
import re
import sys
import time

import pytest
import torch

import tiny
from benchlib import families, flops, harness
from benchlib.config import load_json, model_settings
from benchlib.families import vitdet
from benchlib.traffic import Stream
from benchlib.weights import cast, clip_tree

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHLIB = os.path.join(os.path.dirname(HERE), "benchlib")
SEED = 2**31 + 29
LIMITS = {multicrop: load_json(f"benchmark/limits/{cell}.json")
          for multicrop, cell in ((False, "refcoco-occupancy"), (True, "phrasecut-grid64"))}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(obj) -> str:
    """sha256[:16] of a parameter tree (every tensor's path, dtype, shape and bytes, in order) or of JSON data."""
    h = hashlib.sha256()

    def walk(tree, path):
        if isinstance(tree, (dict, list)):
            for key, sub in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
                walk(sub, f"{path}/{key}")
            return
        t = tree.detach().cpu().contiguous()
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())

    if isinstance(obj, dict) and all(isinstance(v, (dict, torch.Tensor)) for v in obj.values()):
        walk(obj, "")
    else:
        h.update(json.dumps(obj, sort_keys=True).encode())
    return h.hexdigest()[:16]


def readings(multicrop: bool) -> tuple:
    """(the golden readings, the seeded CPU run's result) of a tiny configuration."""
    cfg = tiny.config(multicrop)
    mix = tiny.mix(stamped=not multicrop)
    s = model_settings(cfg)
    sam, clip = harness.reference_models(cfg, s, SEED, torch.device("cpu"))
    tree = {"sam": cast(s.family.program_tree(sam), torch.bfloat16), "clip": cast(clip_tree(clip), torch.bfloat16)}
    launches = [[f"{h}x{w}", k, sorted(d.items())] for h, w in ((48, 64), (64, 40), (64, 64))
                for k, d in s.family.proposal_launches(s, harness._windows(s, h, w))]
    samples = [[hashlib.sha256(x.image_1024.tobytes()).hexdigest(), x.rh, x.rw]
               for x in Stream(mix, cfg, SEED, s).samples]
    r = harness.run("tiny", SEED, 6.0, False, time.perf_counter(), device="cpu", bench=tiny.bench(),
                    cfg=dict(cfg, compute_dtype="float32"), mix=mix, lims=LIMITS[multicrop])
    assert sorted(harness.LAST["numbers"]) == list(range(mix["cycle"])), "the window must finish the first cycle"
    out = {"tree": digest(tree), "launches": [len(launches), digest(launches)], "samples": digest(samples),
           "flops": {f"{b},{n}": flops.pipeline_flops_per_image(s, b, n) for b, n in ((8, 1), (16, 3))}}
    return json.loads(json.dumps(out)), r


@pytest.mark.parametrize("multicrop", [False, True], ids=["single-crop", "crop-layer"])
def test_the_default_family_keeps_every_reading(multicrop, one_thread):
    with open(os.path.join(HERE, "seam_golden.json")) as f:
        want = json.load(f)["crop-layer" if multicrop else "single-crop"]
    got, r = readings(multicrop)
    for key in ("tree", "launches", "samples", "flops"):
        assert got[key] == want[key], key
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"] and r["failed"] == 0, checks
    assert checks["iou_pred_err"] < 1e-5 and checks["stab_err"] < 1e-5 and checks["gem_err"] < 1e-5, checks


TWIN = '''"""A family for the tests: the ViTDet family with a square frame and no pad."""

import numpy as np
import torch.nn.functional as F
from PIL import Image

from benchlib.families.vitdet import *  # noqa: F401,F403


def frame(spec, image):
    S = spec.img_size
    if isinstance(image, np.ndarray):
        return np.array(Image.fromarray(image).resize((S, S), Image.BILINEAR)), S, S
    x = F.interpolate(image.permute(2, 0, 1)[None].float(), (S, S), mode="bilinear", align_corners=False)
    return x[0].permute(1, 2, 0), S, S
'''


def test_a_family_added_as_a_file_runs_the_harness(tmp_path, monkeypatch, one_thread):
    name = "square_frame_twin"
    (tmp_path / f"{name}.py").write_text(TWIN)
    monkeypatch.setattr(families, "__path__", list(families.__path__) + [str(tmp_path)])
    importlib.invalidate_caches()
    try:
        cfg = dict(tiny.config(), sam_family=name, compute_dtype="float32")
        assert model_settings(cfg).family.__name__ == f"{families.__name__}.{name}"
        S = cfg["sam"]["img_size"]
        frames = Stream(tiny.mix(), cfg, SEED, model_settings(cfg)).samples
        assert {(x.rh, x.rw) for x in frames} == {(S, S)} and any(x.h != x.w for x in frames)
        r = harness.run("tiny", SEED, 4.0, False, time.perf_counter(), device="cpu", bench=tiny.bench(), cfg=cfg,
                        mix=dict(tiny.mix(), check_images=8), lims=LIMITS[False])
        got = {k: v["value"] for k, v in r["checks"].items()}
        assert r["correct"] and r["failed"] == 0, got
        assert got["iou_pred_err"] < 1e-5 and got["stab_err"] < 1e-5 and got["gem_err"] < 1e-5, got
    finally:
        sys.modules.pop(f"{families.__name__}.{name}", None)


@pytest.mark.parametrize("name", ["no_such_family", "../vitdet"])
def test_an_unknown_family_fails_at_set_up(name):
    bench = tiny.bench()
    bench["configs"][-1]["file"] = "benchmark/configs/tiny-unknown-family.json"
    cfg = dict(tiny.config(), sam_family=name)
    with pytest.raises(LookupError) as e:
        harness.run("tiny", SEED, 1.0, False, time.perf_counter(), device="cpu", bench=bench, cfg=cfg, mix=tiny.mix(),
                    lims=tiny.LIMITS)
    msg = str(e.value)
    assert f"{families.__name__}.{name}" in msg and os.path.join("families", f"{name}.py") in msg, msg
    assert "benchmark/configs/tiny-unknown-family.json" in msg, msg


def test_the_default_family():
    assert families.load({}) is vitdet
    for conf in load_json("BENCHMARK.json")["configs"]:
        assert load_json(conf["file"]).get("sam_family", families.DEFAULT) == "vitdet", conf["name"]


@pytest.mark.parametrize("path", sorted(p for p in os.listdir(BENCHLIB) if p.endswith(".py")))
def test_shared_modules_know_no_family(path):
    with open(os.path.join(BENCHLIB, path)) as f:
        text = f.read()
    assert not re.search(r"vitdet", text, re.IGNORECASE)
    assert not re.search(r"benchref\.sam\b|from\s+benchref\s+import\s+[^\n]*\bsam\b", text)
    assert not re.search(r"\b(sam_tree|sam_encoder_flops|sam_decode_flops)\s*\(", text)
