"""The yardstick's arithmetic: the FLOP model, the kernel work, the idle
share, and the BENCHMARK.json file's names and keys."""

import json
import os
import re

import pytest

from benchlib import flops, kernels, trace
from benchlib.config import REPO, benchmark_file, load_json, model_settings

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def settings(name):
    return model_settings(load_json(f"benchmark/configs/{name}.json"))


@pytest.mark.parametrize("config,sentences,tflop", [("refcoco-samh-clipb16", 2, 6.698),
                                                    ("phrasecut-samh-clipb16", 1, 58.753)])
def test_flop_model_matches_the_audited_counts(config, sentences, tflop):
    total = flops.pipeline_flops_per_image(settings(config), 8, sentences)["total"]
    assert round(total / 1e12, 3) == tflop


SHAPES = [  # PERF.md's kernel table
    ("flash_windowed_fused", dict(BH=400, S=196, hd=80, G=14, esize=2)),
    ("flash_attention_fused", dict(BH=16, S=4096, hd=80, G=64, esize=2)),
    ("flash_attention_rel_pos", dict(BH=16, S=4096, hd=80, G=64, esize=2)),
    ("clip_attention", dict(BH=1536 * 12, S=197, hd=64, N=1536, esize=2)),
    ("pass1_stats_half", dict(B=192, n=256, C=640, dh=480, dw=640, esize=2)),
    ("pass1_stats_half", dict(B=192, n=256, C=1024, dh=321, dw=401, esize=2)),
    ("pass1_stats", dict(B=48, n=256, n2=256, C=1024, dh=451, dw=633, esize=2)),
    ("i2t_ln_then_t2i", dict(B=64, S=4096, C=256, Cq=128, GT=64, shared=True, esize=2)),
    ("i2t_ln_then_t2i", dict(B=64, S=4096, C=256, Cq=256, GT=64, shared=False, esize=2)),
    ("i2t_ln_update", dict(B=128, S=4096, C=256, Cq=256, GT=64)),
    ("t2i_ctx", dict(B=128, S=4096, C=256, Cq=256, GT=64)),
    ("upscale_hyper_blocked", dict(B=64, S=4096, C=256, c4=64, c8=32, m=3, esize=2)),
    ("nms", dict(N=12288, read_words=12288)),
]


@pytest.mark.parametrize("name,shape", SHAPES)
def test_kernel_work_equals_its_source(name, shape):
    from hybridgl_tpu_torch.tools import check_kernels

    assert kernels.kernel_work(name, **shape) == check_kernels.kernel_work(name, **shape)
    assert kernels.bound_ms(*kernels.kernel_work(name, **shape)) == check_kernels.bound_ms(
        *check_kernels.kernel_work(name, **shape))


@pytest.mark.parametrize("config,counts", [
    ("refcoco-samh-clipb16", {"flash_windowed_fused": 28, "flash_attention_fused": 4, "i2t_ln_then_t2i": 2,
                              "upscale_hyper_blocked": 1, "pass1_stats_half": 1, "nms": 1}),
    ("phrasecut-samh-clipb16", {"flash_windowed_fused": 140, "flash_attention_fused": 20, "i2t_ln_then_t2i": 256,
                                "upscale_hyper_blocked": 129, "pass1_stats_half": 128, "nms": 6,
                                "i2t_ln_update": 2, "t2i_ctx": 3})])
def test_image_launches_match_the_kernel_table(config, counts):
    from benchlib.harness import _windows

    s = settings(config)
    got = {}
    for name, _ in s.family.proposal_launches(s, _windows(s, 480, 640)):
        got[name] = got.get(name, 0) + 1
    assert got == counts
    assert len(kernels.feature_launches(s, 8)) == 15


def test_roofline_is_silent_where_the_trace_is_not_the_model():
    from types import SimpleNamespace

    from benchlib.harness import _windows, read_metric

    s = settings("refcoco-samh-clipb16")
    modelled = kernels.launches_by_label(s.family.proposal_launches(s, _windows(s, 480, 640))
                                         + kernels.feature_launches(s, 8))
    assert modelled == {"K1 flash_windowed_fused": 28, "K2 flash_attention_fused": 4, "K3/K7/K8 decoder attention": 2,
                        "K3/K8 t2i_combine": 2, "K4 upscale_hyper_blocked": 1, "K5 pass1_stats_half": 1,
                        "N1 nms": 2, "K6 clip_attention": 15}
    assert set(modelled) <= {label for _, label in trace.OWN_KERNELS}
    run = SimpleNamespace(tail=dict(own_ms=4.0, bound_ms=1.0, launches_match=True))
    assert read_metric("kernels_roofline", run) == 25.0
    run.tail["launches_match"] = False
    assert read_metric("kernels_roofline", run) is None


def test_idle_arithmetic_on_synthetic_intervals():
    items = [{"ts": 0.0, "dur": 10.0}, {"ts": 5.0, "dur": 10.0}, {"ts": 30.0, "dur": 5.0}, {"ts": 31.0, "dur": 1.0}]
    assert trace.busy_ms(items) == pytest.approx(0.020)
    spans = [{"ts": 14.0, "dur": 20.0, "name": "small_region_cleanup"}, {"ts": 0.0, "dur": 100.0, "name": "finish"}]
    gaps = trace.idle_gaps(items, spans, 0.0, 50.0)
    assert [(a, b, label) for a, b, label in gaps] == [(15.0, 15.0, "cleanup"), (35.0, 15.0, "wait")]
    br = trace.breakdown([dict(e, name="resident_kernel<80, 0>") for e in items], gaps)
    assert br["device_ops"][0][0].startswith("K1 ") and br["idle_gaps"][0] == ["cleanup", 15e-6]


def test_benchmark_file_names_units_and_keys():
    b = benchmark_file()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]] + [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(REPO, "benchmark", "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(REPO, "benchmark", "limits", f"{w['name']}.json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", f"{m['name']}.py"))
    assert len(json.dumps(b)) < 64 * 1024
