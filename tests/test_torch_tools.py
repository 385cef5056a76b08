"""The port's tools (hybridgl_tpu_torch/tools/) as far as they run on the CPU:
``compare_parity`` on two logs, ``flops_audit`` at its small geometry (the
analytic FLOP model within 10% of PyTorch's operator count, stage by stage,
as tests/test_flops_audit.py holds the reference's model to XLA's count),
``bench.py``'s record function on a fake timing dict, ``profile_trace --parse``
on a written trace, ``probe_dp_cleanup`` at a small size, the dry run's
``entry()`` and ``dryrun_multichip(4)`` over gloo, and the refusal of the
card tools without a card.
"""

import json

import pytest
import torch

from hybridgl_tpu_torch.eval.parity import ParityLog, SelectionRecord
from hybridgl_tpu_torch.tools import bench, compare_parity, dryrun, flops_audit, probe_dp_cleanup, profile_trace

def skip_with_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card refusal")


def test_compare_parity_on_two_logs(tmp_path, capsys):
    a, b = ParityLog(meta={"run": "a"}), ParityLog(meta={"run": "b"})
    for i in range(4):
        a.add(SelectionRecord(i, f"sentence {i}", i, i + 1, 0.5, 0.6))
        b.add(SelectionRecord(i, f"sentence {i}", i, i + 1 if i != 2 else 7, 0.5, 0.6))
    b.add(SelectionRecord(9, "only in b", 0, 0, 0.0, 0.0))
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    a.save(pa)
    b.save(pb)
    assert compare_parity.main([pa, pb]) == 0
    out = capsys.readouterr().out
    assert "compared 4 (ref, sentence) pairs" in out
    assert "pure-selection agreement:  100.00%" in out and "final-selection agreement: 75.00%" in out
    assert "diff: (2, 'sentence 2', 3, 7)" in out
    assert compare_parity.main([pa]) == 2


def test_flops_audit_small_geometry(capsys):
    """Every stage of utils/flops.py within 10% of FlopCounterMode's count on the plain versions."""
    results = flops_audit.run_audit(flops_audit.small_config(), tol=0.10, verbose=False, device="cpu")
    assert {r["stage"] for r in results} == {"sam_encoder", "sam_decode", "clip_fusion", "gem", "text"}
    bad = [r for r in results if not r["ok"]]
    assert not bad, f"FLOP model out of tolerance: {bad}"
    assert all(r["counted_gf"] > 0 for r in results)
    dec = next(r for r in results if r["stage"] == "sam_decode")
    assert dec["canonical_gf"] > 0
    assert flops_audit.main(["--device", "cpu", "--small", "--tol", "0.001"]) == 1  # a failed audit is a failed run
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["audit_ok"] is False


def test_flops_audit_refuses_without_a_card(capsys):
    skip_with_a_card()
    assert flops_audit.main(["--small"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA card"):
        flops_audit.run_audit(flops_audit.small_config(), tol=0.10, verbose=False)


def test_bench_record_from_fake_timing():
    flops = {"total": 4.0e12, "sam_encoder": 3e12}
    timing = dict(rates=[5.0, 7.0, 6.0], realistic_rates=[4.0, 3.0, 5.0], device_ms=80.0,
                  stage_device_ms={"proposal": 50.04, "feature": 20.0, "sentence": 9.96},
                  multicrop={"value": 0.5, "unit": "img/s"}, proposals_scored=8)
    rec = bench.build_record(timing, flops, 989e12, "NVIDIA H100 80GB HBM3", 700.0)
    assert list(rec)[:5] == ["metric", "value", "unit", "device", "power_limit_w"]
    assert rec["metric"] == "e2e_images_per_sec_per_chip" and rec["value"] == 6.0 and rec["unit"] == "img/s"
    assert rec["realistic_survival_img_per_s"] == 4.0 and rec["device_ms_per_img"] == 80.0
    assert rec["stage_device_ms"] == {"proposal": 50.0, "feature": 20.0, "sentence": 10.0}
    assert rec["flops_per_img_t"] == 4.0
    assert rec["est_mfu_e2e"] == round(6.0 * 4.0e12 / 989e12, 4) and rec["est_mfu_device"] == round(4.0e12 / 0.08 / 989e12, 4)
    assert rec["multicrop"] == {"value": 0.5, "unit": "img/s"} and "vs_baseline" not in rec
    json.dumps(rec)
    bare = bench.build_record({"rates": [2.0]}, flops, None, "another card", None)
    assert "est_mfu_e2e" not in bare and "device_ms_per_img" not in bare and bare["value"] == 2.0
    assert bench.parse_power_limit("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0
    assert bench.parse_power_limit("") is None
    assert bench.SURVIVAL == [21, 7, 33, 12, 48, 3, 17, 26]


def test_profile_trace_parse(tmp_path, capsys):
    events = [
        {"ph": "X", "cat": "kernel", "name": "hgl_decoder_attn", "dur": 3000},
        {"ph": "X", "cat": "kernel", "name": "gemm", "dur": 1500},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "dur": 6000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99999},
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    out = profile_trace.parse(str(tmp_path), calls=3)
    assert out["total_ms_per_call"] == pytest.approx(3.5)
    assert out["by_category"] == {"kernel": 4.5, "gpu_memcpy": 6.0}
    text = capsys.readouterr().out
    assert text.index("Memcpy DtoH") < text.index("hgl_decoder_attn") < text.index("gemm")
    with pytest.raises(SystemExit, match="no trace.json"):
        profile_trace.parse(str(tmp_path / "missing"))


def test_probe_dp_cleanup_small():
    lines = []
    times = probe_dp_cleanup.probe(world=2, P=4, hw=(240, 320), log=lines.append)
    assert set(times) == {"one_image", "serial", "pooled", "overlapped"} and all(t > 0 for t in times.values())
    assert any("equal the serial ones" in line for line in lines)


def test_dryrun_entry_on_cpu():
    fn, args = dryrun.entry("cpu", clip_model="test-tiny")
    with torch.inference_mode():
        out = fn(*args)
    assert out.shape == (8, 24) and bool(torch.isfinite(out).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            dryrun.entry()


def test_dryrun_multichip_four_ranks_on_cpu(capsys):
    """The three passes (2 x 2 mesh with the sticky replay, dp = 4 with ragged
    sentence counts, multicrop) and the tensor-parallel encoder, over gloo."""
    r = dryrun.dryrun_multichip(4, "cpu", timeout=120.0)
    assert r["mesh"] == {"dp": 2, "mp": 2} and r["sentences"] == 4 and r["ragged_sentences"] == 6
    assert r["multicrop_sentences"] == 4 and r["tp_max_abs_diff"] < 2e-4
    assert r["cum_u"] >= r["cum_i"] > 0
    assert "dryrun_multichip OK: 4 ranks on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("tool", ["bench", "profile_proposals", "profile_multicrop", "device_time", "dispatch_cost",
                                  "export_serving"])
def test_card_tools_refuse_without_a_card(tool, capsys):
    import importlib

    skip_with_a_card()

    main = importlib.import_module(f"hybridgl_tpu_torch.tools.{tool}").main
    try:
        code = main([])
    except SystemExit as e:
        code = e.code
    assert code not in (0, None)
    assert "no CUDA card" in capsys.readouterr().err


def test_profile_trace_capture_and_dryrun_refuse_without_a_card(tmp_path):
    skip_with_a_card()
    with pytest.raises(SystemExit):
        profile_trace.main(["--out", str(tmp_path / "t")])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun.dryrun_multichip(2)


def test_dispatch_cost_inputs_run_each_route_on_cpu():
    """The dispatch-cost tool's four kernels at their small shapes: the
    operator and the public wrapper give the CPU implementation's outputs."""
    from hybridgl_tpu_torch.kernels import _ops
    from hybridgl_tpu_torch.tools import dispatch_cost

    gen = torch.Generator().manual_seed(0)
    for name in dispatch_cost.KERNELS:
        args, wrapper = dispatch_cost._inputs(name, torch.device("cpu"), gen)
        direct = _ops.REGISTERED[name].cpu(*args)
        op = getattr(torch.ops.hybridgl, name).default(*args)
        flat = lambda x: list(x) if isinstance(x, tuple) else [x]  # noqa: E731
        assert all(torch.equal(a, b) for a, b in zip(flat(direct), flat(op), strict=True)), name
        got = flat(wrapper())
        if name == "pass1_stats_half":  # the wrapper splits the [2, B, C] flags
            got = [got[0], torch.stack(got[1:])]
        assert all(torch.equal(a, b) for a, b in zip(flat(op), got, strict=True)), name
