"""Reading a torch.profiler trace: device items, busy time, idle gaps and
their host spans, the port's own kernels; and the reads-and-syncs counting.

``busy_ms`` and the two counting modes are frozen copies of the measured
program's ``tools/device_time.py`` (``busy_ms``, ``host_reads``,
``host_syncs``), reduced to counting.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import warnings

import torch

# substrings of the port's own kernels' names, and the kernel ids of PERF.md's table
OWN_KERNELS = (("resident_kernel<80", "K1 flash_windowed_fused"), ("resident_kernel<64", "K6 clip_attention"),
               ("rel_pos_stream_kernel", "K2 flash_attention_fused"), ("pass1_stats", "K5 pass1_stats_half"),
               ("decoder_attn", "K3/K7/K8 decoder attention"), ("t2i_combine", "K3/K8 t2i_combine"),
               ("upscale_hyper", "K4 upscale_hyper_blocked"), ("nms_", "N1 nms"),
               ("attention_kernel", "K1/K2/K6 CUDA-core attention"))
# the host spans that label idle gaps: the program's StageTimer spans and the harness's own
SPAN_LABELS = {"proposals_dispatch": "dispatch", "finish": "wait", "small_region_cleanup": "cleanup",
               "crops+fusion": "feature", "sentence_stage": "sentence", "materialize": "materialize",
               "parse+tokenize": "sentence"}


def own_kernel(name: str):
    """The kernel id label of one of the port's own kernels, None for any other."""
    for key, label in OWN_KERNELS:
        if key in name:
            return label
    return None


def events(prof) -> list:
    """Every event of the exported trace (the device items carry their byte counts there alone)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_items(evs) -> list:
    return [e for e in evs if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_ms(items) -> float:
    """The union of the device items' intervals, ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in items)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def idle_gaps(items, spans, t0: float, t1: float) -> list:
    """[(start us, length us, label)] of the device's idle intervals in [t0, t1],
    each labelled by the innermost host span open at its start."""
    merged, end = [], t0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in items):
        if a > end:
            merged.append((end, a))
        end = max(end, b)
    if t1 > end:
        merged.append((end, t1))
    out = []
    for a, b in merged:
        label, depth = "other", -1.0
        for s in spans:
            if s["ts"] <= a < s["ts"] + s["dur"] and s["ts"] > depth:
                label, depth = SPAN_LABELS[s["name"]], s["ts"]
        out.append((a, b - a, label))
    return out


def host_spans(evs) -> list:
    return [e for e in evs if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in SPAN_LABELS]


def breakdown(items, gaps, top: int = 10) -> dict:
    """The device operations that took most time (own kernels labelled by
    their ids) and the idle time by host span, seconds."""
    ops = collections.defaultdict(float)
    for e in items:
        label = own_kernel(e["name"])
        ops[f"{label}: {e['name'][:60]}" if label else e["name"][:80]] += e["dur"] / 1e6
    idle = collections.defaultdict(float)
    for _, length, label in gaps:
        idle[label] += length / 1e6
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top]}


class Counting:
    """Reads to the host and stream synchronisations made inside ``with
    counting.watch():`` blocks (a dispatch mode that sees every transfer from
    the device to the host, and the sync debug mode's warnings)."""

    def __init__(self):
        self.reads = 0
        self.syncs = 0

    @contextlib.contextmanager
    def watch(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        aten = torch.ops.aten
        scalar_reads = (aten._local_scalar_dense.default, aten.item.default, aten.is_nonzero.default)
        counting = self

        class Reads(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                src = next((a for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)
                if src is not None:
                    if func in scalar_reads or func is aten.nonzero.default:
                        counting.reads += 1
                    elif isinstance(out, torch.Tensor) and out.device.type == "cpu":
                        non_blocking = func is aten.copy_.default and bool(
                            args[2] if len(args) > 2 else kwargs.get("non_blocking", False))
                        counting.reads += 0 if non_blocking else 1
                return out

        saved = warnings.showwarning

        def record(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" in str(message):
                counting.syncs += 1
            else:
                saved(message, category, filename, lineno, file, line)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with Reads():
                    yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
