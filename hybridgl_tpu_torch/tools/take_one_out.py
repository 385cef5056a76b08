"""Take-one-thing-out timings of the tensor-core kernels K3, K4, K5 and K10.

Each variant rebuilds the kernel library with one compile-time switch of
``csrc/decoder_attn_wgmma.cu``, ``csrc/upscale_hyper_wgmma.cu`` or
``csrc/pass1_stats_wgmma.cu`` set to 0 (the products, the GELU or the
thresholds, the stores to device memory, the tile fetches) and times K3 pass
B, K3 pass A and K4 at B = 64, and K5 at 192 candidates (the RefCOCO window
at C = 640 and PhraseCut's layer-1 crop window at C = 1024), and K10 at the
kernel check's two shapes (48 x [256, 256] to C = 1024 and 192 x [256, 256]
to C = 640) with its column transform's products or its sweep skipped, with
:func:`check_kernels.time_ms`. A variant's results are wrong by design; only
its time is read, against the unchanged build's in the same run, to see what
the kernels pay for. Each variant runs in a process of its own (the library
is loaded once per process). Needs a CUDA card.

    python -m hybridgl_tpu_torch.tools.take_one_out [K3] [K4] [K5] [K10]   (default: all)
"""

from __future__ import annotations

import subprocess
import sys

VARIANTS = (
    ("as built", []),
    ("K4 GELU as identity", ["-DHGL_K4_GELU=0"]),
    ("K4 products skipped", ["-DHGL_K4_MMA=0"]),
    ("K4 mask stores skipped", ["-DHGL_K4_STORE=0"]),
    ("K4 src fetched once", ["-DHGL_K4_FETCH=0"]),
    ("K3 products skipped", ["-DHGL_K3_MMA=0"]),
    ("K3 keys' stores skipped", ["-DHGL_K3_STORE=0"]),
    ("K3 tiles fetched once", ["-DHGL_K3_FETCH=0"]),
    ("K5 products skipped", ["-DHGL_K5_MMA=0"]),
    ("K5 thresholds skipped", ["-DHGL_K5_THRESH=0"]),
    ("K5 Wy tiles fetched once", ["-DHGL_K5_FETCH=0"]),
    ("K10 transform's products skipped", ["-DHGL_K10_TRANSFORM=0"]),
    ("K10 sweep skipped", ["-DHGL_K10_SWEEP=0"]),
)
KERNEL_IDS = ("K3", "K4", "K5", "K10")


def _child(flags: list[str]) -> None:
    import torch

    from ..kernels import _build
    from ..kernels.decoder_pass import i2t_ln_then_t2i
    from ..kernels.pass1_stats import half_transform, pass1_stats, pass1_stats_half
    from ..kernels.resize import _composed_axis_weights
    from ..kernels.upscale_hyper import upscale_hyper
    from .check_kernels import _i2t_ops, _Run, _smooth_logits, time_ms

    _build.NVCC_FLAGS.extend(flags)
    run = _Run(torch.device("cuda"), print)
    f32, B, S, C = torch.float32, 64, 4096, 256
    pe = run.randn(1, S, C)
    times = {}
    touched = [k for k in KERNEL_IDS if any(f"HGL_{k}_" in f for f in flags)] or list(KERNEL_IDS)
    # K5: check_kernels' RefCOCO window and PhraseCut layer-1 crop window
    low = _smooth_logits(run, 192, 256)
    for label, Cc, frame_h, win in (("K5 C = 640", 640, 768, (0, 0, 480, 640)),
                                    ("K5 crop window", 1024, 820, (159, 239, 321, 401))):
        if "K5" not in touched:
            times[label] = float("nan")  # unchanged by a K3 or K4 switch
            continue
        Wy = _composed_axis_weights(Cc, 256, 1024, frame_h, win[0], win[2], run.dev).bfloat16()
        Wx = _composed_axis_weights(Cc, 256, 1024, 1024, win[1], win[3], run.dev)
        tmp = half_transform(low, Wx.T)
        times[label] = time_ms(lambda: pass1_stats_half(tmp, Wy, win, 0.0, 1.0))
    # K10: check_kernels' two shapes (48 candidates with soft weights, the RefCOCO window)
    for label, B, Cc, frame_h, win in (("K10 B = 48, C = 1024", 48, 1024, 768, (17, 5, 451, 633)),
                                       ("K10 B = 192, C = 640", 192, 640, 768, (0, 0, 480, 640))):
        if "K10" not in touched:
            times[label] = float("nan")
            continue
        Wy = _composed_axis_weights(Cc, 256, 1024, frame_h, win[0], win[2], run.dev).bfloat16()
        WxT = _composed_axis_weights(Cc, 256, 1024, 1024, win[1], win[3], run.dev).T.contiguous().bfloat16()
        low_b = low[:B].bfloat16()
        times[label] = time_ms(lambda: pass1_stats(low_b, WxT, Wy, win, 0.0, 1.0))
    if "K3" not in touched and "K4" not in touched:
        print("TIMES " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)
        return
    for shared in (False, True):
        Cq = 128 if shared else C
        ops = _i2t_ops(run, B, Cq)
        qside = run.randn(1 if shared else B, S, Cq)
        base = run.randn(1, S, C) if shared else qside
        qw = run.randn(B, C, 64, std=C**-0.5 * 2, dtype=f32)
        times["K3 pass A" if shared else "K3 pass B"] = time_ms(
            lambda: i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=8, tp=8, shared_qside=shared))
    if "K4" not in touched:
        times["K4"] = float("nan")  # unchanged by a K3 switch
    else:
        args = (run.randn(B, S, C), run.randn(C, 256, std=C**-0.5), run.randn(64, std=0.1, dtype=f32),
                1.0 + run.randn(64, std=0.1, dtype=f32), run.randn(64, std=0.1, dtype=f32),
                run.randn(64, 128, std=64**-0.5), run.randn(32, std=0.1, dtype=f32), run.randn(B, 3, 32, std=0.5))
        times["K4"] = time_ms(lambda: upscale_hyper(*args))
    print("TIMES " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        _child(argv[1:])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("take_one_out: no CUDA card; nothing was timed", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    wanted = [a for a in argv if a in KERNEL_IDS] or list(KERNEL_IDS)
    for name, flags in VARIANTS:
        if flags and name.split()[0] not in wanted:
            continue
        done = subprocess.run([sys.executable, "-m", "hybridgl_tpu_torch.tools.take_one_out", "--child", *flags],
                              capture_output=True, text=True)
        line = [ln for ln in done.stdout.splitlines() if ln.startswith("TIMES ")]
        print(f"{name}: {line[0][6:] if line else 'FAILED ' + done.stderr[-800:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
