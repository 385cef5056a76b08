"""Take-one-thing-out timings of the tensor-core decoder kernels (K3, K4).

Each variant rebuilds the kernel library with one compile-time switch of
``csrc/decoder_attn_wgmma.cu`` or ``csrc/upscale_hyper_wgmma.cu`` set to 0
(the products, the GELU, the stores to device memory, the tile fetches) and
times K3 pass B, K3 pass A and K4 at B = 64 with
:func:`check_kernels.time_ms`. A variant's results are wrong by design; only
its time is read, against the unchanged build's in the same run, to see what
the kernels pay for. Each variant runs in a process of its own (the library
is loaded once per process). Needs a CUDA card.

    python -m hybridgl_tpu_torch.tools.take_one_out
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
)


def _child(flags: list[str]) -> None:
    import torch

    from ..kernels import _build
    from ..kernels.decoder_pass import i2t_ln_then_t2i
    from ..kernels.upscale_hyper import upscale_hyper
    from .check_kernels import _i2t_ops, _Run, time_ms

    _build.NVCC_FLAGS.extend(flags)
    run = _Run(torch.device("cuda"), print)
    f32, B, S, C = torch.float32, 64, 4096, 256
    pe = run.randn(1, S, C)
    times = {}
    for shared in (False, True):
        Cq = 128 if shared else C
        ops = _i2t_ops(run, B, Cq)
        qside = run.randn(1 if shared else B, S, Cq)
        base = run.randn(1, S, C) if shared else qside
        qw = run.randn(B, C, 64, std=C**-0.5 * 2, dtype=f32)
        times["K3 pass A" if shared else "K3 pass B"] = time_ms(
            lambda: i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=8, tp=8, shared_qside=shared))
    if any("K3" in f for f in flags):
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
    for name, flags in VARIANTS:
        done = subprocess.run([sys.executable, "-m", "hybridgl_tpu_torch.tools.take_one_out", "--child", *flags],
                              capture_output=True, text=True)
        line = [ln for ln in done.stdout.splitlines() if ln.startswith("TIMES ")]
        print(f"{name}: {line[0][6:] if line else 'FAILED ' + done.stderr[-800:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
