"""Host cost of a kernel launch through its registered operator.

Every kernel wrapper calls ``torch.ops.hybridgl.<name>`` (``kernels/_ops.py``),
which the PyTorch dispatcher sends to the CUDA implementation: the ctypes
launch that the wrappers made directly before. This tool times four routes to
the same launch, on four kernels at small shapes (each launch's device time
well under its host time, so the host clock around ``calls`` back-to-back
calls and one synchronise measures the host's cost a call):

  direct     the CUDA implementation called as a Python function;
  operator   ``torch.ops.hybridgl.<name>.default`` (``torch.library.Library``
             ``define`` + ``impl``, the route the port keeps);
  custom_op  the same implementation registered with
             ``torch.library.custom_op`` (namespace ``hybridgl_probe``);
  wrapper    the public wrapper (its argument casts, then the operator).

Rounds alternate the order of the routes; each route's number is the median
over the rounds, in microseconds a call. The kernels: K1 (one window of 16
heads, S = 196, hd = 80), K6 (12 heads, L = 197, hd = 64, with the CLS-row
bias), K5 (3 candidates, n = 256, C = 640) and K3 (one prompt, S = 64,
pass B), all bf16 on their tensor-core kernels.

    python -m hybridgl_tpu_torch.tools.dispatch_cost [--calls 2000] [--rounds 5]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

KERNELS = ("flash_windowed_fused", "clip_attention", "pass1_stats_half", "i2t_ln_then_t2i")
ROUTES = ("direct", "operator", "custom_op", "wrapper")


def _inputs(name: str, device, gen):
    """(operator arguments, public-wrapper call) of ``name`` at its small shape."""
    from ..kernels import kernel_wrappers

    bf16, f32 = torch.bfloat16, torch.float32

    def r(*shape, dtype=bf16, std=0.5):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    wrapper = kernel_wrappers()[name]
    if name == "flash_windowed_fused":
        args = (r(16, 196, 80), r(16, 196, 80), r(16, 196, 80), r(16, 196, 14, dtype=f32), r(16, 196, 14, dtype=f32),
                14, 80**-0.5)
        return args, lambda: wrapper(*args)
    if name == "clip_attention":
        bias = torch.where(torch.rand((1, 197), generator=gen, device=device) > 0.5, 0.0, torch.finfo(f32).min)
        bias[:, 0] = 0.0
        args = (r(12, 197, 64), r(12, 197, 64), r(12, 197, 64), bias.contiguous(), 12, 0.125)
        return args, lambda: wrapper(*args)
    if name == "pass1_stats_half":
        window = (0, 0, 480, 640)
        args = (r(3, 256, 640), r(640, 256, std=0.02), [float(v) for v in window], 0.0, 1.0)
        return args, lambda: wrapper(args[0], args[1], window, 0.0, 1.0)
    assert name == "i2t_ln_then_t2i"
    off = r(1, 8, 8, dtype=f32)
    off[:, :, 7:] = -1e30
    keys = r(1, 64, 256)
    args = (keys, keys, r(1, 64, 256), r(1, 256, 64, dtype=f32, std=0.1), off.reshape(1, 64), r(1, 64, 256),
            r(256, dtype=f32, std=0.1), 1.0 + r(256, dtype=f32, std=0.1), r(256, dtype=f32, std=0.1),
            r(1, 256, 64, dtype=f32, std=0.1), 8, 8, False)
    return args, lambda: wrapper(*args)


def _custom_op(name: str):
    """The CUDA implementation of ``name`` registered again through ``torch.library.custom_op``."""
    from ..kernels import _ops

    probe = f"hybridgl_probe::{name}"
    if not hasattr(torch.ops.hybridgl_probe, name):
        op = _ops.REGISTERED[name]
        torch.library.custom_op(probe, op.cuda, mutates_args=(), device_types="cuda", schema=op.schema)
    return getattr(torch.ops.hybridgl_probe, name).default


def _host_us(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def measure(calls: int = 2000, rounds: int = 5, log=print) -> dict:
    """{kernel: {route: median host microseconds a call}} on the card."""
    from ..kernels import _ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name in KERNELS:
        args, wrapper = _inputs(name, torch.device("cuda"), gen)
        fns = {"direct": lambda: _ops.REGISTERED[name].cuda(*args),
               "operator": lambda: getattr(torch.ops.hybridgl, name).default(*args),
               "custom_op": lambda: _custom_op(name)(*args), "wrapper": wrapper}
        for fn in fns.values():  # warm-up: the library's build and load, the first launches
            for _ in range(20):
                fn()
        times = {route: [] for route in ROUTES}
        for i in range(rounds):
            for route in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
                times[route].append(_host_us(fns[route], calls))
        out[name] = {route: statistics.median(t) for route, t in times.items()}
        cost = out[name]
        log(f"  launch host cost, {name}: direct {cost['direct']:.2f} us, operator {cost['operator']:.2f} "
            f"(+{cost['operator'] - cost['direct']:.2f}), custom_op {cost['custom_op']:.2f} "
            f"(+{cost['custom_op'] - cost['direct']:.2f}), wrapper {cost['wrapper']:.2f} "
            f"(+{cost['wrapper'] - cost['direct']:.2f}) a call, median of {rounds} x {calls}")
    return out


def main(argv=None) -> int:
    from ._common import card_line, require_card

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=2000)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    require_card("dispatch_cost")
    print(f"card: {card_line()}", flush=True)
    measure(args.calls, args.rounds, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
