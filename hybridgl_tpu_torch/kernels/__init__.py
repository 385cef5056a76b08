"""Kernels of the port.

``flash_attention``, ``clip_attention`` and ``pass1_stats`` wrap the
hand-written CUDA kernels in ``csrc/`` (built by ``_build``); the other
modules are the plain tensor primitives the reference wrote as XLA.

Each kernel wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), incremented only where it launches its kernel.
"""

from __future__ import annotations


def kernel_wrappers():
    """{name: wrapper} for every CUDA kernel of the main path."""
    from .clip_attention import clip_attention
    from .flash_attention import flash_attention_fused, flash_windowed_fused
    from .pass1_stats import pass1_stats_half

    return {
        "flash_windowed_fused": flash_windowed_fused,
        "flash_attention_fused": flash_attention_fused,
        "pass1_stats_half": pass1_stats_half,
        "clip_attention": clip_attention,
    }


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
