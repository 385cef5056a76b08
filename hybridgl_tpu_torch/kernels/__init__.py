"""Kernels of the port.

``flash_attention``, ``clip_attention``, ``pass1_stats``, ``decoder_attn``,
``decoder_attn_t2i``, ``decoder_pass`` and ``upscale_hyper`` wrap the
hand-written CUDA kernels in ``csrc/`` (built by ``_build``); the other
modules are the plain tensor primitives the reference wrote as XLA.

Each kernel wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), incremented only where it launches its kernel. The
two wrappers whose C dispatch is not mirrored call by call elsewhere (K5,
K6) also count the launches that took the tensor-core kernel
(``wrapper.tc_launches``).
"""

from __future__ import annotations


def kernel_wrappers():
    """{name: wrapper} for every CUDA kernel of the port."""
    from .clip_attention import clip_attention
    from .decoder_attn import i2t_ln_update
    from .decoder_attn_t2i import t2i_ctx
    from .decoder_pass import i2t_ln_then_t2i
    from .flash_attention import flash_attention_fused, flash_attention_rel_pos, flash_windowed_fused
    from .pass1_stats import pass1_stats, pass1_stats_half
    from .upscale_hyper import upscale_hyper

    return {
        "flash_windowed_fused": flash_windowed_fused,
        "flash_attention_fused": flash_attention_fused,
        "pass1_stats_half": pass1_stats_half,
        "clip_attention": clip_attention,
        "i2t_ln_then_t2i": i2t_ln_then_t2i,
        "upscale_hyper_blocked": upscale_hyper,
        "i2t_ln_update": i2t_ln_update,
        "t2i_ctx": t2i_ctx,
        "flash_attention_rel_pos": flash_attention_rel_pos,
        "pass1_stats": pass1_stats,
    }


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def tc_launch_counts() -> dict:
    """{name: launches that took the tensor-core kernel} for the wrappers that count them."""
    return {name: fn.tc_launches for name, fn in kernel_wrappers().items() if hasattr(fn, "tc_launches")}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0
