"""Kernels of the port.

``flash_attention``, ``clip_attention``, ``pass1_stats``, ``decoder_attn``,
``decoder_attn_t2i``, ``decoder_pass`` and ``upscale_hyper`` wrap the
hand-written CUDA kernels in ``csrc/`` (built by ``_build``) that replace the
ten TPU kernels, ``nms`` wraps the port's own NMS kernel (the reference's
``nms`` is XLA), ``clip_glue`` and ``sam_glue`` the port's fused glue of the
CLIP block and of the SAM encoder block (XLA's fusions in the reference) and
``gem_attention`` GEM's attention (plain XLA in the reference): each wrapper
calls its registered operator,
``torch.ops.hybridgl.<reference function's name>`` (``_ops``), whose CUDA
implementation launches the kernel and whose CPU one runs the plain version.
The other modules are the plain tensor primitives the reference wrote as
XLA.

Each kernel wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), incremented only where it launches its kernel, once
a kernel launch (K3's split route makes several a call; ``nms`` counts one a
call for its two kernels, ``gem_attention`` one a call for its normalisation
and its passes). The wrappers with a tensor-core and a CUDA-core kernel
behind them (the ten and ``gem_attention``) also count the launches that took the
tensor-core one (``wrapper.tc_launches``).
"""

from __future__ import annotations


# the fused glue of the CLIP block (``clip_glue``), by operator name
GLUE = ("layer_norm", "residual_add", "residual_layer_norm", "inject_layer_norm", "qkv_heads", "merge_heads",
        "bias_quick_gelu")
# the fused glue of the SAM encoder block (``sam_glue``), by operator name: ``sam_<wrapper name>``
SAM_GLUE = ("sam_layer_norm", "sam_qkv_heads", "sam_merge_heads", "sam_residual_layer_norm", "sam_residual_add",
            "sam_bias_gelu")


def kernel_wrappers():
    """{name: wrapper} for every CUDA kernel of the port, by the name of its
    operator; importing them registers the twenty-five operators."""
    from . import clip_glue, sam_glue
    from .clip_attention import clip_attention
    from .gem_attention import gem_attention
    from .decoder_attn import i2t_ln_update
    from .decoder_attn_t2i import t2i_ctx
    from .decoder_pass import i2t_ln_then_t2i
    from .flash_attention import flash_attention_fused, flash_attention_rel_pos, flash_windowed_fused
    from .nms import nms
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
        "nms": nms,
        "gem_attention": gem_attention,
        **{name: getattr(clip_glue, name) for name in GLUE},
        **{name: getattr(sam_glue, name.removeprefix("sam_")) for name in SAM_GLUE},
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
