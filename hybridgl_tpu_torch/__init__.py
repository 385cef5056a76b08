"""hybridgl_tpu_torch — the PyTorch/CUDA port of hybridgl_tpu for NVIDIA Hopper.

The JAX package ``hybridgl_tpu`` is the reference; this package mirrors its
layout and function names module for module, so every port module has an
obvious counterpart:

  core/      typed configs and parameter trees (same fields, keys and
             shapes as the reference's)
  kernels/   hand-written sm_90a CUDA kernels (csrc/) behind thin wrappers,
             each with a plain PyTorch version beside it, plus the plain
             tensor primitives (resize, blur, NMS, mask analytics)
  models/    sam (encoder, prompt encoder, decoder, AMG), clip (ViT, text,
             the six fusion modes), gem
  pipeline/  crops, guidance, host cleanup and the runner
  data/      REFER / PhraseCut datasets, the REFER API, RLE codec, prefetcher
  lang/      expression parsers
  native/    C++ sources of the region cleanup and the RLE codec
  utils/     env flags, the host-compiler build of native/
  eval/      IoU accumulators, result log, progress checkpoints
  cli/       the evaluation CLI and the demo (python -m hybridgl_tpu_torch.cli.main)
  tools/     check_kernels: every CUDA kernel against its plain version

The port imports ``torch`` and never ``jax``, and nothing of
``hybridgl_tpu``: of the reference's jax-free modules (configs, tokenizer
with its vocabulary, expression parsers, the native region-cleanup binding,
env helpers, the REFER API, RLE codec, prefetcher, parity log and overlays)
it keeps its own copy under the same relative path. A kernel wrapper runs its
plain version for a CPU tensor and launches its CUDA kernel (or raises) for
a CUDA tensor. Importing the package registers the ten kernels as PyTorch
operators, ``torch.ops.hybridgl.*`` (``kernels/_ops.py``), which a program
exported by ``tools/export_serving.py`` needs before ``torch.export.load``.
"""

from .kernels import kernel_wrappers as _kernel_wrappers

__version__ = "0.1.0"

_kernel_wrappers()  # registers torch.ops.hybridgl.*


def __getattr__(name):
    """Lazy top-level convenience exports."""
    if name == "PipelineConfig":
        from .core.config import PipelineConfig

        return PipelineConfig
    if name == "HybridGLPipeline":
        from .pipeline.runner import HybridGLPipeline

        return HybridGLPipeline
    if name == "SamPredictor":
        from .models.sam.predictor import SamPredictor

        return SamPredictor
    if name == "tokenize":
        from .models.clip.tokenizer import tokenize

        return tokenize
    raise AttributeError(name)
