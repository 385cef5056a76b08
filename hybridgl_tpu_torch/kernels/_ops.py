"""The port's kernels as PyTorch operators, ``torch.ops.hybridgl.<name>``.

Each operator is named after the reference function it replaces (the ten
TPU kernels, and ``nms``, which the reference writes as XLA) and has three
implementations: CUDA (the wrapper's ctypes launch, with its checks, its
choice of kernel and its launch counters), CPU (the plain PyTorch version)
and a fake one that gives the output shapes, dtypes and devices from the
input shapes alone, so that ``torch.export`` and FakeTensor tracing record
the operator as one node. The public wrappers in ``kernels/*.py`` call the
operator and nothing else; importing a wrapper's module registers its
operator. No operator writes into its inputs and none has a backward (the
kernels serve inference, as the reference's do).

The operators are registered through ``torch.library.Library`` (``define``
+ ``impl``) rather than ``torch.library.custom_op``: the same schema, the
same dispatch, and less Python per call (``PERF.md``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

NAMESPACE = "hybridgl"
_LIB = torch.library.Library(NAMESPACE, "DEF")


class Operator(NamedTuple):
    schema: str  # "(...) -> ..." after the name
    cpu: Callable  # the plain version
    cuda: Callable  # the ctypes launch itself, callable without the dispatcher


REGISTERED: dict[str, Operator] = {}  # name -> its schema and implementations


def define(schema: str, cpu, cuda, fake):
    """Register ``hybridgl::<schema>`` with its CPU, CUDA and fake
    implementations; returns the operator's overload (what a wrapper calls)."""
    name, signature = schema.split("(", 1)
    REGISTERED[name] = Operator("(" + signature, cpu, cuda)
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
