"""The proposal stage captured once per configuration as a CUDA graph and
replayed for every image: the port's counterpart of the reference's
``self._proposal_stage = jax.jit(proposal_stage)``
(hybridgl_tpu/pipeline/runner.py:361), whose one trace serves every image
size because ``rh, rw, h, w`` are traced arguments (:170-226).

``models/sam/amg.py:proposal_stage`` takes an image's geometry as one small
device table and launches the same kernels with the same arguments for every
image size, so one capture serves every (h, w) <= canonical. A
:class:`StageGraph` owns what its graph reads and writes:

* the static inputs: the padded S x S frame, the canonical frame (with a
  crop layer) and the geometry table (``amg.geometry``); each image is
  copied into them before its replay (pinned non-blocking copies from the
  host, device copies in stream order);
* the configuration's constants (``amg.stage_constants``: the point grids)
  and the parameters, which the graph reads where they are;
* the graph's private memory pool, which holds the stage's intermediates and
  its output bundle. Each replay's bundle is copied out of the pool: the
  runner's ``run_dataset`` queues image i+1's replay before image i's
  cleanup and scoring read image i's bundle.

The first call warms the stage up eagerly on a side stream (cuBLAS and cuDNN
handles, the kernel library's build and its kernels' first-use attributes),
then captures it and instantiates the graph. A capture that fails raises:
nothing falls back to the eager stage on the card. The capture runs in the
``thread_local`` mode, so that the caller's other threads (the CLI's input
prefetch, the host cleanup's pool) are not refused CUDA calls while this one
captures; the capturing thread itself stays held to capture-safe calls.

The kernel wrappers count their launches in Python, which a replay does not
run: the capture records what each wrapper counted and every replay adds it.
The warm-up and the capture are set-up, and leave the counters as they found
them.

Off the card the stage runs eagerly on the same static inputs, as the
port's plain path does everywhere. :func:`capture` and :func:`replay` hold
the warm-up, capture and counting for any stage function; the scoring
stages' graphs (``pipeline/score_graph.py``) use them too.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import torch

from ..core.config import PipelineConfig
from ..kernels import kernel_wrappers
from ..models.sam.amg import Proposals, geometry, proposal_stage, stage_constants
from ..utils.transfer import upload_into


def _counts() -> dict:
    """{wrapper name: (launches, tensor-core launches)} of every kernel wrapper."""
    return {name: (fn.launches, getattr(fn, "tc_launches", 0)) for name, fn in kernel_wrappers().items()}


def _set_counts(counts: dict) -> None:
    for name, fn in kernel_wrappers().items():
        fn.launches = counts[name][0]
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = counts[name][1]


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a captured graph (kept with ``keep_graph=True``),
    from the driver's ``cuGraphGetNodes``."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    code = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if code != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {code}")
    return count.value


def pool_bytes(graph: torch.cuda.CUDAGraph, device) -> int:
    """The bytes the caching allocator reserved for the graph's private pool."""
    pool, index = tuple(graph.pool()), torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg["segment_pool_id"]) == pool)


class Captured(NamedTuple):
    """A stage function captured as a CUDA graph, and what its capture cost."""

    graph: torch.cuda.CUDAGraph
    outputs: object  # the graph's own output buffers, in its private pool
    warmup_ms: float  # host clock, each
    capture_ms: float
    instantiate_ms: float
    nodes: int
    pool_bytes: int
    launches: dict  # {wrapper: launches a replay}
    tc_launches: dict

    def stats(self) -> dict:
        return dict(warmup_ms=self.warmup_ms, capture_ms=self.capture_ms, instantiate_ms=self.instantiate_ms,
                    nodes=self.nodes, pool_bytes=self.pool_bytes,
                    launches={k: v for k, v in self.launches.items() if v})


def capture(fn, device) -> Captured:
    """Warm ``fn`` (no arguments; it reads and writes tensors that outlive
    the graph) up eagerly on a side stream, then capture it in a private
    pool in ``thread_local`` mode and instantiate the graph. A capture that
    fails raises. The warm-up and the capture leave the kernels' launch
    counters as they found them; :func:`replay` adds what the capture
    counted."""
    counts = _counts()
    stream = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(stream)
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        fn()
    stream.wait_stream(side)
    torch.cuda.synchronize(device)
    warmup_ms = (time.perf_counter() - t0) * 1e3
    warm = _counts()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outputs = fn()
    capture_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    graph.instantiate()
    instantiate_ms = (time.perf_counter() - t0) * 1e3
    captured = _counts()
    _set_counts(counts)  # the warm-up and the capture are set-up
    return Captured(graph, outputs, warmup_ms, capture_ms, instantiate_ms, graph_nodes(graph), pool_bytes(graph, device),
                    {k: captured[k][0] - warm[k][0] for k in captured},
                    {k: captured[k][1] - warm[k][1] for k in captured})


def replay(c: Captured):
    """Launch a captured graph and add the launches its capture counted: its output buffers."""
    c.graph.replay()
    for name, fn in kernel_wrappers().items():
        fn.launches += c.launches[name]
        if hasattr(fn, "tc_launches"):
            fn.tc_launches += c.tc_launches[name]
    return c.outputs


class StageGraph:
    """The proposal stage of one configuration (``cfg``'s SAM and AMG
    settings and canonical size), one set of parameters and one device:
    captured at its first image and replayed for every image on a CUDA
    device, run eagerly elsewhere. Call it with an image's padded frame, its
    canonical frame and its :func:`~hybridgl_tpu_torch.models.sam.amg.geometry`
    table (numpy arrays or tensors), or use :meth:`launch` with an
    ``ImageSample``; it returns the image's bundle, launched and not waited
    for, in tensors of its own.

    After the capture: ``captures`` (1), ``warmup_ms``, ``capture_ms`` and
    ``instantiate_ms`` (host clock), ``nodes`` (the graph's node count),
    ``pool_bytes`` (its private pool) and ``launches`` ({wrapper: launches a
    replay}, ``tc_launches`` likewise)."""

    def __init__(self, cfg: PipelineConfig, sam_params, device):
        self.cfg, self.sam_params, self.device = cfg, sam_params, torch.device(device)
        S, C = cfg.sam.img_size, cfg.canonical_size
        multicrop = cfg.amg.crop_n_layers >= 1
        self.consts = stage_constants(cfg.sam, cfg.amg, self.device)
        self.image_1024 = torch.zeros((S, S, 3), dtype=torch.uint8, device=self.device)
        self.image_canonical = torch.zeros((C, C, 3), dtype=torch.uint8, device=self.device) if multicrop else None
        self.geo = torch.zeros((5 if multicrop else 1, 6), dtype=torch.float32, device=self.device)
        self.captured: Optional[Captured] = None

    def launch(self, sample) -> Proposals:
        """The stage of one ``ImageSample`` (its image fields and geometry;
        ``image_canonical`` may already be on the device)."""
        geo = geometry(sample.rh, sample.rw, sample.h, sample.w, self.cfg.sam, self.cfg.amg)
        return self(sample.image_1024, sample.image_canonical, geo)

    def __call__(self, image_1024, image_canonical, geo) -> Proposals:
        upload_into(self.image_1024, image_1024)
        if self.image_canonical is not None:
            upload_into(self.image_canonical, image_canonical)
        upload_into(self.geo, geo)
        if self.device.type != "cuda":
            return self.eager()
        if self.captured is None:
            self.captured = capture(self.eager, self.device)
        out = replay(self.captured)
        return Proposals(*(t.clone() for t in out[:7]), num=out.num.clone(), overflow=out.overflow.clone())

    @property
    def captures(self) -> int:
        return int(self.captured is not None)

    def __getattr__(self, name):
        """The capture's graph, buffers and numbers (``Captured``'s fields): None before it."""
        if name in Captured._fields:
            c = self.__dict__.get("captured")
            return None if c is None else getattr(c, name)
        raise AttributeError(name)

    def eager(self) -> Proposals:
        """The stage run eagerly on the loaded inputs, the kernels counting
        their launches as they go: what the capture records, and after a
        replay the yardstick that replay is held to (the same inputs)."""
        cfg = self.cfg
        return proposal_stage(self.sam_params, self.image_1024, self.image_canonical, self.geo, self.consts,
                              cfg.sam, cfg.amg, cfg.canonical_size)

    def stats(self) -> dict:
        """The capture's numbers, for the tools (None before the capture)."""
        if self.captured is None:
            return dict(captures=0, warmup_ms=None, capture_ms=None, instantiate_ms=None, nodes=None,
                        pool_bytes=None, launches={})
        return dict(captures=1, **self.captured.stats())
