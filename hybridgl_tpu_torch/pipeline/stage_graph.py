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
port's plain path does everywhere.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

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
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Proposals] = None  # the graph's own output buffers
        self.captures = 0
        self.warmup_ms = self.capture_ms = self.instantiate_ms = None
        self.nodes = self.pool_bytes = None
        self.launches, self.tc_launches = {}, {}

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
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for name, fn in kernel_wrappers().items():
            fn.launches += self.launches[name]
            if hasattr(fn, "tc_launches"):
                fn.tc_launches += self.tc_launches[name]
        out = self.outputs
        return Proposals(*(t.clone() for t in out[:7]), num=out.num.clone(), overflow=out.overflow.clone())

    def eager(self) -> Proposals:
        """The stage run eagerly on the loaded inputs, the kernels counting
        their launches as they go: what the capture records, and after a
        replay the yardstick that replay is held to (the same inputs)."""
        cfg = self.cfg
        return proposal_stage(self.sam_params, self.image_1024, self.image_canonical, self.geo, self.consts,
                              cfg.sam, cfg.amg, cfg.canonical_size)

    def _capture(self) -> None:
        """Warm the stage up on a side stream, then capture and instantiate it."""
        counts = _counts()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.eager()
        stream.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        warm = _counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = self.eager()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        graph.instantiate()
        self.instantiate_ms = (time.perf_counter() - t0) * 1e3
        captured = _counts()
        self.launches = {k: captured[k][0] - warm[k][0] for k in captured}
        self.tc_launches = {k: captured[k][1] - warm[k][1] for k in captured}
        _set_counts(counts)  # the warm-up and the capture are set-up
        self.graph, self.outputs = graph, outputs
        self.nodes = graph_nodes(graph)
        self.pool_bytes = pool_bytes(graph, self.device)
        self.captures += 1

    def stats(self) -> dict:
        """The capture's numbers, for the tools (None before the capture)."""
        return dict(captures=self.captures, warmup_ms=self.warmup_ms, capture_ms=self.capture_ms,
                    instantiate_ms=self.instantiate_ms, nodes=self.nodes, pool_bytes=self.pool_bytes,
                    launches={k: v for k, v in self.launches.items() if v})
