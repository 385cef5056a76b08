"""Process-group layout for multi-GPU evaluation (counterpart of
hybridgl_tpu/parallel/mesh.py).

The reference shards images over a ``('dp',)`` or ``('dp', 'mp')`` device
mesh inside one process. Here every device has a process of its own
(``torch.distributed``), and the mesh is a small object that knows this
process's place in it: images shard over ``dp``; inside an ``mp`` group
(consecutive ranks, as the reference reshapes its devices to ``(n // mp,
mp)``) the fusion stage shards the proposal axis, and the tensor-parallel
encoder (``encoder_tp.py``) its heads. Parameters are replicated: every rank
holds its own copy. The only communication an evaluation needs is the sum of
four IoU scalars (or the gather of a few kilobytes of scoring ingredients)
over ``dp`` and one gather of [P, E] features an image over ``mp``.

This module provides
  * :func:`make_mesh` / :func:`make_mesh_2d`: the layout, over a process
    group that the caller has initialised (``launch.py`` starts such
    processes);
  * :class:`ProcessMesh`: ``all_reduce_sum``, ``all_gather`` and
    ``broadcast`` over an axis. Over ``gloo`` a CUDA tensor is staged through
    the host here, in :meth:`ProcessMesh._stage`, and nowhere else: gloo takes
    CUDA tensors for some collectives only (not for ``all_gather``), and two
    ranks that share one card cannot use NCCL;
  * :func:`build_sharded_eval_step`: the short step (sentence + noun phrase
    only): each rank runs SAM proposals -> crops -> fusion -> score ->
    selection -> IoU on its shard of the batch, then the accumulators are
    summed over ``dp``;
  * :func:`shard_batch`: this rank's shard of a host batch.

``torch.distributed`` is imported inside the functions that use it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..eval.metrics import IoUAccum, mask_iou
from ..kernels.masks import box_xyxy_to_xywh
from ..models.clip.fusion import calculate_score
from ..models.clip.text import encode_text
from ..models.sam.amg import generate_proposals
from ..pipeline.guidance import select_candidates
from ..pipeline.runner import fusion_features


class _MpShard(NamedTuple):
    """What ``pipeline/runner.py:fusion_features`` takes to shard the proposal axis."""

    index: int
    size: int
    all_gather: object  # tensor [n, ...] -> [size * n, ...]


class ProcessMesh:
    """This process's place in a ``dp x mp`` layout of ``world`` ranks: rank
    r has dp index ``r // mp`` and mp index ``r % mp``."""

    def __init__(self, dp: int, mp: int = 1):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("make_mesh: torch.distributed is not initialised (see parallel/launch.py)")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        if dp * mp != self.world:
            raise ValueError(f"a {dp} x {mp} mesh needs {dp * mp} ranks, the process group has {self.world}")
        self.dp, self.mp = dp, mp
        self.dp_index, self.mp_index = self.rank // mp, self.rank % mp
        self.backend = dist.get_backend()
        # every rank creates every group, in the same order
        self.groups = {"dp": None, "mp": None}
        for m in range(mp):
            group = dist.new_group([d * mp + m for d in range(dp)]) if mp > 1 else dist.group.WORLD
            if m == self.mp_index:
                self.groups["dp"] = group
        for d in range(dp):
            group = dist.new_group([d * mp + m for m in range(mp)]) if mp > 1 else None
            if d == self.dp_index:
                self.groups["mp"] = group

    def size(self, axis: str) -> int:
        return {"dp": self.dp, "mp": self.mp}[axis]

    def index(self, axis: str) -> int:
        return {"dp": self.dp_index, "mp": self.mp_index}[axis]

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh tensor that the backend's collectives take: on the host for
        gloo (which has no ``all_gather`` for CUDA tensors), else on t's device."""
        t = t.detach()
        return t.cpu().clone() if self.backend == "gloo" else t.clone().contiguous()

    def all_reduce_sum(self, t: torch.Tensor, axis: str = "dp") -> torch.Tensor:
        import torch.distributed as dist

        if self.size(axis) == 1:
            return t
        staged = self._stage(t)
        dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return staged.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str = "dp") -> torch.Tensor:
        """[n, ...] on every rank of the axis -> [size * n, ...] in rank order."""
        import torch.distributed as dist

        if self.size(axis) == 1:
            return t
        staged = self._stage(t)
        parts = [torch.empty_like(staged) for _ in range(self.size(axis))]
        dist.all_gather(parts, staged, group=self.groups[axis])
        return torch.cat(parts, dim=0).to(t.device)

    @property
    def mp_shard(self) -> _MpShard:
        return _MpShard(self.mp_index, self.mp, lambda t: self.all_gather(t, "mp"))


def make_mesh(n_devices: int | None = None) -> ProcessMesh:
    """The 1D ``dp`` layout over every rank of the process group."""
    import torch.distributed as dist

    return ProcessMesh(n_devices or dist.get_world_size(), 1)


def make_mesh_2d(n_devices: int | None = None, mp: int = 2) -> ProcessMesh:
    """The ``(dp, mp)`` layout: images shard over dp; inside an mp group
    (consecutive ranks: neighbours on the interconnect) the fusion stage
    shards the proposal axis."""
    import torch.distributed as dist

    n = n_devices or dist.get_world_size()
    assert n % mp == 0, (n, mp)
    return ProcessMesh(n // mp, mp)


class EvalBatch(NamedTuple):
    """Stacked per-image host arrays, leading axis = the global batch (sharded over dp)."""

    image_1024: np.ndarray  # [B, S, S, 3] uint8
    rh: np.ndarray  # [B]
    rw: np.ndarray
    image_canonical: np.ndarray  # [B, C, C, 3] uint8
    h: np.ndarray  # [B]
    w: np.ndarray
    gt_mask: np.ndarray  # [B, C, C] bool
    tokens_sentence: np.ndarray  # [B, L]
    tokens_np: np.ndarray  # [B, L]


def params_device(sam_params) -> torch.device:
    return sam_params["prompt"]["pe_gaussian"].device


def _single_image_step(sam_params, clip_params, sample: EvalBatch, cfg: PipelineConfig, mesh: ProcessMesh, mp_axis):
    """The short pipeline for one image (leading axes already indexed away).
    With ``mp_axis`` the fusion stage shards the proposal axis over the mp
    group and one ``all_gather`` reassembles the [P, E] features; the
    proposals are computed by every member of the group."""
    dev = params_device(sam_params)
    h, w = int(sample.h), int(sample.w)
    image_1024 = torch.from_numpy(np.asarray(sample.image_1024)).to(dev)
    props = generate_proposals(sam_params, image_1024, int(sample.rh), int(sample.rw), h, w, cfg.sam, cfg.amg,
                               cfg.canonical_size)
    image_c = torch.from_numpy(np.asarray(sample.image_canonical)).to(dev)
    feats = fusion_features(cfg, clip_params, props.masks, image_c, h, w, mesh.mp_shard if mp_axis else None)
    toks = torch.from_numpy(np.stack([sample.tokens_sentence, sample.tokens_np])).to(dev)
    tf = encode_text(clip_params["text"], toks, cfg.clip)
    text_ensemble = cfg.guidance.r * tf[0] + (1 - cfg.guidance.r) * tf[1]
    score = calculate_score(feats, text_ensemble[None], clip_params["logit_scale"])[:, 0]
    sel = select_candidates(score, score, box_xyxy_to_xywh(props.boxes_xyxy), torch.zeros_like(score), props.valid,
                            0, False, cfg.guidance.k1, cfg.guidance.k2, alpha=cfg.guidance.alpha)
    gt = torch.from_numpy(np.asarray(sample.gt_mask)).to(dev)
    return mask_iou(props.masks[sel.pure_index], gt), sel.pure_index


def build_sharded_eval_step(cfg: PipelineConfig, mesh: ProcessMesh, axis: str = "dp", mp_axis: str | None = None):
    """``step(sam_params, clip_params, local_batch) -> (global IoUAccum,
    selections [B])``: ``local_batch`` is this rank's shard
    (:func:`shard_batch`), its images run one after another, the four
    accumulator scalars are summed over ``axis`` and the per-image selections
    gathered in batch order. With a 2D mesh pass ``mp_axis='mp'``."""

    @torch.no_grad()
    def step(sam_params, clip_params, batch: EvalBatch):
        dev = params_device(sam_params)
        acc = torch.zeros(4, dtype=torch.float32, device=dev)
        sels = []
        for b in range(len(batch.rh)):
            (i, u, iou), sel = _single_image_step(sam_params, clip_params, EvalBatch(*(x[b] for x in batch)), cfg, mesh,
                                                  mp_axis)
            acc = acc + torch.stack([i, u, iou, torch.ones_like(i)])
            sels.append(sel)
        acc = mesh.all_reduce_sum(acc, axis)
        sels = mesh.all_gather(torch.tensor(sels, dtype=torch.int64, device=dev), axis)
        return IoUAccum(*acc), sels

    return step


def shard_batch(batch, mesh: ProcessMesh, axis: str = "dp"):
    """This rank's shard of a host batch (any NamedTuple of arrays with a
    leading batch axis): rows ``index * b`` to ``(index + 1) * b`` of B = size * b."""
    B, n = len(batch[0]), mesh.size(axis)
    if B % n:
        raise ValueError(f"a batch of {B} does not shard over {n} ranks")
    b = B // n
    return type(batch)(*(np.asarray(x)[mesh.index(axis) * b : (mesh.index(axis) + 1) * b] for x in batch))
