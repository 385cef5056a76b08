"""SamPredictor-style convenience API (port of hybridgl_tpu/models/sam/predictor.py).

A thin stateful wrapper over the functional SAM modules with the usage
pattern of segment_anything's predictor (predictor.py): ``set_image`` once,
which caches the embedding, then cheap repeated ``predict`` calls with point
and box prompts. On a card ``set_image`` runs the encoder's attention
kernels (K1, K2) and ``predict`` the decoder's default route at B = 1 (K3
twice, K4 once).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...core.config import SamConfig
from ...kernels.resize import place_valid_region
from .decoder import predict_masks
from .image_encoder import encode_image, prepare_sam_params
from .prompt_encoder import dense_pe, embed_boxes, embed_points, no_mask_dense
from .sam import get_preprocess_shape, preprocess_padded, upscale_logits_to_input_frame


class SamPredictor:
    def __init__(self, params, cfg: SamConfig, device=None):
        """``device`` defaults to where ``params`` live; the prompts and the
        frame are moved there. What depends on the weights alone (rel-pos
        tables, the decoder's prepared products) is built once here."""
        self.params = prepare_sam_params(params, cfg)
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else params["prompt"]["pe_gaussian"].device
        self._features: Optional[torch.Tensor] = None
        self._orig_hw: Optional[Tuple[int, int]] = None
        self._input_hw: Optional[Tuple[int, int]] = None

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image: [h, w, 3] uint8 RGB. Long-side-resizes + encodes once."""
        from PIL import Image

        h, w = image.shape[:2]
        rh, rw = get_preprocess_shape(h, w, self.cfg.img_size)
        resized = np.asarray(Image.fromarray(image).resize((rw, rh), Image.BILINEAR))
        frame = np.zeros((self.cfg.img_size, self.cfg.img_size, 3), np.uint8)
        frame[:rh, :rw] = resized
        x = preprocess_padded(torch.from_numpy(frame).to(self.device), (rh, rw), self.cfg)
        self._features = encode_image(self.params["encoder"], x[None], self.cfg)[0]
        self._orig_hw = (h, w)
        self._input_hw = (rh, rw)

    @property
    def is_image_set(self) -> bool:
        return self._features is not None

    def get_image_embedding(self) -> torch.Tensor:
        assert self.is_image_set, "call set_image first"
        return self._features

    def reset_image(self) -> None:
        self._features = None
        self._orig_hw = None
        self._input_hw = None

    @torch.inference_mode()
    def predict(
        self,
        point_coords: Optional[np.ndarray] = None,  # [N, 2] original-res xy
        point_labels: Optional[np.ndarray] = None,  # [N]
        box: Optional[np.ndarray] = None,  # [4] xyxy original-res
        multimask_output: bool = True,
        return_logits: bool = False,
    ):
        """Returns numpy (masks [M, h, w], iou [M], low_res [M, 4g, 4g])."""
        assert self.is_image_set, "call set_image first"
        h, w = self._orig_hw
        rh, rw = self._input_hw
        sx, sy = rw / w, rh / h
        p, cfg, dev = self.params, self.cfg, self.device
        if point_coords is not None:
            coords = torch.from_numpy((np.asarray(point_coords, np.float32) * [sx, sy]).astype(np.float32)[None]).to(dev)
            labels = torch.from_numpy(np.asarray(point_labels, np.float32)[None]).to(dev)
        else:
            coords = torch.zeros((1, 0, 2), dtype=torch.float32, device=dev)
            labels = torch.zeros((1, 0), dtype=torch.float32, device=dev)
        # the padding point stands in for the box where there is none
        sparse = embed_points(p["prompt"], coords, labels, cfg, pad=box is None)
        if box is not None:
            boxes = torch.from_numpy((np.asarray(box, np.float32) * [sx, sy, sx, sy]).astype(np.float32)[None]).to(dev)
            sparse = torch.cat([sparse, embed_boxes(p["prompt"], boxes, cfg)], dim=1)
        # un-batched no-mask dense: the decoder keeps the image side shared
        dense = no_mask_dense(p["prompt"], cfg, 1)[0]
        low_res, iou = predict_masks(
            p["decoder"], self._features, dense_pe(p["prompt"], cfg), sparse, cfg,
            dense_prompts=dense, multimask_output=multimask_output,
        )
        low_res = low_res[0]
        # to the original size (reference sam.py:133-162): [M, S, S], then the valid corner to [M, h, w]
        up = upscale_logits_to_input_frame(low_res, cfg)
        out = place_valid_region(up.movedim(0, -1), (rh, rw), (h, w), (h, w)).movedim(-1, 0)
        masks = out if return_logits else out > cfg.mask_threshold
        if masks.is_floating_point():
            masks = masks.float()
        return masks.cpu().numpy(), iou[0].float().cpu().numpy(), low_res.float().cpu().numpy()
