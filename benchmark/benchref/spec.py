"""The model and pipeline settings a configuration file states, as the plain
reference reads them (plain attributes; nothing of the measured program)."""

from __future__ import annotations

from types import SimpleNamespace


def sam_spec(d: dict) -> SimpleNamespace:
    s = SimpleNamespace(**d)
    s.encoder_global_idx = tuple(s.encoder_global_idx)
    s.embed_grid = s.img_size // s.patch_size
    s.num_mask_tokens = s.num_multimask_outputs + 1
    return s


def clip_spec(d: dict) -> SimpleNamespace:
    s = SimpleNamespace(**d)
    s.grid = s.image_size // s.patch_size
    s.seq_len = s.grid * s.grid + 1
    return s
