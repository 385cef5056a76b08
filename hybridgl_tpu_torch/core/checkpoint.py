"""Parameter trees on disk: the ``.npz`` form of hybridgl_tpu/core/checkpoint.py.

Torch checkpoints are converted once (``core/convert.py``,
``tools/convert_checkpoints.py``) into a numpy archive whose keys are the
'/'-joined tree paths (list indices as digits). The archive is the one the
JAX package's ``checkpoint.save`` writes, so a file serves both packages.
The reference's other form, an orbax directory, is not read by the port.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

ORBAX_REFUSAL = (
    "the port does not read orbax directories: pass a .npz archive (tools/convert_checkpoints.py "
    "writes one) or a torch .pth/.pt checkpoint"
)


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # numpy has no bf16: floating leaves are stored as f32, which holds every bf16 exactly
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _leaf(tree)
    return out


def _unflatten(flat):
    root: Any = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save(path: str, tree) -> None:
    """Save a parameter tree (numpy or tensor leaves) as a ``.npz`` archive."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: {ORBAX_REFUSAL}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def load(path: str):
    """A ``.npz`` archive -> nested dicts and lists of numpy leaves, for
    ``core/params.py:from_numpy_tree``."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: {ORBAX_REFUSAL}")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
