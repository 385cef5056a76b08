"""The port's own copy of ``hybridgl_tpu/utils/env.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

One shared parser for HYBRIDGL_* environment toggles.

Every boolean knob accepts the same spellings: "0"/"false"/"off"/"no"
disable, anything else set enables. Tri-state knobs (e.g.
HYBRIDGL_COMPILE_CACHE, which doubles as a directory path) use
``env_is_falsy`` to recognise an explicit disable before interpreting the
value.
"""

from __future__ import annotations

import os

_FALSY = frozenset({"0", "false", "off", "no"})


def env_is_falsy(value: str) -> bool:
    return value.strip().lower() in _FALSY


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env toggle: unset -> ``default``; set -> False only for
    "0"/"false"/"off"/"no" (case-insensitive), True otherwise."""
    env = os.environ.get(name)
    if env is None:
        return default
    return not env_is_falsy(env)
