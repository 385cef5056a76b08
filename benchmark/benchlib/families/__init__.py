"""The proposal model's family, found by name.

A configuration file names its proposal model's family in its top-level key
``sam_family`` (``vitdet`` where it has none). The family is one adapter
module, ``<name>.py``, of this package's search path (``__path__``); nothing
lists the families, so a new one is a new file. ``benchlib/config.py`` states
what an adapter provides.
"""

from __future__ import annotations

import importlib
import os
import re

DEFAULT = "vitdet"
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load(cfg: dict, file: str | None = None):
    """The adapter module of ``cfg``'s family; ``file``, the configuration's
    file, is named in the error where there is none."""
    name = cfg.get("sam_family", DEFAULT)
    module = f"{__name__}.{name}"
    if isinstance(name, str) and _NAME.match(name):
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    where = " or ".join(os.path.join(p, f"{name}.py") for p in __path__)
    raise LookupError(f"the configuration {file or '(given in place of a file)'} names sam_family {name!r}, "
                      f"but there is no adapter module {module} ({where})")
