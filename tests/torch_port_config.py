"""Config bridge for the parity tests: the port keeps its own copy of
``core/config.py``, so a test that feeds both packages builds the
reference's config and converts it field by field."""

import dataclasses

import hybridgl_tpu_torch.core.config as port_config


def to_port(cfg):
    """The port's config object holding the same field values as the
    reference's ``cfg`` (nested dataclasses and tuples included)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cls = getattr(port_config, type(cfg).__name__)
        return cls(**{f.name: to_port(getattr(cfg, f.name)) for f in dataclasses.fields(cfg) if f.init})
    if isinstance(cfg, tuple):
        return tuple(to_port(v) for v in cfg)
    return cfg
