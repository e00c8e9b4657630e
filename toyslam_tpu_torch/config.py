"""Configuration files (the odometry part of ``toyslam_tpu/config.py``).

A config file is a JSON object of ``{kind: {param: value}}`` sections, as
the JAX package reads and writes them (``configs/example.json``). The port
reads its ``odometry`` section; unspecified parameters keep their
defaults, an unknown one raises, and the JAX package's TPU dispatch knobs
(``use_pallas``, ``repack_pallas``), which have no counterpart, are
skipped.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from toyslam_tpu_torch.pipelines.odometry import OdometryConfig

_JAX_DISPATCH = frozenset({"use_pallas", "repack_pallas"})


def from_dict(cls, data: dict):
    """A config of type ``cls`` from a (possibly partial) dict."""
    base = cls()
    updates: dict[str, Any] = {}
    for key, val in data.items():
        if key in _JAX_DISPATCH:
            continue
        if key not in cls._fields:
            raise KeyError(f"{cls.__name__} has no parameter '{key}'")
        cur = getattr(base, key)
        updates[key] = (from_dict(type(cur), val)
                        if hasattr(cur, "_fields") and isinstance(val, dict)
                        else val)
    return base._replace(**updates)


def load_odometry(path: str | Path) -> OdometryConfig:
    """The ``odometry`` section of a config file as an OdometryConfig."""
    return from_dict(OdometryConfig,
                     json.loads(Path(path).read_text())["odometry"])
