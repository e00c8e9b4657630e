"""Configuration files (the part of ``toyslam_tpu/config.py`` the port
runs).

A config file is a JSON object of ``{kind: {param: value}}`` sections, as
the JAX package reads and writes them (``configs/example.json``). The port
reads its ``odometry``, ``loam``, ``window``, ``preintegration``,
``batch_fusion``, ``raim``, ``gnss_epoch`` and ``gps_sim`` sections under
those names; unspecified parameters keep
their defaults, an unknown one raises, a JSON list becomes a tuple where
the default is one, and the JAX package's TPU dispatch knobs
(``use_pallas``, ``repack_pallas``), which have no counterpart, are
skipped.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from toyslam_tpu_torch.estimators.preintegration import PreintegrationParams
from toyslam_tpu_torch.gnss.pipeline import EpochConfig
from toyslam_tpu_torch.gnss.raim import RaimConfig
from toyslam_tpu_torch.estimators.window import WindowConfig
from toyslam_tpu_torch.pipelines.batch_fusion import BatchFusionConfig
from toyslam_tpu_torch.pipelines.loam import LoamConfig
from toyslam_tpu_torch.pipelines.odometry import OdometryConfig
from toyslam_tpu_torch.sim.gps import GpsSimConfig

_JAX_DISPATCH = frozenset({"use_pallas", "repack_pallas"})
SECTIONS = {
    "odometry": OdometryConfig,
    "loam": LoamConfig,
    "window": WindowConfig,
    "preintegration": PreintegrationParams,
    "batch_fusion": BatchFusionConfig,
    "raim": RaimConfig,
    "gnss_epoch": EpochConfig,
    "gps_sim": GpsSimConfig,
}


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
        if hasattr(cur, "_fields") and isinstance(val, dict):
            val = from_dict(type(cur), val)
        elif isinstance(cur, tuple) and not hasattr(cur, "_fields"):
            val = tuple(val)
        updates[key] = val
    return base._replace(**updates)


def load_section(path: str | Path, kind: str):
    """The ``kind`` section of a config file as its config (one of
    ``SECTIONS``)."""
    return from_dict(SECTIONS[kind], json.loads(Path(path).read_text())[kind])


def load_odometry(path: str | Path) -> OdometryConfig:
    """The ``odometry`` section of a config file as an OdometryConfig."""
    return load_section(path, "odometry")
