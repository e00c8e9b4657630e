"""Configuration files (port of ``toyslam_tpu/config.py``).

A config file is a JSON object of ``{kind: {param: value}}`` sections, as
the JAX package reads and writes them (``configs/example.json``). The
port's registry has every section of the JAX package's (``SECTIONS``):
``load`` reads a whole file, ``load_section`` one section, ``save``
writes ``{kind: config}``, ``to_dict`` and ``from_dict`` convert, and
``default`` is a kind's default. Unspecified parameters keep their
defaults, an unknown section or parameter raises, a JSON list becomes a
tuple where the default is one, and the JAX package's TPU dispatch knobs
(``use_pallas``, ``repack_pallas``, ``use_pallas_nn``,
``use_pallas_terms``, ``use_pallas_cov``, ``nn_mode``), which have no
counterpart, are skipped on load.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from toyslam_tpu_torch.estimators.eskf import ESKFParams
from toyslam_tpu_torch.estimators.preintegration import PreintegrationParams
from toyslam_tpu_torch.estimators.trilateration import TrilaterationConfig
from toyslam_tpu_torch.estimators.window import WindowConfig
from toyslam_tpu_torch.gnss.pipeline import EpochConfig
from toyslam_tpu_torch.gnss.raim import RaimConfig
from toyslam_tpu_torch.pipelines.batch_fusion import BatchFusionConfig
from toyslam_tpu_torch.pipelines.fusion import FusionConfig
from toyslam_tpu_torch.pipelines.icp_slam import IcpSlamConfig
from toyslam_tpu_torch.pipelines.loam import LoamConfig
from toyslam_tpu_torch.pipelines.odometry import OdometryConfig
from toyslam_tpu_torch.registration.gicp import GICPConfig
from toyslam_tpu_torch.registration.icp import ICPConfig
from toyslam_tpu_torch.registration.ndt import NDTConfig
from toyslam_tpu_torch.sim.gps import GpsSimConfig
from toyslam_tpu_torch.sim.sensors import ImuSimParams

_JAX_DISPATCH = frozenset({"use_pallas", "repack_pallas", "use_pallas_nn",
                           "use_pallas_terms", "use_pallas_cov", "nn_mode"})
SECTIONS = {
    "ndt": NDTConfig,
    "icp": ICPConfig,
    "gicp": GICPConfig,
    "odometry": OdometryConfig,
    "loam": LoamConfig,
    "icp_slam": IcpSlamConfig,
    "fusion": FusionConfig,
    "batch_fusion": BatchFusionConfig,
    "eskf": ESKFParams,
    "preintegration": PreintegrationParams,
    "trilateration": TrilaterationConfig,
    "window": WindowConfig,
    "raim": RaimConfig,
    "gnss_epoch": EpochConfig,
    "imu_sim": ImuSimParams,
    "gps_sim": GpsSimConfig,
}


def _is_config(value) -> bool:
    return hasattr(value, "_fields") and hasattr(value, "_replace")


def to_dict(config) -> dict:
    """A config (a NamedTuple, nested) as a plain nested dict."""
    return {f: to_dict(v) if _is_config(v) else v
            for f, v in zip(config._fields, config)}


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
        if _is_config(cur) and isinstance(val, dict):
            val = from_dict(type(cur), val)
        elif isinstance(cur, tuple) and not _is_config(cur):
            val = tuple(val)
        updates[key] = val
    return base._replace(**updates)


def load(path: str | Path) -> dict:
    """Every section of a config file as ``{kind: config}``; an unknown
    section raises."""
    out = {}
    for kind, params in json.loads(Path(path).read_text()).items():
        if kind not in SECTIONS:
            raise KeyError(f"unknown config section '{kind}'; known: "
                           f"{sorted(SECTIONS)}")
        out[kind] = from_dict(SECTIONS[kind], params)
    return out


def save(path: str | Path, configs: dict) -> None:
    """``{kind: config}`` as a config file (the JAX package's layout)."""
    Path(path).write_text(json.dumps(
        {k: to_dict(v) for k, v in configs.items()}, indent=2,
        sort_keys=True))


def default(kind: str):
    """The default config of a kind."""
    return SECTIONS[kind]()


def load_section(path: str | Path, kind: str):
    """The ``kind`` section of a config file as its config (one of
    ``SECTIONS``)."""
    return from_dict(SECTIONS[kind], json.loads(Path(path).read_text())[kind])


def load_odometry(path: str | Path) -> OdometryConfig:
    """The ``odometry`` section of a config file as an OdometryConfig."""
    return load_section(path, "odometry")
