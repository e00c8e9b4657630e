"""Carry the JAX package's state across to the port.

Takes plain numpy data (``NDTMap._asdict()``, a PointCloud's arrays,
``NDTConfig._asdict()``, ``OdometryConfig._asdict()``) and returns the
port's objects on a given device, so that one map built by either package
can feed both ``ndt_align``s. Imports nothing of JAX: callers convert
their arrays with ``numpy.asarray`` first.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from toyslam_tpu_torch.core.pointcloud import PointCloud
from toyslam_tpu_torch.pipelines.odometry import OdometryConfig
from toyslam_tpu_torch.registration.ndt import NDTConfig, NDTMap


def _tensor(a, device):
    """A contiguous copy: the port may update its tensors in place, and
    arrays that come from JAX are read-only."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def ndt_map(fields: Mapping, device="cpu") -> NDTMap:
    """``NDTMap._asdict()`` of numpy arrays -> the port's NDTMap."""
    return NDTMap(**{k: _tensor(fields[k], device) for k in NDTMap._fields})


def point_cloud(xyzi, mask, device="cpu") -> PointCloud:
    return PointCloud(_tensor(xyzi, device), _tensor(mask, device))


def ndt_config(fields: Mapping) -> NDTConfig:
    """Keeps the shared fields; the TPU dispatch knobs (``use_pallas``,
    ``repack_pallas``) have no counterpart and are dropped."""
    return NDTConfig(**{k: fields[k] for k in NDTConfig._fields
                        if k in fields})


def odometry_config(fields: Mapping) -> OdometryConfig:
    out = {k: fields[k] for k in OdometryConfig._fields if k in fields}
    if "ndt" in out:
        sub = out["ndt"]
        out["ndt"] = ndt_config(sub if isinstance(sub, Mapping)
                                else sub._asdict())
    return OdometryConfig(**out)
