"""Carry the JAX package's state across to the port.

Takes plain numpy data (``NDTMap._asdict()``, a PointCloud's arrays, the
configs' ``_asdict()``, the odometry and mapping states' fields) and
returns the port's objects, so that one map, cloud or pipeline state built
by either package can feed both. Tensors go to the card unless
``device`` names another; without a card the default raises. Imports
nothing of JAX: callers convert their arrays with ``numpy.asarray`` first.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from toyslam_tpu_torch.core.pointcloud import PointCloud
from toyslam_tpu_torch.estimators.eskf import ESKFParams, ESKFState
from toyslam_tpu_torch.estimators.factors import NavState
from toyslam_tpu_torch.estimators.preintegration import (PreintegrationParams,
                                                          Preintegrated)
from toyslam_tpu_torch.estimators.trilateration import TrilaterationConfig
from toyslam_tpu_torch.estimators.window import SlidingWindow, WindowConfig
from toyslam_tpu_torch.gnss.atmosphere import IonoParams
from toyslam_tpu_torch.gnss.ephemeris import GpsEphemeris
from toyslam_tpu_torch.gnss.pipeline import EphemerisStore, EpochConfig
from toyslam_tpu_torch.gnss.raim import RaimConfig
from toyslam_tpu_torch.pipelines.batch_fusion import BatchFusionConfig
from toyslam_tpu_torch.pipelines.fusion import FusionConfig
from toyslam_tpu_torch.pipelines.icp_slam import IcpSlamConfig
from toyslam_tpu_torch.pipelines.loam import LoamConfig
from toyslam_tpu_torch.pipelines.odometry import (MappingState,
                                                  OdometryConfig,
                                                  OdometryState)
from toyslam_tpu_torch.registration.gicp import GICPConfig
from toyslam_tpu_torch.registration.icp import ICPConfig
from toyslam_tpu_torch.registration.ndt import NDTConfig, NDTMap
from toyslam_tpu_torch.sim.gps import GpsSimConfig
from toyslam_tpu_torch.sim.sensors import ImuSimParams
from toyslam_tpu_torch.sim.urban import Buildings


def _tensor(a, device):
    """A contiguous copy: the port may update its tensors in place, and
    arrays that come from JAX are read-only."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def ndt_map(fields: Mapping, device="cuda") -> NDTMap:
    """``NDTMap._asdict()`` of numpy arrays -> the port's NDTMap."""
    return NDTMap(**{k: _tensor(fields[k], device) for k in NDTMap._fields})


def point_cloud(xyzi, mask, device="cuda") -> PointCloud:
    return PointCloud(_tensor(xyzi, device), _tensor(mask, device))


def _shared_fields(cls, fields: Mapping):
    """Keeps the fields ``cls`` has; the JAX package's TPU dispatch knobs
    (``use_pallas*``, ``repack_pallas``, ``nn_mode``) have no counterpart
    and are dropped."""
    return cls(**{k: fields[k] for k in cls._fields if k in fields})


def ndt_config(fields: Mapping) -> NDTConfig:
    return _shared_fields(NDTConfig, fields)


def icp_config(fields: Mapping) -> ICPConfig:
    return _shared_fields(ICPConfig, fields)


def gicp_config(fields: Mapping) -> GICPConfig:
    return _shared_fields(GICPConfig, fields)


def _fields(x) -> Mapping:
    """A Mapping as it is; a NamedTuple (the JAX package's states, clouds
    and nested configs) as its ``_asdict()``."""
    return x if isinstance(x, Mapping) else x._asdict()


def _nested(cls, fields: Mapping, **subs):
    """``cls`` from the fields it has, each nested config in ``subs``
    (name -> converter) converted from its own fields."""
    out = {k: fields[k] for k in cls._fields if k in fields}
    for name, conv in subs.items():
        if name in out:
            out[name] = conv(_fields(out[name]))
    return cls(**out)


def odometry_config(fields: Mapping) -> OdometryConfig:
    return _nested(OdometryConfig, fields, ndt=ndt_config)


def icp_slam_config(fields: Mapping) -> IcpSlamConfig:
    return _nested(IcpSlamConfig, fields, icp=icp_config)


def eskf_params(fields: Mapping) -> ESKFParams:
    return _shared_fields(ESKFParams, fields)


def fusion_config(fields: Mapping) -> FusionConfig:
    return _nested(FusionConfig, fields, odometry=odometry_config,
                   eskf=eskf_params)


def eskf_state(fields, device="cuda") -> ESKFState:
    """The fields of the JAX ``ESKFState`` -> the port's, on ``device``."""
    fields = _fields(fields)
    return ESKFState(**{k: _tensor(fields[k], device)
                        for k in ESKFState._fields})


def odometry_state(fields, device="cuda") -> OdometryState:
    """The fields of the JAX ``OdometryState`` (``prev_ds`` as a cloud's
    fields, ``pose`` and ``prev_T`` as arrays) -> the port's: the cloud on
    ``device``, the poses on the host, where the port keeps them."""
    fields = _fields(fields)
    prev = _fields(fields["prev_ds"])
    return OdometryState(point_cloud(prev["xyzi"], prev["mask"], device),
                         _tensor(fields["pose"], "cpu"),
                         _tensor(fields["prev_T"], "cpu"))


def mapping_state(fields, device="cuda") -> MappingState:
    """The fields of the JAX ``MappingState`` -> the port's (see
    :func:`odometry_state`; the map cloud on ``device``)."""
    fields = _fields(fields)
    m = _fields(fields["map_cloud"])
    return MappingState(odometry_state(fields["odometry"], device),
                        point_cloud(m["xyzi"], m["mask"], device))


def loam_config(fields: Mapping) -> LoamConfig:
    return _shared_fields(LoamConfig, fields)


def window_config(fields: Mapping) -> WindowConfig:
    return _shared_fields(WindowConfig, fields)


def preintegration_params(fields: Mapping) -> PreintegrationParams:
    return _shared_fields(PreintegrationParams, fields)


def batch_fusion_config(fields: Mapping) -> BatchFusionConfig:
    return _nested(BatchFusionConfig, fields, window=window_config,
                   preint=preintegration_params)


def nav_state(fields, device="cuda") -> NavState:
    """The fields of the JAX ``NavState`` -> the port's, on ``device``."""
    fields = _fields(fields)
    return NavState(**{k: _tensor(fields[k], device)
                       for k in NavState._fields})


def sliding_window(fields, device="cuda") -> SlidingWindow:
    """The fields of the JAX ``SlidingWindow`` (its states, preintegrals
    and prior state as NamedTuples or their fields) -> the port's, on
    ``device``."""
    fields = _fields(fields)
    out = {k: _tensor(fields[k], device) for k in SlidingWindow._fields
           if k not in ("states", "preints", "prior_state")}
    pre = _fields(fields["preints"])
    return SlidingWindow(
        states=nav_state(fields["states"], device),
        preints=Preintegrated(**{k: _tensor(pre[k], device)
                                 for k in Preintegrated._fields}),
        prior_state=nav_state(fields["prior_state"], device), **out)


def epoch_config(fields: Mapping) -> EpochConfig:
    return _shared_fields(EpochConfig, fields)


def raim_config(fields: Mapping) -> RaimConfig:
    return _shared_fields(RaimConfig, fields)


def gps_sim_config(fields: Mapping) -> GpsSimConfig:
    return _shared_fields(GpsSimConfig, fields)


def trilateration_config(fields: Mapping) -> TrilaterationConfig:
    return _shared_fields(TrilaterationConfig, fields)


def imu_sim_params(fields: Mapping) -> ImuSimParams:
    return _shared_fields(ImuSimParams, fields)


def iono_params(fields, device="cuda") -> IonoParams:
    """The fields of the JAX ``IonoParams`` -> the port's (alpha and beta
    on ``device``, ``valid`` a Python bool)."""
    fields = _fields(fields)
    return IonoParams(_tensor(fields["alpha"], device),
                      _tensor(fields["beta"], device),
                      bool(fields.get("valid", True)))


def ephemeris(fields, device="cuda") -> GpsEphemeris:
    """The fields of a JAX ``GpsEphemeris`` -> the port's, on ``device``."""
    fields = _fields(fields)
    return GpsEphemeris(**{k: _tensor(fields[k], device)
                           for k in GpsEphemeris._fields})


def ephemeris_store(fields, device="cuda") -> EphemerisStore:
    """The fields of a JAX ``EphemerisStore`` (its ``eph`` as a
    GpsEphemeris or its fields) -> the port's, on ``device``."""
    return EphemerisStore(ephemeris(_fields(fields)["eph"], device))


def buildings(fields, device="cuda") -> Buildings:
    """The fields of the JAX ``Buildings`` -> the port's, on ``device``."""
    fields = _fields(fields)
    return Buildings(**{k: _tensor(fields[k], device)
                        for k in Buildings._fields})
