"""NDT odometry fused with the ESKF (port of
``toyslam_tpu/pipelines/fusion.py``).

The scan-matching front end (``pipelines/odometry.ndt_odometry``, K2/K3
under the shipped config) gives a position fix a scan; the ESKF
(``estimators/eskf.eskf_run``) fuses those fixes with the IMU stream: the
reference's ``ndt_rosbag_mapping_node`` + ``uwb_imu_EKF_node`` graph as
one call.

The fleet (BASELINE config 5): ``ndt_eskf_fusion_lanes`` runs B
independent sequences at once (lockstep odometry through K1-K3 with a lane
axis, one batched ESKF tick for all lanes), and ``fleet_fusion`` runs a
fleet in sequential chunks of ``chunk`` lanes, as JAX's ``lax.map`` over
``vmap`` groups.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.estimators import eskf
from toyslam_tpu_torch.pipelines import odometry as odo


class FusionConfig(NamedTuple):
    odometry: odo.OdometryConfig = odo.OdometryConfig()
    eskf: eskf.ESKFParams = eskf.ESKFParams(
        acc_noise=0.03, gyro_noise=0.002, meas_noise=0.01)
    imu_per_scan: int = 20  # IMU samples between consecutive scans


# Lanes a fleet runs in lockstep at once (``fleet_fusion``). The JAX
# package's 16 is a TPU gather-footprint figure. On an H100 (700 W) the
# fleet is host-bound, and a wider chunk shares each round's sync and
# launches among more lanes: 55.38 / 84.48 / 123.04 / 140.67 aggregate
# scans/s at chunks 8 / 16 / 32 / 64 for B = 64 (PERF.md, fleet-64,
# ``chip_smoke.py`` phase 24).
FLEET_CHUNK = 64


class FusionOutput(NamedTuple):
    poses: torch.Tensor  # [S, 4, 4] NDT odometry poses (host)
    fused_p: torch.Tensor  # [T, 3] ESKF positions (T = S * imu_per_scan)
    fused_v: torch.Tensor  # [T, 3]
    fused_q: torch.Tensor  # [T, 4]
    converged: torch.Tensor  # [S] (host)
    # The whole odometry output: iterations, evaluations, host syncs.
    odometry: odo.OdometryOutput


def _fused(out: odo.OdometryOutput, imu_acc, imu_gyro, imu_dt,
           config: FusionConfig) -> FusionOutput:
    """One ESKF pass over the IMU stream with scan i's position fix (where
    its align converged) at IMU tick ``(i + 1) * imu_per_scan - 1``; the
    odometry output and the IMU log may carry a leading lane axis."""
    S = out.poses.shape[-3]
    T = imu_acc.shape[-2]
    dtype, dev = imu_acc.dtype, imu_acc.device
    fixes = out.poses[..., :3, 3].to(dev, dtype, non_blocking=True)
    conv = out.converged.to(dev, non_blocking=True)
    idx = ((torch.arange(S, device=dev) + 1) * config.imu_per_scan - 1
           ).clamp(max=T - 1)
    meas = torch.zeros(imu_acc.shape, dtype=dtype, device=dev).index_copy(
        -2, idx, fixes)
    meas_valid = torch.zeros(imu_dt.shape, dtype=torch.bool,
                             device=dev).index_copy(-1, idx, conv)
    log = eskf.ESKFLog(dt=imu_dt, acc=imu_acc, gyro=imu_gyro, meas=meas,
                       meas_valid=meas_valid)
    _, traj = eskf.eskf_run(log, None, config.eskf)
    return FusionOutput(poses=out.poses, fused_p=traj["p"],
                        fused_v=traj["v"], fused_q=traj["q"],
                        converged=out.converged, odometry=out)


def ndt_eskf_fusion(scans_xyzi, scans_mask, imu_acc, imu_gyro, imu_dt,
                    config: FusionConfig = FusionConfig()) -> FusionOutput:
    """Odometry over the scan stack, then one ESKF pass over the IMU stream
    with scan i's position fix (where its align converged) at IMU tick
    ``(i + 1) * imu_per_scan - 1``.

    scans ``[S, N, 4]`` / ``[S, N]``; imu ``[T, 3]``, ``[T, 3]``, ``[T]``
    on the device the filter runs on.
    """
    out = odo.ndt_odometry(scans_xyzi, scans_mask, config.odometry)
    return _fused(out, imu_acc, imu_gyro, imu_dt, config)


def ndt_eskf_fusion_lanes(scans_xyzi, scans_mask, imu_acc, imu_gyro, imu_dt,
                          config: FusionConfig = FusionConfig()
                          ) -> FusionOutput:
    """``ndt_eskf_fusion`` of B lanes at once (``[B, S, N, 4]``, ``[B, S,
    N]``, ``[B, T, 3]``, ``[B, T, 3]``, ``[B, T]``): lockstep odometry
    (``odometry.ndt_odometry_lanes``), then one ESKF pass whose ticks serve
    every lane. A FusionOutput with a leading B; each lane's odometry
    equals the single-lane run bit for bit, its fused track within the
    rounding of a batched matrix product (``tests/test_torch_lanes.py``)."""
    out = odo.ndt_odometry_lanes(scans_xyzi, scans_mask, config.odometry)
    return _fused(out, imu_acc, imu_gyro, imu_dt, config)


def cat_lanes(outs):
    """Lane outputs (NamedTuples, nested, of tensors with a leading lane
    axis) joined along it; each field on its first part's device."""
    first = outs[0]
    if isinstance(first, tuple):
        return type(first)(*(cat_lanes(parts) for parts in zip(*outs)))
    return torch.cat([o.to(first.device) for o in outs])


def fleet_fusion(scans_xyzi, scans_mask, imu_acc, imu_gyro, imu_dt,
                 config: FusionConfig = FusionConfig(),
                 chunk: int = FLEET_CHUNK) -> FusionOutput:
    """A B-lane fleet of independent fusion sequences on one device, in
    sequential chunks of ``chunk`` lanes run in lockstep
    (``ndt_eskf_fusion_lanes``), as JAX's ``lax.map`` over ``vmap``
    groups. A lane's odometry never depends on the chunk; B must be a
    multiple of it."""
    B = scans_xyzi.shape[0]
    if B % chunk:
        raise ValueError(f"fleet width {B} not divisible by chunk {chunk}")
    args = (scans_xyzi, scans_mask, imu_acc, imu_gyro, imu_dt)
    return cat_lanes([
        ndt_eskf_fusion_lanes(*(a[i:i + chunk] for a in args), config=config)
        for i in range(0, B, chunk)])
