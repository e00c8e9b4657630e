"""NDT odometry fused with the ESKF (port of the single-sequence part of
``toyslam_tpu/pipelines/fusion.py``).

The scan-matching front end (``pipelines/odometry.ndt_odometry``, K2/K3
under the shipped config) gives a position fix a scan; the ESKF
(``estimators/eskf.eskf_run``) fuses those fixes with the IMU stream: the
reference's ``ndt_rosbag_mapping_node`` + ``uwb_imu_EKF_node`` graph as
one call. The fleet (``fleet_fusion``) is not ported yet.
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


class FusionOutput(NamedTuple):
    poses: torch.Tensor  # [S, 4, 4] NDT odometry poses (host)
    fused_p: torch.Tensor  # [T, 3] ESKF positions (T = S * imu_per_scan)
    fused_v: torch.Tensor  # [T, 3]
    fused_q: torch.Tensor  # [T, 4]
    converged: torch.Tensor  # [S] (host)
    # The whole odometry output: iterations, evaluations, host syncs.
    odometry: odo.OdometryOutput


def ndt_eskf_fusion(scans_xyzi, scans_mask, imu_acc, imu_gyro, imu_dt,
                    config: FusionConfig = FusionConfig()) -> FusionOutput:
    """Odometry over the scan stack, then one ESKF pass over the IMU stream
    with scan i's position fix (where its align converged) at IMU tick
    ``(i + 1) * imu_per_scan - 1``.

    scans ``[S, N, 4]`` / ``[S, N]``; imu ``[T, 3]``, ``[T, 3]``, ``[T]``
    on the device the filter runs on.
    """
    S = scans_xyzi.shape[0]
    T = imu_acc.shape[0]
    dtype, dev = imu_acc.dtype, imu_acc.device
    out = odo.ndt_odometry(scans_xyzi, scans_mask, config.odometry)
    fixes = out.poses[:, :3, 3].to(dev, dtype, non_blocking=True)
    conv = out.converged.to(dev, non_blocking=True)
    idx = ((torch.arange(S, device=dev) + 1) * config.imu_per_scan - 1
           ).clamp(max=T - 1)
    meas = torch.zeros((T, 3), dtype=dtype, device=dev).index_copy(
        0, idx, fixes)
    meas_valid = torch.zeros((T,), dtype=torch.bool, device=dev).index_copy(
        0, idx, conv)
    log = eskf.ESKFLog(dt=imu_dt, acc=imu_acc, gyro=imu_gyro, meas=meas,
                       meas_valid=meas_valid)
    _, traj = eskf.eskf_run(log, None, config.eskf)
    return FusionOutput(poses=out.poses, fused_p=traj["p"],
                        fused_v=traj["v"], fused_q=traj["q"],
                        converged=out.converged, odometry=out)
