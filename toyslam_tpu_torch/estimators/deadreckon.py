"""IMU dead reckoning with stationary calibration and ZUPT-style damping
(port of ``toyslam_tpu/estimators/deadreckon.py``).

After ``lidar_subscriber/src/test.cpp``: gravity calibration at rest with
the initial attitude from the gravity direction (``:201-254``),
first-order quaternion gyro integration (``:256-273``), and
gravity-removed double integration with a low-pass velocity filter and
zero-velocity damping (``:274-314``). As in the JAX package, gravity is
removed with the physically right sign (the reference adds it,
``:282-284``). JAX's ``lax.scan`` is a host loop over the samples; no
step reads a value from the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3

GRAVITY = 9.81


class DeadReckonParams(NamedTuple):
    gravity_magnitude: float = GRAVITY
    velocity_filter_alpha: float = 0.1  # (:289-291)
    zupt_accel_threshold: float = 0.05  # (:295)
    zupt_count_threshold: int = 50  # ~0.5 s at 100 Hz (:299)
    zupt_decay: float = 0.8  # (:301)
    zupt_stop_speed: float = 0.01  # (:302)


def calibrate_stationary(acc_samples, gyro_samples,
                         params: DeadReckonParams = DeadReckonParams()):
    """Calibration at rest (``performInitialCalibration``, ``:201-254``):
    (gyro_bias [3], accel_bias [3], q0 [4] world <- body), q0 turning the
    measured gravity direction onto world up (yaw unobservable)."""
    gyro_bias = gyro_samples.mean(0)
    gravity_vec = acc_samples.mean(0)
    g_dir = gravity_vec / torch.clamp(torch.linalg.norm(gravity_vec),
                                      min=1e-9)
    accel_bias = gravity_vec - g_dir * params.gravity_magnitude
    eye = torch.eye(4, dtype=acc_samples.dtype, device=acc_samples.device)
    z_axis = eye[3, 1:]
    axis = torch.linalg.cross(g_dir, z_axis)
    axis_n = torch.linalg.norm(axis)
    angle = torch.arccos(torch.clamp(g_dir @ z_axis, -1.0, 1.0))
    q0 = torch.where(axis_n < 1e-6, eye[0],
                     se3.quat_from_axis_angle(
                         axis / torch.clamp(axis_n, min=1e-9), angle))
    return gyro_bias, accel_bias, q0


class DeadReckonState(NamedTuple):
    p: torch.Tensor
    v: torch.Tensor
    q: torch.Tensor
    zupt_count: torch.Tensor


def dead_reckon(acc, gyro, dt, gyro_bias, accel_bias, q0,
                params: DeadReckonParams = DeadReckonParams()):
    """Integrate an IMU stream ``acc``/``gyro [T, 3]``, ``dt [T]``; returns
    the stacked (p [T, 3], v [T, 3], q [T, 4])."""
    dtype, dev = acc.dtype, acc.device
    eye = torch.eye(4, dtype=dtype, device=dev)
    ident, g_up = eye[0], eye[3, 1:] * params.gravity_magnitude
    s = DeadReckonState(p=torch.zeros(3, dtype=dtype, device=dev),
                        v=torch.zeros(3, dtype=dtype, device=dev),
                        q=q0.to(dtype),
                        zupt_count=torch.zeros((), dtype=torch.int32,
                                               device=dev))
    ps, vs, qs = [], [], []
    for k in range(acc.shape[0]):
        h = dt[k]
        w_u = gyro[k] - gyro_bias
        a_u = acc[k] - accel_bias

        # Orientation (first-order quaternion integration, :256-273)
        w_n = torch.linalg.norm(w_u)
        angle = w_n * h
        dq = torch.where(angle < 1e-10, ident, se3.quat_from_axis_angle(
            w_u / torch.clamp(w_n, min=1e-12), angle))
        q = se3.quat_normalize(se3.quat_multiply(s.q, dq))

        # Acceleration integration with gravity removal (:274-314)
        a_world = se3.quat_rotate(q, a_u) - g_up
        alpha = params.velocity_filter_alpha
        v = (s.v + a_world * h) * (1.0 - alpha) + s.v * alpha

        # ZUPT
        quasi_static = torch.linalg.norm(a_world) < params.zupt_accel_threshold
        cnt = torch.where(quasi_static, s.zupt_count + 1,
                          torch.zeros_like(s.zupt_count))
        over = cnt > params.zupt_count_threshold
        damped = torch.where(over, v * params.zupt_decay, v)
        stopped = torch.linalg.norm(damped) < params.zupt_stop_speed
        v = torch.where(over & stopped, torch.zeros_like(v), damped)

        p = s.p + v * h
        s = DeadReckonState(p=p, v=v, q=q, zupt_count=cnt)
        ps.append(p)
        vs.append(v)
        qs.append(q)
    return torch.stack(ps), torch.stack(vs), torch.stack(qs)
