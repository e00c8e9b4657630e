"""Factor library of the sliding-window smoother (port of
``toyslam_tpu/estimators/factors.py``).

After the Ceres factors of ``uwb_imu_batch_node.cpp:27-533, 1070-1336``:
the 15-dim IMU factor with bias-corrected preintegrated deltas and
sqrt-information whitening, UWB/GPS position and velocity factors, and
the soft constraints (bias magnitude ``:106-145``, velocity magnitude
``:148-181``, roll/pitch prior ``:220-250``, orientation smoothness
``:252-294``, gravity alignment ``:296-334``, GPS attitude and heading
``:336-470``). Every factor is a pure residual function of one or two
states, as the window differentiates them with ``torch.func.jacfwd``;
where the JAX package vmaps a factor over the window, these take leading
batch dimensions.

A state is p [..., 3], q [..., 4] (wxyz, world <- body), v, ba, bg
[..., 3]; the tangent is 15-dim [dp, dtheta, dv, dba, dbg] with a
right-multiplied attitude error (``PoseParameterization::Plus``,
``:32-68``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.estimators.preintegration import Preintegrated

GRAVITY = 9.81  # world gravity is [0, 0, -GRAVITY]
# The world gravity acceleration as a vector, f64 on the host: move it to
# the data's device and dtype with ``GRAVITY_W.to(x)``.
GRAVITY_W = torch.tensor([0.0, 0.0, -GRAVITY], dtype=torch.float64)


class NavState(NamedTuple):
    p: torch.Tensor  # [..., 3]
    q: torch.Tensor  # [..., 4] wxyz, world <- body
    v: torch.Tensor  # [..., 3]
    ba: torch.Tensor  # [..., 3]
    bg: torch.Tensor  # [..., 3]


def _mv(A, x):
    """A [..., m, n] @ x [..., n]."""
    return (A @ x[..., None])[..., 0]


def state_boxplus(s: NavState, delta) -> NavState:
    """s [+] delta with delta = [dp, dtheta, dv, dba, dbg] [..., 15]."""
    return NavState(p=s.p + delta[..., 0:3],
                    q=se3.quat_boxplus(s.q, delta[..., 3:6]),
                    v=s.v + delta[..., 6:9],
                    ba=s.ba + delta[..., 9:12],
                    bg=s.bg + delta[..., 12:15])


def quat_error(q_a, q_b):
    """2 vec(q_a^-1 q_b), on the short geodesic: the small-angle attitude
    residual."""
    dq = se3.quat_multiply(se3.quat_conjugate(q_a), q_b)
    w, v = dq[..., 0], dq[..., 1:4]
    sign = torch.sign(torch.where(w == 0, torch.ones_like(w), w))
    return (v + v) * sign[..., None]  # 2 v, bit for bit


def imu_residual(s_i: NavState, s_j: NavState, preint: Preintegrated,
                 dt, lin_ba, lin_bg):
    """Preintegration factor residual (ImuFactor, ``:1101-1304``), [...,
    15]. The deltas, integrated with the biases ``lin_ba``/``lin_bg``, are
    corrected to first order to the current estimate. The preintegrator
    compensates gravity with the start attitude (``:3905-3915``), so the
    deltas exclude it."""
    db = torch.cat([s_i.ba - lin_ba, s_i.bg - lin_bg], -1)
    corr = _mv(preint.jacobian_bias, db)
    dp_corr = preint.delta_p + corr[..., 0:3]
    dv_corr = preint.delta_v + corr[..., 3:6]
    dq_corr = se3.quat_boxplus(preint.delta_q, corr[..., 6:9])
    R_i_T = se3.quat_to_rot(se3.quat_conjugate(s_i.q))
    r_p = _mv(R_i_T, s_j.p - s_i.p - s_i.v * dt[..., None]) - dp_corr
    r_q = quat_error(se3.quat_multiply(s_i.q, dq_corr), s_j.q)
    r_v = _mv(R_i_T, s_j.v - s_i.v) - dv_corr
    return torch.cat([r_p, r_q, r_v, s_j.ba - s_i.ba, s_j.bg - s_i.bg], -1)


def imu_sqrt_info(preint: Preintegrated, bias_walk_std=(0.01, 0.001)):
    """(U [..., 9, 9], ba_w [...], bg_w [...]): the whitener of the 9x9
    preintegration covariance and the bias-walk weights (``:1240-1270``
    region).

    cov = L L^T, U = L^-1 by a triangular solve (no explicit inverse; the
    jitter floor scales with the covariance). Where the Cholesky fails,
    JAX's factor is NaN and becomes the identity; ``cholesky_ex`` leaves a
    partial factor and sets ``info``, which selects the identity here. No
    host synchronisation.
    """
    cov0 = preint.covariance
    eye9 = torch.eye(9, dtype=cov0.dtype, device=cov0.device)
    scale = torch.clamp(torch.diagonal(cov0, dim1=-2, dim2=-1).sum(-1) / 9.0,
                        min=1e-14)
    cov = (0.5 * (cov0 + cov0.mT)
           + (1e-6 * scale + 1e-14)[..., None, None] * eye9)
    L, info = torch.linalg.cholesky_ex(cov)
    L = torch.where(torch.isfinite(L) & (info == 0)[..., None, None], L, eye9)
    U = torch.linalg.solve_triangular(L, eye9.expand(L.shape), upper=False)
    walk = torch.sqrt(torch.clamp(preint.sum_dt, min=1e-3))
    return U, 1.0 / (bias_walk_std[0] * walk), 1.0 / (bias_walk_std[1] * walk)


def position_residual(s: NavState, meas_p, weight):
    """UWB/GPS position factor (``:1070-1099``, ``:473-505``)."""
    return (s.p - meas_p) * weight


def velocity_residual(s: NavState, meas_v, weight):
    """GPS velocity factor (``:507-533``)."""
    return (s.v - meas_v) * weight


def bias_magnitude_residual(s: NavState, acc_w=1.0, gyro_w=10.0):
    """Soft zero-bias pull (BiasMagnitudeConstraint, ``:106-145``)."""
    return torch.cat([s.ba * acc_w, s.bg * gyro_w], -1)


def _safe_norm(v, eps=1e-12):
    """Norm over the last axis with a zero derivative at v = 0."""
    return torch.sqrt((v * v).sum(-1) + eps)


# The weights, caps and ``eps`` of the factors below may be Python numbers
# or 0-d tensors: the window passes tensors, since torch.func differentiates
# an operation between a tensor and a Python number through a slow
# decomposition.


def velocity_magnitude_residual(s: NavState, max_velocity=5.0, weight=1.0,
                                eps=1e-12):
    """Speed beyond a cap (VelocityMagnitudeConstraint, ``:148-181``),
    [..., 1]."""
    excess = torch.clamp(_safe_norm(s.v, eps) - max_velocity, min=0.0)
    return (excess * weight)[..., None]


def horizontal_velocity_incentive_residual(s: NavState, min_speed=0.1,
                                           weight=0.1, eps=1e-12):
    """Horizontal speed below a floor (``:183-218``), [..., 1]."""
    deficit = torch.clamp(min_speed - _safe_norm(s.v[..., :2], eps), min=0.0)
    return (deficit * weight)[..., None]


def roll_pitch_prior_residual(s: NavState, weight=1.0):
    """Tilt of the body z-axis from world up (RollPitchPriorFactor,
    ``:220-250``), [..., 2]."""
    return se3.quat_to_rot(s.q)[..., :2, 2] * weight


def orientation_smoothness_residual(s_i: NavState, s_j: NavState,
                                    weight=1.0):
    """Small relative rotation between neighbours (``:252-294``)."""
    return quat_error(s_i.q, s_j.q) * weight


def gravity_alignment_residual(s: NavState, mean_acc_body, weight=1.0,
                               eps=1e-12, gravity=GRAVITY):
    """Accelerometer direction against -gravity in the body frame
    (GravityAlignmentFactor, ``:296-334``)."""
    R_T = se3.quat_to_rot(se3.quat_conjugate(s.q))
    g_body = R_T[..., :, 2] * gravity  # R^T (0, 0, g)
    a = mean_acc_body - s.ba
    a_dir = a / _safe_norm(a, eps)[..., None]
    g_dir = g_body / _safe_norm(g_body, eps)[..., None]
    return (a_dir - g_dir) * weight


def gps_orientation_residual(s: NavState, meas_q, weight=1.0):
    """GPS attitude factor (GpsOrientationFactor, ``:421-470``) in the
    small-angle form 2 vec(q^-1 q_meas)."""
    return quat_error(s.q, meas_q) * weight


def yaw_only_orientation_residual(s: NavState, meas_yaw, weight=1.0):
    """GPS heading factor (YawOnlyOrientationFactor, ``:336-470``), [...,
    1]."""
    R = se3.quat_to_rot(s.q)
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    d = torch.remainder(yaw - meas_yaw + math.pi, 2 * math.pi) - math.pi
    return (d * weight)[..., None]
