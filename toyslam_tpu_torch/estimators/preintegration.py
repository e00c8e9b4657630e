"""IMU preintegration (midpoint rule) with covariance and bias Jacobians
(port of ``toyslam_tpu/estimators/preintegration.py``).

After the reference's keyframe preintegrator (``uwb_imu_batch_node.cpp:
3814-3974``): midpoint integration of the delta position, velocity and
orientation between keyframes, the 9x9 covariance through F and G, the
9x6 bias Jacobian, optional gravity compensation in the start frame
(``:3905-3915``) and the per-sample dt gates (``:3820-3824``), with the
JAX package's corrections of the reference's F and bias Jacobian.

JAX's ``lax.scan`` over the samples is a host loop over them; an invalid
(padded or out-of-range) sample selects the old state with
``torch.where``, so a chunk makes no host synchronisation. Every input
may carry leading batch dimensions (``acc [..., T, 3]``, ``dt [..., T]``,
biases and gravity ``[..., 3]``): the chunks of a batch integrate in the
same operations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3


class PreintegrationParams(NamedTuple):
    """Noise defaults of the batch node (``:1343-1439`` region)."""

    acc_noise: float = 0.05
    gyro_noise: float = 0.01
    acc_bias_noise: float = 0.001
    gyro_bias_noise: float = 0.0001
    min_integration_dt: float = 1e-6  # skip gate (``:3820``)
    max_imu_dt: float = 0.5  # skip gate (``:3820``)


class Preintegrated(NamedTuple):
    delta_p: torch.Tensor  # [..., 3]
    delta_v: torch.Tensor  # [..., 3]
    delta_q: torch.Tensor  # [..., 4] (Hamilton wxyz)
    covariance: torch.Tensor  # [..., 9, 9] over (p, v, theta)
    jacobian_bias: torch.Tensor  # [..., 9, 6] d(p, v, theta)/d(ba, bg)
    sum_dt: torch.Tensor  # [...]


def _diag6(a, b, like):
    """diag(a, a, a, b, b, b) on ``like``'s dtype and device."""
    eye = torch.eye(6, dtype=like.dtype, device=like.device)
    return eye * torch.cat([eye[0, :3] * 0 + a, eye[0, :3] * 0 + b])


def preintegrate(acc, gyro, dt, acc_bias, gyro_bias, gravity_sensor=None,
                 params: PreintegrationParams = PreintegrationParams(),
                 valid=None) -> Preintegrated:
    """Integrate a padded IMU chunk into one relative-motion factor.

    ``acc``/``gyro [..., T, 3]`` are consecutive samples, ``dt [..., T]``
    the step to the next one; each step takes the midpoint of a sample and
    the next valid one (zero-order hold before a hole). ``gravity_sensor
    [..., 3]`` is gravity in the start frame, or None for none.
    """
    dtype, dev = acc.dtype, acc.device
    T = acc.shape[-2]
    if valid is None:
        valid = torch.ones(dt.shape, dtype=torch.bool, device=dev)
    batch = dt.shape[:-1]

    acc1 = acc - acc_bias[..., None, :]
    gyro1 = gyro - gyro_bias[..., None, :]
    valid_next = torch.cat([valid[..., 1:], valid[..., -1:]], -1)[..., None]
    acc2 = torch.where(valid_next,
                       torch.cat([acc1[..., 1:, :], acc1[..., -1:, :]], -2),
                       acc1)
    gyro2 = torch.where(valid_next,
                        torch.cat([gyro1[..., 1:, :], gyro1[..., -1:, :]],
                                  -2), gyro1)
    if gravity_sensor is None:
        gravity_sensor = torch.zeros(3, dtype=dtype, device=dev)

    eye9 = torch.eye(9, dtype=dtype, device=dev)
    eye3 = eye9[:3, :3]
    ident = eye9[0, :4]
    noise_cov = _diag6(params.acc_noise**2, params.gyro_noise**2, acc)
    bias_cov = _diag6(params.acc_bias_noise**2, params.gyro_bias_noise**2,
                      acc)
    G0 = torch.zeros(batch + (9, 6), dtype=dtype, device=dev)
    G0[..., 6:9, 3:6] = eye3

    dp = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    dv = dp.clone()
    q = ident.expand(batch + (4,)).clone()
    cov = torch.zeros(batch + (9, 9), dtype=dtype, device=dev)
    Jb = torch.zeros(batch + (9, 6), dtype=dtype, device=dev)
    sum_dt = torch.zeros(batch, dtype=dtype, device=dev)
    for k in range(T):
        a1, a2 = acc1[..., k, :], acc2[..., k, :]
        g1, g2 = gyro1[..., k, :], gyro2[..., k, :]
        sdt = dt[..., k]
        ok = (valid[..., k] & (sdt > params.min_integration_dt)
              & (sdt <= params.max_imu_dt))
        sdt = torch.where(ok, sdt, torch.zeros_like(sdt))
        dtv, dtm = sdt[..., None], sdt[..., None, None]

        # delta rotation over the step (trapezoidal gyro)
        w = 0.5 * (g1 + g2) * dtv
        theta = torch.linalg.norm(w, dim=-1)
        small = (theta <= 1e-8)[..., None]
        safe = torch.where(small, torch.ones_like(theta[..., None]),
                           theta[..., None])
        dq = torch.where(small, ident, se3.quat_from_axis_angle(w / safe,
                                                                theta))
        q_new = se3.quat_normalize(se3.quat_multiply(q, dq))
        q_half = se3.quat_slerp(q, q_new, 0.5)
        R_half = se3.quat_to_rot(q_half)

        a1g = a1 + gravity_sensor
        a2g = a2 + gravity_sensor
        a_int = 0.5 * ((R_half @ a1g[..., None])[..., 0]
                       + (R_half @ a2g[..., None])[..., 0])
        v_new = dv + a_int * dtv
        v_mid = v_new - 0.5 * a_int * dtv
        p_new = dp + v_mid * dtv

        # F/G over the error state (dp, dv, dtheta) with a right-multiplied
        # attitude error: the JAX package's correction of ``:3930-3959``.
        a_mid = 0.5 * (a1g + a2g)
        RS = R_half @ se3.skew(a_mid)
        F = eye9.expand(batch + (9, 9)).clone()
        F[..., 0:3, 3:6] = eye3 * dtm
        F[..., 0:3, 6:9] = -0.5 * RS * dtm * dtm
        F[..., 3:6, 6:9] = -RS * dtm
        F[..., 6:9, 6:9] = se3.so3_exp(-w)
        G = G0.clone()
        G[..., 3:6, 0:3] = R_half

        # Bias Jacobians: J' = F J + dF/db (within-step terms)
        dF_db = torch.zeros(batch + (9, 6), dtype=dtype, device=dev)
        dF_db[..., 0:3, 0:3] = -0.5 * R_half * dtm * dtm
        dF_db[..., 3:6, 0:3] = -R_half * dtm
        dF_db[..., 6:9, 3:6] = -dtm * eye3
        dF_db[..., 3:6, 3:6] = 0.5 * RS * dtm * dtm
        dF_db[..., 0:3, 3:6] = 0.25 * RS * dtm**3

        J_new = F @ Jb + dF_db
        cov_new = (F @ cov @ F.mT + G @ noise_cov @ G.mT
                   + J_new @ (bias_cov * dtm) @ J_new.mT)

        okv, okm = ok[..., None], ok[..., None, None]
        dp = torch.where(okv, p_new, dp)
        dv = torch.where(okv, v_new, dv)
        q = torch.where(okv, q_new, q)
        cov = torch.where(okm, cov_new, cov)
        Jb = torch.where(okm, J_new, Jb)
        sum_dt = sum_dt + sdt

    # Covariance diagonal floor (``:3986-3989``)
    cov = cov.clone()
    cov.diagonal(dim1=-2, dim2=-1).clamp_(min=1e-8)
    return Preintegrated(dp, dv, q, cov, Jb, sum_dt)


def correct_for_bias_change(preint: Preintegrated, dba, dbg) -> Preintegrated:
    """First-order correction of the deltas for a changed bias estimate
    (the ImuFactor's, ``uwb_imu_batch_node.cpp:1130-1160`` region)."""
    db = torch.cat([dba, dbg], -1)
    corr = (preint.jacobian_bias @ db[..., None])[..., 0]
    return preint._replace(
        delta_p=preint.delta_p + corr[..., 0:3],
        delta_v=preint.delta_v + corr[..., 3:6],
        delta_q=se3.quat_boxplus(preint.delta_q, corr[..., 6:9]))


def synthesize_imu_gap(start_state_q, start_v, end_state_q, end_v, dt_total,
                       n_samples: int, gravity_world=None):
    """Constant-rate IMU samples for a buffer gap (the batch node's
    synthetic-IMU fallback, ``uwb_imu_batch_node.cpp:3646-3781``): gyro
    from the relative rotation, acceleration from the velocity change plus
    the gravity reaction in the body frame. Quaternions [..., 4],
    velocities [..., 3], ``dt_total`` a tensor [...]. Returns (acc [...,
    n, 3], gyro [..., n, 3], dts [..., n])."""
    dtype, dev = start_v.dtype, start_v.device
    if gravity_world is None:
        gravity_world = torch.eye(3, dtype=dtype, device=dev)[2] * -9.81
    batch = start_v.shape[:-1]
    dq = se3.quat_multiply(se3.quat_conjugate(start_state_q), end_state_q)
    dq = torch.where(dq[..., :1] < 0, -dq, dq)
    angle = 2.0 * torch.arccos(torch.clamp(dq[..., 0], -1.0, 1.0))
    axis_n = torch.linalg.norm(dq[..., 1:4], dim=-1, keepdim=True)
    axis = dq[..., 1:4] / torch.clamp(axis_n, min=1e-9)
    omega = torch.where(axis_n > 1e-9,
                        axis * angle[..., None] / dt_total[..., None],
                        torch.zeros_like(axis))
    a_world = (end_v - start_v) / dt_total[..., None] - gravity_world
    R_T = se3.quat_to_rot(se3.quat_conjugate(start_state_q))
    a_body = (R_T @ a_world[..., None])[..., 0]
    acc = a_body[..., None, :].expand(batch + (n_samples, 3))
    gyro = omega[..., None, :].expand(batch + (n_samples, 3))
    dts = (dt_total / n_samples)[..., None].expand(batch + (n_samples,))
    return acc, gyro, dts


def bias_change_exceeds(preint: Preintegrated, old_ba, old_bg, new_ba,
                        new_bg, threshold: float = 0.05):
    """Whether the linearisation bias moved more than ``threshold``
    (``uwb_imu_batch_node.cpp:3563-3582``): a 0-d bool tensor."""
    d = torch.maximum(torch.abs(new_ba - old_ba).amax(),
                      torch.abs(new_bg - old_bg).amax())
    return d > threshold
