"""Error-state Kalman filter for loosely coupled IMU + position fusion
(port of ``toyslam_tpu/estimators/eskf.py``).

After ``lidar_subscriber/src/uwb_imu_EKF_node.cpp``: nominal state [p(3),
v(3), q(4), b_a(3), b_g(3)] with a 15-dim error state, IMU predict
(``:87-156``), position update with a quaternion boxplus correction
(``:187-225``), and the reference's F/Q structure and default noise
(``:28-33``), with the JAX package's correction of the velocity/attitude
coupling (see :func:`predict`).

``eskf_run`` is JAX's ``lax.scan`` as a host loop over ticks with the
state on the log's device. Every function also takes a leading lane axis
(JAX's ``vmap``; the fleet): a state, a sample and a log of B lanes
(``[B, 3]``, ``[B, 15, 15]``, ``dt`` [B]; a log ``[B, T, ...]``) run
one tick's operations for all lanes at once. No tick waits on the
device: a non-positive
``dt`` and an invalid measurement select the old state with
``torch.where`` (no Python branch on a device value), the 3x3 innovation
inverse is the adjugate (``core/se3.inv3``; ``torch.linalg.inv`` checks
its result on the host), and the constants are made on the device once a
run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3

GRAVITY = 9.81  # matches uwb_imu_EKF_node.cpp:111


class ESKFParams(NamedTuple):
    """Noise parameters; defaults from ``uwb_imu_EKF_node.cpp:28-33``."""

    acc_noise: float = 0.01
    gyro_noise: float = 0.005
    acc_bias_noise: float = 0.0001
    gyro_bias_noise: float = 0.0001
    meas_noise: float = 0.001
    init_cov: float = 0.1


class ESKFState(NamedTuple):
    p: torch.Tensor  # [3] position
    v: torch.Tensor  # [3] velocity
    q: torch.Tensor  # [4] orientation (Hamilton wxyz, world <- body)
    ba: torch.Tensor  # [3] accelerometer bias
    bg: torch.Tensor  # [3] gyroscope bias
    P: torch.Tensor  # [15, 15] error-state covariance


def init_state(dtype=torch.float32, params: ESKFParams = ESKFParams(),
               device="cuda", lanes: int | None = None) -> ESKFState:
    """At rest at the origin, identity attitude, zero biases, ``P =
    init_cov I``; on the card unless ``device`` names another; with
    ``lanes`` = B every field has a leading B."""
    eye = torch.eye(15, dtype=dtype, device=device)
    zero = eye[0, 1:4] * 0.0
    s = ESKFState(p=zero, v=zero.clone(), q=eye[0, :4].clone(),
                  ba=zero.clone(), bg=zero.clone(), P=eye * params.init_cov)
    if lanes is None:
        return s
    return ESKFState(*(f.expand(lanes, *f.shape).clone() for f in s))


def _mv(A, x):
    """A [..., m, n] @ x [..., n]: ``A @ x`` for one lane, a batched
    product over lanes."""
    return A @ x if x.dim() == 1 else (A @ x[..., None])[..., 0]


def _where(valid, a, b):
    """``torch.where`` with ``valid`` (0-d, or [B] over lanes) broadcast
    over the trailing dims of a field."""
    return torch.where(valid.reshape(valid.shape + (1,) * (a.dim()
                                                           - valid.dim())),
                       a, b)


class _Step:
    """Predict and update with their constants made once, on the state's
    device (from kernels, not host copies)."""

    def __init__(self, params: ESKFParams, dtype, device):
        eye = torch.eye(15, dtype=dtype, device=device)
        self.params = params
        self.eye15 = eye
        self.eye3 = eye[:3, :3]
        self.q_ident = eye[0, :4]
        self.gravity = eye[2, :3] * GRAVITY
        blocks = eye.reshape(5, 3, 15).sum(1)  # [5, 15] block indicators
        # Q's diagonal, acc^2 dt^4 | acc^2 dt^2 | gyro^2 dt^2 | ab dt | gb dt
        # (``computeQ``, ``:158-172``), as coefficients of dt^4, dt^2, dt.
        a2, g2 = params.acc_noise**2, params.gyro_noise**2
        self.q4 = blocks[0] * a2
        self.q2 = blocks[1] * a2 + blocks[2] * g2
        self.q1 = blocks[3] * params.acc_bias_noise + (
            blocks[4] * params.gyro_bias_noise)
        self.r_meas = self.eye3 * params.meas_noise

    def dt(self, dt, like):
        if isinstance(dt, torch.Tensor):
            return dt.to(like.dtype)
        return torch.full((), float(dt), dtype=like.dtype, device=like.device)

    def predict(self, s: ESKFState, acc, gyro, dt) -> ESKFState:
        dt = self.dt(dt, s.p)
        dtv, dtm = dt[..., None], dt[..., None, None]  # for vectors, matrices
        acc_u = acc - s.ba
        gyro_u = gyro - s.bg
        omega = gyro_u * dtv
        theta = torch.linalg.norm(omega, dim=-1)
        small = theta <= 1e-6
        axis = omega / torch.where(small, torch.ones_like(theta),
                                   theta)[..., None]
        dq = torch.where(small[..., None], self.q_ident,
                         se3.quat_from_axis_angle(axis, theta))
        q_new = se3.quat_normalize(se3.quat_multiply(s.q, dq))

        R = se3.quat_to_rot(s.q)
        a_world = _mv(R, acc_u) - self.gravity
        v_new = s.v + a_world * dtv
        p_new = s.p + v_new * dtv + 0.5 * a_world * dtv * dtv

        # Error-state transition F (``computeF``, ``:138-156``) with the
        # JAX package's correction: the velocity/attitude block is
        # -R [acc_body_unbiased]x dt for this filter's local attitude
        # error, not the reference's -R [a_world]x dt (``:146``).
        F = self.eye15.expand(s.P.shape).clone()
        F[..., 0:3, 3:6] = self.eye3 * dtm
        F[..., 3:6, 6:9] = -(R @ se3.skew(acc_u)) * dtm
        F[..., 3:6, 9:12] = -R * dtm
        F[..., 6:9, 6:9] = se3.so3_exp(omega).mT
        F[..., 6:9, 12:15] = -self.eye3 * dtm
        dt2 = dtv * dtv
        q_diag = self.q4 * (dt2 * dt2) + self.q2 * dt2 + self.q1 * dtv
        P_new = F @ s.P @ F.mT + torch.diag_embed(q_diag)

        valid = dt > 0  # the reference returns early on dt <= 0
        return ESKFState(p=_where(valid, p_new, s.p),
                         v=_where(valid, v_new, s.v),
                         q=_where(valid, q_new, s.q),
                         ba=s.ba, bg=s.bg,
                         P=_where(valid, P_new, s.P))

    def update(self, s: ESKFState, z, valid=True) -> ESKFState:
        # S = H P H^T + R = P[0:3, 0:3] + R; K = P H^T S^-1
        K = s.P[..., :, 0:3] @ se3.inv3(s.P[..., 0:3, 0:3]
                                        + self.r_meas)  # [15, 3]
        dx = _mv(K, z - s.p)  # [15]
        new = ESKFState(p=s.p + dx[..., 0:3], v=s.v + dx[..., 3:6],
                        q=se3.quat_boxplus(s.q, dx[..., 6:9]),
                        ba=s.ba + dx[..., 9:12], bg=s.bg + dx[..., 12:15],
                        P=s.P - K @ s.P[..., 0:3, :])  # (I - K H) P
        if valid is True:
            return new
        return ESKFState(*(_where(valid, a, b) for a, b in zip(new, s)))


def predict(state: ESKFState, acc, gyro, dt,
            params: ESKFParams = ESKFParams()) -> ESKFState:
    """IMU propagation (``uwb_imu_EKF_node.cpp:87-156``); ``dt <= 0``
    leaves the state as it is."""
    return _Step(params, state.p.dtype, state.p.device).predict(
        state, acc, gyro, dt)


def update_position(state: ESKFState, z, params: ESKFParams = ESKFParams(),
                    valid=True) -> ESKFState:
    """Position measurement update (``:187-225``), H = [I 0 ...]; ``valid``
    (a bool or a 0-d bool tensor) False leaves the state as it is."""
    return _Step(params, state.p.dtype, state.p.device).update(state, z,
                                                              valid)


class ESKFLog(NamedTuple):
    """Time-synchronous input stream: an IMU sample every tick, a position
    measurement where ``meas_valid`` holds."""

    dt: torch.Tensor  # [T]
    acc: torch.Tensor  # [T, 3]
    gyro: torch.Tensor  # [T, 3]
    meas: torch.Tensor  # [T, 3]
    meas_valid: torch.Tensor  # [T] bool


def eskf_run(log: ESKFLog, state: ESKFState | None = None,
             params: ESKFParams = ESKFParams()):
    """Fuse a whole log, predict then update at every tick; returns
    ``(final_state, {"p": [T, 3], "v": [T, 3], "q": [T, 4]})`` on the log's
    device. A log of B lanes (``dt [B, T]``, ``acc [B, T, 3]``, ...) runs
    them together and returns ``[B, T, ...]``. Makes no host
    synchronisation."""
    dtype, dev = log.acc.dtype, log.acc.device
    lanes = log.dt.shape[0] if log.dt.dim() == 2 else None
    s = init_state(dtype, params, dev, lanes) if state is None else state
    step = _Step(params, dtype, dev)
    ps, vs, qs = [], [], []
    for i in range(log.dt.shape[-1]):
        s = step.predict(s, log.acc[..., i, :], log.gyro[..., i, :],
                         log.dt[..., i])
        s = step.update(s, log.meas[..., i, :], log.meas_valid[..., i])
        ps.append(s.p)
        vs.append(s.v)
        qs.append(s.q)
    return s, {"p": torch.stack(ps, -2), "v": torch.stack(vs, -2),
               "q": torch.stack(qs, -2)}
