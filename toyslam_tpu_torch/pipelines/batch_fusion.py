"""The streaming sliding-window smoother over a measurement log (port of
``toyslam_tpu/pipelines/batch_fusion.py``).

After ``uwb_imu_batch_node.cpp``'s runtime: a keyframe per measurement
(``createKeyframe``, ``:3100-3257,2284``) with the state guess propagated
through the IMU chunk (``propagateState``, ``:4876-5030``); preintegration
between keyframes with a synthetic constant-motion chunk where the buffer
has a gap (``:3559-3781``); initialisation and divergence reset with the
70/30 position blend (50/50 past 10 m, ``:4185-4287``); window push and
optimisation per measurement (``:4003,4354``); and IMU-rate poses from
the optimised keyframes (``propagateStateWithImu`` + ``publishImuPose``,
``:5089-5220,4768-4875``).

JAX's ``lax.scan`` over keyframes is a host loop with the window's count
mirrored on the host; its ``lax.cond`` between the chunk and the gap fill
integrates both as one batch of two and selects with ``torch.where``. A
run makes no host synchronisation apart from ``eigh``'s one a
marginalisation (``estimators/window``) and, on a resume, one read of the
restored window's count. JAX's ``vmap`` over logs is a lane axis:
``batch_fusion_lanes`` runs B logs in lockstep, and ``batch_fusion`` is it
on one lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.estimators import preintegration, window
from toyslam_tpu_torch.estimators.factors import NavState, _mv
from toyslam_tpu_torch.estimators.preintegration import (
    PreintegrationParams, Preintegrated)


class BatchFusionConfig(NamedTuple):
    # Reference default: optimization_window_size = 20 (``:3229-3235``).
    window: window.WindowConfig = window.WindowConfig(window_size=20)
    preint: PreintegrationParams = PreintegrationParams(
        acc_noise=0.03, gyro_noise=0.002)
    # Divergence reset threshold (PositionDriftFactor limit / reset logic)
    max_position_error: float = 5.0
    # Position blend on init/reset: blend * meas + (1 - blend) * current
    # (``:4195``); jumps beyond large_jump use 0.5.
    init_blend: float = 0.7
    large_jump: float = 10.0
    # Seed the orientation from the measurement when there is one
    # (use_gps_orientation_as_initial_, ``:1364``)
    use_orientation_as_initial: bool = True


class BatchFusionOutput(NamedTuple):
    kf_p: torch.Tensor  # [M, 3] optimised newest-keyframe position
    kf_q: torch.Tensor  # [M, 4]
    kf_v: torch.Tensor  # [M, 3]
    kf_ba: torch.Tensor  # [M, 3]
    kf_bg: torch.Tensor  # [M, 3]
    reset: torch.Tensor  # [M] bool (divergence reset fired)
    win: window.SlidingWindow  # final window
    # (``batch_fusion_lanes``: a leading lane axis B on every leaf)


def _lane_where(cond, a, b):
    """``torch.where`` of a lane condition [B] over lane tensors [B, ...]."""
    return torch.where(cond.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _propagate(state: NavState, pre: Preintegrated, dt, gravity_w):
    """The next keyframe's state from a preintegrated chunk
    (``propagateState``, ``:4876``); the deltas exclude gravity."""
    R = se3.quat_to_rot(state.q)
    p = state.p + state.v * dt[..., None] + _mv(R, pre.delta_p)
    v = state.v + _mv(R, pre.delta_v)
    q = se3.quat_multiply(state.q, pre.delta_q)
    return NavState(p=p, q=q / torch.linalg.norm(q, dim=-1, keepdim=True),
                    v=v, ba=state.ba, bg=state.bg)


def _gravity(dtype, device):
    return torch.eye(3, dtype=dtype, device=device)[2] * -9.81


def batch_fusion(imu_acc, imu_gyro, imu_dt, imu_valid,
                 meas_t, meas_p, meas_p_valid,
                 meas_v=None, meas_v_valid=None,
                 meas_q=None, meas_q_valid=None,
                 mean_acc=None,
                 config: BatchFusionConfig = BatchFusionConfig(),
                 init_window: window.SlidingWindow | None = None,
                 init_state: NavState | None = None,
                 initialized=False) -> BatchFusionOutput:
    """Run the smoother over a measurement log on its device.

    ``imu_* [M, R, ...]``: the IMU chunk covering (t_{m-1}, t_m], padded
    to R samples with ``imu_valid``; ``meas_p [M, 3]`` position fixes with
    ``meas_p_valid``; optional GPS velocity and orientation fixes and the
    chunks' mean accelerometer sample (by default the masked mean of each
    chunk's valid samples). Returns each measurement's optimised newest
    state. ``init_window``/``init_state``/``initialized`` resume a run
    from a checkpointed window and its last state. This is
    ``batch_fusion_lanes`` on one lane.
    """
    def lane(x):
        if x is None or isinstance(x, bool):
            return x
        return window._as_lane(x)

    out = batch_fusion_lanes(
        *(lane(a) for a in (imu_acc, imu_gyro, imu_dt, imu_valid, meas_t,
                            meas_p, meas_p_valid)),
        meas_v=lane(meas_v), meas_v_valid=lane(meas_v_valid),
        meas_q=lane(meas_q), meas_q_valid=lane(meas_q_valid),
        mean_acc=lane(mean_acc), config=config,
        init_window=lane(init_window), init_state=lane(init_state),
        initialized=lane(initialized))
    return window._one_lane(out)


def batch_fusion_lanes(imu_acc, imu_gyro, imu_dt, imu_valid,
                       meas_t, meas_p, meas_p_valid,
                       meas_v=None, meas_v_valid=None,
                       meas_q=None, meas_q_valid=None,
                       mean_acc=None,
                       config: BatchFusionConfig = BatchFusionConfig(),
                       init_window: window.SlidingWindow | None = None,
                       init_state: NavState | None = None,
                       initialized=False) -> BatchFusionOutput:
    """``batch_fusion`` over B independent logs in lockstep (JAX's ``vmap``
    of it): every input with a leading lane axis (``imu_acc [B, M, R, 3]``,
    ``meas_p_valid [B, M]``, ...), a lane window (``window_init(...,
    lanes=B)``) and lane state to resume from, ``initialized`` a bool or
    [B]. Each lane's reset, divergence and gap fill are its own
    ``torch.where``; every keyframe pushes into all lanes' windows at once
    (one host count) and optimises them in one batch, and a
    marginalisation makes one host synchronisation for all lanes. Returns
    a BatchFusionOutput with a leading B."""
    B, M, R = imu_acc.shape[:3]
    dtype, dev = imu_acc.dtype, imu_acc.device
    cfg_w = config.window
    K = cfg_w.window_size
    gw = _gravity(dtype, dev)

    if meas_v is None:
        meas_v = torch.zeros((B, M, 3), dtype=dtype, device=dev)
    if meas_v_valid is None:
        meas_v_valid = torch.zeros((B, M), dtype=torch.bool, device=dev)
    if meas_q is None:
        meas_q = window._ident(B * M, dtype, dev).view(B, M, 4)
    if meas_q_valid is None:
        meas_q_valid = torch.zeros((B, M), dtype=torch.bool, device=dev)
    if mean_acc is None:
        # Masked mean of each chunk's valid samples (the reference's
        # GravityAlignmentFactor averages, ``:296-334,4510-4536``).
        wv = imu_valid.to(dtype)[..., None]
        mean_acc = (imu_acc * wv).sum(2) / torch.clamp(wv.sum(2), min=1.0)
    acc_valid = imu_valid.sum(2) > 0

    if init_window is None:
        win, count = window.window_init(cfg_w, dtype, dev, lanes=B), 0
    else:
        # The lanes share one count: one read of it (one host sync).
        lo, hi = torch.stack([init_window.count.min(),
                              init_window.count.max()]).tolist()
        if lo != hi:
            raise ValueError(f"lane windows hold {lo} to {hi} keyframes; "
                             "lanes push together and must hold as many")
        win, count = init_window, lo
    if init_state is None:
        z = torch.zeros((B, 3), dtype=dtype, device=dev)
        init_state = NavState(p=z, q=window._ident(B, dtype, dev), v=z,
                              ba=z, bg=z)
    cur = init_state
    if isinstance(initialized, torch.Tensor):
        init_flag = initialized.to(device=dev, dtype=torch.bool).expand(B)
    else:
        init_flag = torch.full((B,), bool(initialized), dtype=torch.bool,
                               device=dev)
    all_valid = torch.ones((B, R), dtype=torch.bool, device=dev)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)

    outs = []
    for m in range(M):
        vld, dts = imu_valid[:, m], imu_dt[:, m]
        p_m, p_ok = meas_p[:, m], meas_p_valid[:, m]
        dt_total = torch.where(vld, dts, torch.zeros_like(dts)).sum(-1)

        # The chunk with the current bias estimate and start-frame gravity,
        # and beside it the gap fill: constant motion from the current
        # state (``:3646-3781``); a chunk without valid samples takes the
        # fill. Both integrate as one batch [B, 2].
        R_T = se3.quat_to_rot(se3.quat_conjugate(cur.q))
        s_acc, s_gyro, s_dts = preintegration.synthesize_imu_gap(
            cur.q, cur.v, cur.q, cur.v, torch.clamp(dt_total, min=0.05),
            n_samples=R, gravity_world=gw)
        both = preintegration.preintegrate(
            torch.stack([imu_acc[:, m], s_acc], 1),
            torch.stack([imu_gyro[:, m], s_gyro], 1),
            torch.stack([dts, s_dts], 1), cur.ba[:, None], cur.bg[:, None],
            gravity_sensor=_mv(R_T, gw)[:, None], params=config.preint,
            valid=torch.stack([vld, all_valid], 1))
        real = vld.any(-1)
        pre = Preintegrated(*(_lane_where(real, x[:, 0], x[:, 1])
                              for x in both))

        guess = _propagate(cur, pre, dt_total, gw)

        # Initialisation / divergence reset with the blended position
        first_fix = p_ok & ~init_flag
        diverged = p_ok & init_flag & (
            torch.linalg.norm(guess.p - p_m, dim=-1)
            > config.max_position_error)
        reset = first_fix | diverged
        diff = torch.linalg.norm(p_m - guess.p, dim=-1)
        blend = torch.where(diff > config.large_jump,
                            torch.full_like(diff, 0.5),
                            torch.full_like(diff, config.init_blend))[:, None]
        q_ok, v_ok = meas_q_valid[:, m], meas_v_valid[:, m]
        init_q = (_lane_where(q_ok, meas_q[:, m], guess.q)
                  if config.use_orientation_as_initial else guess.q)
        guess = NavState(
            p=_lane_where(reset, guess.p * (1.0 - blend) + p_m * blend,
                          guess.p),
            q=_lane_where(first_fix, init_q, guess.q),
            v=_lane_where(reset, _lane_where(v_ok, meas_v[:, m],
                                             zero3.expand(B, 3)), guess.v),
            ba=_lane_where(reset, zero3.expand(B, 3), guess.ba),
            bg=_lane_where(reset, zero3.expand(B, 3), guess.bg))
        # A reset drops the prior: it summarises a history no longer
        # trusted (``resetStateToUwb/Gps``).
        win = win._replace(prior_valid=win.prior_valid & ~diverged)

        win = window.window_push(
            win, guess, meas_t[:, m], p_m, p_ok, pre, dt_total, cfg_w,
            meas_v=meas_v[:, m], meas_v_valid=v_ok, meas_q=meas_q[:, m],
            meas_q_valid=q_ok, mean_acc=mean_acc[:, m],
            acc_valid=acc_valid[:, m], count=count)
        count = min(count, K - 1) + 1
        win = window.window_optimize(win, cfg_w)

        cur = window._slot(win.states, count - 1)
        outs.append((*cur, diverged))
        init_flag = init_flag | p_ok
    kf = [torch.stack(x, 1) for x in zip(*outs)]
    return BatchFusionOutput(*kf, win=win)


def high_rate_trajectory(kf_states: NavState, imu_acc, imu_gyro, imu_dt,
                         imu_valid,
                         config: BatchFusionConfig = BatchFusionConfig()):
    """IMU-rate poses between optimisations (``propagateStateWithImu`` +
    ``publishImuPose``, ``:5089-5220,4768-4875``): from each keyframe
    state [M, ...], integrate the following chunk [M, R, ...] tick by
    tick. Returns (p [M, R, 3], q [M, R, 4], v [M, R, 3]). JAX's vmap over
    the chunks is the batch axis of one host loop over the R ticks."""
    dtype, dev = imu_acc.dtype, imu_acc.device
    gw = _gravity(dtype, dev)
    ident = window._ident(imu_acc.shape[0], dtype, dev)
    pc = config.preint
    s = kf_states
    ps, qs, vs = [], [], []
    for k in range(imu_acc.shape[1]):
        dt = imu_dt[:, k]
        dt = torch.where(imu_valid[:, k] & (dt > pc.min_integration_dt)
                         & (dt <= pc.max_imu_dt), dt,
                         torch.zeros_like(dt))[:, None]
        dq = se3.quat_boxplus(ident, (imu_gyro[:, k] - s.bg) * dt)
        q_new = se3.quat_multiply(s.q, dq)
        q_new = q_new / torch.linalg.norm(q_new, dim=-1, keepdim=True)
        a_w = _mv(se3.quat_to_rot(s.q), imu_acc[:, k] - s.ba) + gw
        p_new = s.p + s.v * dt + 0.5 * a_w * dt * dt
        v_new = s.v + a_w * dt
        s = s._replace(p=p_new, q=q_new, v=v_new)
        ps.append(p_new)
        qs.append(q_new)
        vs.append(v_new)
    return torch.stack(ps, 1), torch.stack(qs, 1), torch.stack(vs, 1)
