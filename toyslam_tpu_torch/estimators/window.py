"""Sliding-window factor-graph smoother with Schur marginalisation (port of
``toyslam_tpu/estimators/window.py``).

After the flagship ``uwb_imu_batch_node.cpp`` (VINS-Mono style): a window
of K keyframe states [p, q, v, ba, bg], IMU preintegration factors
between neighbours, UWB/GPS position factors, the soft constraints, and a
marginalisation prior that summarises slid-out history
(``MarginalizationInfo``/``MarginalizationFactor`` ``:537-1067``; window
assembly ``optimizeFactorGraph`` ``:4354-4650``).

Gauss-Newton runs on the 15K-dim tangent with the Jacobian of the stacked
residual from ``torch.func.jacfwd`` (JAX's ``jax.jacfwd``); the residual
functions are batched over the window in place of JAX's ``vmap``s. No
function here reads a value from the device, with one exception:
``torch.linalg.eigh`` in :func:`_marginalize_oldest` checks its result on
the host, one synchronisation a marginalisation. The window's count lives
on the device, as in the JAX window, and its callers mirror it on the
host: :func:`window_push` takes the host count (JAX's ``lax.cond`` on it
becomes a Python branch) and reads it from the device only when not
given. Cholesky and inverse failures are read from ``info`` on the
device (``cholesky_ex``, ``inv_ex``): where JAX's factor fills with NaN
and its step is rejected, a failed factor here zeroes the step.

A window of lanes (JAX's ``vmap`` over independent logs) carries a
leading lane axis B on every leaf (``window_init(..., lanes=B)``); its
lanes push a keyframe together, so they share one host count. Every
function here takes either kind: one window runs as a lane window of one
lane. A lane window's Jacobians come from one ``jvp`` a tangent direction
for all lanes (a lane's residuals depend on its own tangent only), its
solves are batched ``cholesky_ex``/``cholesky_solve`` with each lane's
``info`` rejecting that lane's step, and its marginalisation is one
batched ``inv_ex`` and one batched ``eigh``: one host synchronisation a
marginalisation for all lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from toyslam_tpu_torch.estimators import factors
from toyslam_tpu_torch.estimators.factors import NavState, _mv
from toyslam_tpu_torch.estimators.preintegration import Preintegrated


class WindowConfig(NamedTuple):
    window_size: int = 20  # optimization_window_size default (batch node)
    gn_iterations: int = 8  # Ceres cap 10/20 (:4639-4650)
    damping: float = 1e-3
    pos_sigma: float = 0.05  # UWB position noise (m), ``:1401``
    # Huber on the UWB position factor (HuberLoss(0.1), ``:4490``) as an
    # IRLS weight; <= 0 disables.
    huber_delta: float = 0.0
    enable_bias_constraint: bool = True
    bias_acc_weight: float = 1.0
    bias_gyro_weight: float = 10.0
    enable_velocity_constraint: bool = True
    max_velocity: float = 10.0
    enable_roll_pitch_prior: bool = False
    roll_pitch_weight: float = 0.5
    enable_orientation_smoothness: bool = True
    orientation_smoothness_weight: float = 0.5
    max_bias: float = 0.5  # post-solve clamps (:4656-4710)
    max_speed_clamp: float = 20.0
    # GPS branch (use_gps_instead_of_uwb_, ``:4443-4478``)
    use_gps: bool = False
    gps_pos_sigma: float = 0.01  # gps_position_noise (``:1359``)
    # z sigma multiplier: the reference divides the z residual by
    # noise * 0.0001 (``GpsPositionFactor``, ``:495-505``).
    gps_pos_z_sigma_factor: float = 1.0e-4
    use_gps_velocity: bool = True  # ``:1366``; gated on velocity constraint
    gps_vel_sigma: float = 0.01  # gps_velocity_noise (``:1360``)
    use_gps_orientation: bool = False  # use_gps_orientation_as_constraint
    gps_orientation_sigma: float = 0.1  # rad (``:1361``)
    use_yaw_only_orientation: bool = False
    yaw_weight: float = 1.0
    # soft-constraint family extensions
    enable_gravity_alignment: bool = False  # ``:296-334,4510-4536``
    gravity_alignment_weight: float = 1.0
    enable_horizontal_velocity_incentive: bool = False  # ``:183-218``
    min_horizontal_velocity: float = 0.5  # ``:1434``
    horizontal_velocity_weight: float = 0.5
    # While opt_count < simplified_first_n the horizontal-velocity and
    # orientation-smoothness residuals are gated off (``:4365-4372``).
    simplified_first_n: int = 5


class SlidingWindow(NamedTuple):
    """One window; a lane window has a leading lane axis B on every
    leaf."""

    states: NavState  # each field [K, ...]
    timestamps: torch.Tensor  # [K]
    meas_p: torch.Tensor  # [K, 3]
    meas_valid: torch.Tensor  # [K] bool
    meas_v: torch.Tensor  # [K, 3] GPS velocity fixes
    meas_v_valid: torch.Tensor  # [K] bool
    meas_q: torch.Tensor  # [K, 4] GPS orientation fixes (wxyz)
    meas_q_valid: torch.Tensor  # [K] bool
    mean_acc: torch.Tensor  # [K, 3] keyframe accelerometer mean
    acc_valid: torch.Tensor  # [K] bool
    active: torch.Tensor  # [K] bool (filled slots)
    count: torch.Tensor  # 0-d int32
    opt_count: torch.Tensor  # 0-d int32 (simplified-first-N gate)
    # Preintegration between slots i and i+1 (fields [K-1, ...])
    preints: Preintegrated
    pair_dt: torch.Tensor  # [K-1]
    pair_valid: torch.Tensor  # [K-1] bool
    lin_ba: torch.Tensor  # [K-1, 3]
    lin_bg: torch.Tensor  # [K-1, 3]
    # Marginalisation prior on slot 0: r = sqrt_info (x0 - lin_state) + r0
    prior_sqrt_info: torch.Tensor  # [15, 15]
    prior_r0: torch.Tensor  # [15]
    prior_state: NavState  # linearisation point
    prior_valid: torch.Tensor  # 0-d bool


def _ident(n, dtype, device):
    """n identity quaternions [n, 4], made on the device."""
    return torch.eye(4, dtype=dtype, device=device)[:1].expand(n, 4).clone()


def _empty_state(K, dtype, device) -> NavState:
    z = torch.zeros((K, 3), dtype=dtype, device=device)
    return NavState(p=z, q=_ident(K, dtype, device), v=z.clone(),
                    ba=z.clone(), bg=z.clone())


def _empty_preint(K, dtype, device) -> Preintegrated:
    z = torch.zeros((K, 3), dtype=dtype, device=device)
    eye9 = torch.eye(9, dtype=dtype, device=device)
    return Preintegrated(
        delta_p=z, delta_v=z.clone(), delta_q=_ident(K, dtype, device),
        covariance=(eye9 * 1e-4).expand(K, 9, 9).clone(),
        jacobian_bias=torch.zeros((K, 9, 6), dtype=dtype, device=device),
        sum_dt=torch.zeros((K,), dtype=dtype, device=device))


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nest of NamedTuples."""
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, sub) for sub in tree))
    return fn(tree)


def _lanes_of(win: SlidingWindow):
    """The lane count of a lane window, None for one window."""
    return win.meas_p.shape[0] if win.meas_p.dim() == 3 else None


def _as_lane(tree):
    """One window (or state, or preintegral) as a lane of one."""
    return _tree_map(lambda x: x[None], tree)


def _one_lane(tree):
    return _tree_map(lambda x: x[0], tree)


def _slot(tree, i):
    """Slot ``i`` (an index or a slice) of every leaf of a lane tree."""
    return type(tree)(*(x[:, i] for x in tree))


def window_init(config: WindowConfig = WindowConfig(), dtype=torch.float32,
                device="cuda", lanes: int | None = None) -> SlidingWindow:
    """An empty window on ``device`` (the card unless named otherwise), or
    ``lanes`` of them as one lane window."""
    if lanes is not None:
        one = window_init(config, dtype, device)
        return _tree_map(
            lambda x: x.expand((lanes,) + x.shape).contiguous(), one)
    K = config.window_size

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    one = _empty_state(1, dtype, device)
    return SlidingWindow(
        states=_empty_state(K, dtype, device), timestamps=zeros(K),
        meas_p=zeros(K, 3), meas_valid=zeros(K, dt=torch.bool),
        meas_v=zeros(K, 3), meas_v_valid=zeros(K, dt=torch.bool),
        meas_q=_ident(K, dtype, device),
        meas_q_valid=zeros(K, dt=torch.bool),
        mean_acc=zeros(K, 3), acc_valid=zeros(K, dt=torch.bool),
        active=zeros(K, dt=torch.bool), count=zeros(dt=torch.int32),
        opt_count=zeros(dt=torch.int32),
        preints=_empty_preint(K - 1, dtype, device), pair_dt=zeros(K - 1),
        pair_valid=zeros(K - 1, dt=torch.bool), lin_ba=zeros(K - 1, 3),
        lin_bg=zeros(K - 1, 3), prior_sqrt_info=zeros(15, 15),
        prior_r0=zeros(15), prior_state=_state_at(one, 0),
        prior_valid=zeros(dt=torch.bool))


def _state_at(states: NavState, i) -> NavState:
    return NavState(*(x[i] for x in states))


def _boxminus(a: NavState, b: NavState):
    """15-dim tangent a [-] b."""
    return torch.cat([a.p - b.p, factors.quat_error(b.q, a.q), a.v - b.v,
                      a.ba - b.ba, a.bg - b.bg], -1)


def _pos_weight(config: WindowConfig, like):
    """The position factor's weight: per axis in GPS mode (anisotropic z,
    ``GpsPositionFactor:495-505``), one number for UWB."""
    if not config.use_gps:
        return torch.full((), 1.0 / config.pos_sigma, dtype=like.dtype,
                          device=like.device)
    w = torch.full((3,), 1.0 / config.gps_pos_sigma, dtype=like.dtype,
                   device=like.device)
    # a fill (a Python number assigned by index would be a blocking copy)
    w[2:].fill_(1.0 / (config.gps_pos_sigma * config.gps_pos_z_sigma_factor))
    return w


def _huber(r_pos, config: WindowConfig):
    """The sqrt-Huber IRLS weight of position residuals [..., 3], held
    constant through the Jacobian (``.detach()``: JAX's stop_gradient)."""
    nrm = torch.sqrt((r_pos * r_pos).sum(-1) + 1e-12)
    hw = torch.sqrt(torch.clamp(config.huber_delta / config.pos_sigma / nrm,
                                max=1.0))
    return r_pos * hw.detach()[..., None]


def _yaw(mq):
    """Heading of quaternions [..., 4]."""
    return torch.atan2(2.0 * (mq[..., 0] * mq[..., 3] + mq[..., 1] * mq[..., 2]),
                       1.0 - 2.0 * (mq[..., 2] * mq[..., 2]
                                    + mq[..., 3] * mq[..., 3]))


def _imu_whitened(s_i, s_j, pre, dt, lin_ba, lin_bg, whiten, gate):
    """Whitened IMU factors [..., 15], times ``gate`` [..., 1]."""
    U, ba_w, bg_w = whiten
    r = factors.imu_residual(s_i, s_j, pre, dt, lin_ba, lin_bg)
    r9 = _mv(U, r[..., :9])
    rb = torch.cat([r[..., 9:12] * ba_w[..., None],
                    r[..., 12:15] * bg_w[..., None]], -1)
    return torch.cat([r9, rb], -1) * gate


class _Weights(NamedTuple):
    """The configuration's factor weights as 0-d tensors."""

    bias_acc: torch.Tensor
    bias_gyro: torch.Tensor
    max_velocity: torch.Tensor
    one: torch.Tensor
    eps: torch.Tensor
    roll_pitch: torch.Tensor
    gravity_alignment: torch.Tensor
    gravity: torch.Tensor
    min_horizontal: torch.Tensor
    horizontal: torch.Tensor
    smooth: torch.Tensor
    smooth2: torch.Tensor
    gps_vel: torch.Tensor
    gps_att: torch.Tensor
    yaw: torch.Tensor


class _Terms(NamedTuple):
    """What the residuals read besides the tangent, all floating-point, of
    a lane window: its linearisation point and measurements, the whitening
    of its preintegrals, the prior with a slot axis of one, and its masks
    as 0/1 gates ([B, K, 1] a slot, [B, K-1, 1] a pair, [B, 1, 1] for the
    prior and the simplified-mode switch)."""

    states: NavState
    meas_p: torch.Tensor
    meas_v: torch.Tensor
    meas_q: torch.Tensor
    mean_acc: torch.Tensor
    preints: Preintegrated
    pair_dt: torch.Tensor
    lin_ba: torch.Tensor
    lin_bg: torch.Tensor
    prior_sqrt_info: torch.Tensor
    prior_r0: torch.Tensor
    prior_state: NavState
    whiten: tuple
    w_pos: torch.Tensor
    act: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor
    att: torch.Tensor
    acc: torch.Tensor
    pair: torch.Tensor
    pair2: torch.Tensor
    prior: torch.Tensor
    full: torch.Tensor
    k: _Weights


def _terms(win: SlidingWindow, config: WindowConfig, whiten) -> _Terms:
    dtype = win.meas_p.dtype

    def gate(mask):
        return mask.to(dtype)[..., None]

    def lane_gate(mask):
        return mask.to(dtype)[:, None, None]

    c = config
    k = _Weights(*(torch.full((), v, dtype=dtype, device=win.meas_p.device)
                   for v in (c.bias_acc_weight, c.bias_gyro_weight,
                             c.max_velocity, 1.0, 1e-12, c.roll_pitch_weight,
                             c.gravity_alignment_weight, factors.GRAVITY,
                             c.min_horizontal_velocity,
                             c.horizontal_velocity_weight,
                             c.orientation_smoothness_weight,
                             0.5 * c.orientation_smoothness_weight,
                             1.0 / c.gps_vel_sigma,
                             1.0 / c.gps_orientation_sigma, c.yaw_weight)))

    return _Terms(
        win.states, win.meas_p, win.meas_v, win.meas_q, win.mean_acc,
        win.preints, win.pair_dt, win.lin_ba, win.lin_bg,
        win.prior_sqrt_info[:, None], win.prior_r0[:, None],
        _tree_map(lambda x: x[:, None], win.prior_state), whiten,
        _pos_weight(config, win.meas_p), gate(win.active),
        gate(win.meas_valid & win.active), gate(win.meas_v_valid & win.active),
        gate(win.meas_q_valid & win.active), gate(win.acc_valid & win.active),
        gate(win.pair_valid),
        gate(win.pair_valid[:, :-1] & win.pair_valid[:, 1:]),
        lane_gate(win.prior_valid),
        lane_gate(win.opt_count >= config.simplified_first_n), k)


def _stack_residuals(t: _Terms, config: WindowConfig, deltas):
    """All window residuals of each lane as one row [B, R], as a function
    of the tangent deltas [B, K, 15]; inactive and invalid entries are
    zero."""
    B = deltas.shape[0]
    states = factors.state_boxplus(t.states, deltas)
    res = []
    r_pos = factors.position_residual(states, t.meas_p, t.w_pos) * t.pos
    if not config.use_gps and config.huber_delta > 0:
        r_pos = _huber(r_pos, config)
    res.append(r_pos)

    if config.use_gps and config.use_gps_velocity \
            and config.enable_velocity_constraint:
        res.append(factors.velocity_residual(states, t.meas_v, t.k.gps_vel)
                   * t.vel)
    if config.use_gps and config.use_gps_orientation:
        res.append(factors.gps_orientation_residual(
            states, t.meas_q, t.k.gps_att) * t.att)
    if config.use_gps and config.use_yaw_only_orientation:
        res.append(factors.yaw_only_orientation_residual(
            states, _yaw(t.meas_q), t.k.yaw) * t.att)

    s_i = _slot(states, slice(None, -1))
    s_j = _slot(states, slice(1, None))
    res.append(_imu_whitened(s_i, s_j, t.preints, t.pair_dt, t.lin_ba,
                             t.lin_bg, t.whiten, t.pair))

    if config.enable_bias_constraint:
        res.append(factors.bias_magnitude_residual(
            states, t.k.bias_acc, t.k.bias_gyro) * t.act)
    if config.enable_velocity_constraint:
        res.append(factors.velocity_magnitude_residual(
            states, t.k.max_velocity, t.k.one, t.k.eps) * t.act)
    if config.enable_roll_pitch_prior:
        res.append(factors.roll_pitch_prior_residual(
            states, t.k.roll_pitch) * t.act)
    if config.enable_gravity_alignment:
        res.append(factors.gravity_alignment_residual(
            states, t.mean_acc, t.k.gravity_alignment, t.k.eps, t.k.gravity)
            * t.acc)
    if config.enable_horizontal_velocity_incentive:
        res.append(factors.horizontal_velocity_incentive_residual(
            states, t.k.min_horizontal, t.k.horizontal, t.k.eps)
            * (t.act * t.full))
    if config.enable_orientation_smoothness:
        # i <-> i+1 at full weight, i <-> i+2 at half (``:4539-4556``)
        res.append(factors.orientation_smoothness_residual(
            s_i, s_j, t.k.smooth) * t.pair * t.full)
        res.append(factors.orientation_smoothness_residual(
            _slot(states, slice(None, -2)), _slot(states, slice(2, None)),
            t.k.smooth2) * t.pair2 * t.full)

    res.append((_mv(t.prior_sqrt_info,
                    _boxminus(_slot(states, slice(0, 1)), t.prior_state))
                + t.prior_r0) * t.prior)
    return torch.cat([r.reshape(B, -1) for r in res], -1)


def _leaves(tree):
    """The tensors of a nest of NamedTuples and tuples, in order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, tuple):
        items = [_rebuild(sub, leaves) for sub in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return next(leaves)


def _residual_and_jacobian(fn, shape, *consts):
    """(r(0), dr/dx at 0) of ``fn(x, *consts)`` on x of ``shape`` (B, n):
    each of B lanes' residuals ``r [B, R]`` of its own n-vector. This is
    ``torch.func.jacfwd``'s construction (a ``vmap`` of ``jvp`` over the n
    basis directions) that also returns the value; a direction moves every
    lane's x at once, and as a lane's residuals depend on its own x only,
    one ``jvp`` gives each lane's column. Returns r0 [B, R] and J [B, R,
    n]. The constants go in as primals of zero tangent rather than as
    closed-over tensors: an operation between a dual tensor and a plain
    one takes a Python decomposition under ``torch.func`` that costs ~30x
    a plain one."""
    flat = _leaves(consts)
    like = flat[0]
    n = shape[-1]
    zero = torch.zeros(shape, dtype=like.dtype, device=like.device)
    basis = torch.eye(n, dtype=like.dtype, device=like.device)
    zero_t = [torch.zeros_like(c) for c in flat]

    def g(x, *leaves):
        return fn(x, *_rebuild(consts, iter(leaves)))

    def push(v):
        r, t = jvp(g, (zero, *flat), (v.expand(shape), *zero_t))
        return t, r

    J, r0 = vmap(push, out_dims=(len(shape), None))(basis)
    return r0, J


def window_optimize(win: SlidingWindow,
                    config: WindowConfig = WindowConfig()) -> SlidingWindow:
    """Damped Gauss-Newton on the window tangent (in place of Ceres'
    SPARSE_NORMAL_CHOLESKY, ``:4639-4650``), then the post-solve clamps;
    on a lane window, every lane at once."""
    B = _lanes_of(win)
    if B is None:
        return _one_lane(window_optimize(_as_lane(win), config))
    K = config.window_size
    like = win.meas_p
    whiten = factors.imu_sqrt_info(win.preints)
    act15 = win.active.repeat_interleave(15, dim=1).to(like.dtype)
    diag = torch.diag_embed(config.damping + (1.0 - act15))
    # Per-block step clamp (a trust region: an unclamped f32 step on the
    # enormous whitened weights of short chunks can overflow a residual).
    one = torch.ones(3, dtype=like.dtype, device=like.device)
    caps = torch.cat([one * 2.0, one * 0.5, one * 5.0, one * 0.1,
                      one * 0.1])
    states = win.states
    terms = _terms(win, config, whiten)
    for _ in range(config.gn_iterations):
        r0, J = _residual_and_jacobian(
            lambda d, t: _stack_residuals(t, config, d.view(B, K, 15)),
            (B, K * 15), terms._replace(states=states))
        Jt = J.mT
        H = Jt @ J + diag
        g = Jt @ r0[..., None]
        L, info = torch.linalg.cholesky_ex(0.5 * (H + H.mT))
        delta = -torch.cholesky_solve(g, L)[..., 0] * act15
        # A failed factor (an indefinite H after a residual overflow)
        # rejects the step of its lane, as JAX's NaN factor does.
        delta = torch.where((info == 0)[:, None], delta,
                            torch.zeros_like(delta))
        d = torch.clamp(delta.view(B, K, 15), -caps, caps)
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        states = factors.state_boxplus(states, d)

    # Post-solve sanity clamps (``:4656-4710``)
    speed = torch.linalg.norm(states.v, dim=-1, keepdim=True)
    scale = torch.clamp(config.max_speed_clamp / torch.clamp(speed, min=1e-9),
                        max=1.0)
    states = states._replace(
        v=states.v * scale,
        ba=torch.clamp(states.ba, -config.max_bias, config.max_bias),
        bg=torch.clamp(states.bg, -config.max_bias, config.max_bias))
    return win._replace(states=states, opt_count=win.opt_count + 1)


def _marginal_residuals(t: _Terms, config: WindowConfig, delta30):
    """The residuals touching slot 0 that involve only slots 0 and 1, as a
    function of their tangent [B, 30], one row [B, R] a lane (``t`` holds
    the first pair's whitening). Slots are kept as slices of one row:
    under ``torch.func.jacfwd`` a 0-d value plus a Python number gets a
    float64 tangent in f32."""
    B = delta30.shape[0]
    a, b = slice(0, 1), slice(1, 2)
    d = delta30.view(B, 2, 15)
    s0 = factors.state_boxplus(_slot(t.states, a), d[:, a])
    s1 = factors.state_boxplus(_slot(t.states, b), d[:, b])
    parts = []
    r_p0 = (factors.position_residual(s0, t.meas_p[:, a], t.w_pos)
            * t.pos[:, a])
    if not config.use_gps and config.huber_delta > 0:
        # The same robust weight as the window's objective: an outlier fix
        # on the marginalised keyframe must not enter the prior at full
        # weight.
        r_p0 = _huber(r_p0, config)
    parts.append(r_p0)
    if config.use_gps and config.use_yaw_only_orientation:
        parts.append(factors.yaw_only_orientation_residual(
            s0, _yaw(t.meas_q[:, a]), t.k.yaw) * t.att[:, a])
    if config.use_gps and config.use_gps_velocity \
            and config.enable_velocity_constraint:
        parts.append(factors.velocity_residual(s0, t.meas_v[:, a],
                                               t.k.gps_vel) * t.vel[:, a])
    if config.use_gps and config.use_gps_orientation:
        parts.append(factors.gps_orientation_residual(
            s0, t.meas_q[:, a], t.k.gps_att) * t.att[:, a])
    parts.append(_imu_whitened(s0, s1, _slot(t.preints, a), t.pair_dt[:, a],
                               t.lin_ba[:, a], t.lin_bg[:, a], t.whiten,
                               t.pair[:, a]))
    act0 = t.act[:, a]
    if config.enable_bias_constraint:
        parts.append(factors.bias_magnitude_residual(
            s0, t.k.bias_acc, t.k.bias_gyro) * act0)
    if config.enable_velocity_constraint:
        parts.append(factors.velocity_magnitude_residual(
            s0, t.k.max_velocity, t.k.one, t.k.eps) * act0)
    if config.enable_roll_pitch_prior:
        parts.append(factors.roll_pitch_prior_residual(
            s0, t.k.roll_pitch) * act0)
    if config.enable_gravity_alignment:
        parts.append(factors.gravity_alignment_residual(
            s0, t.mean_acc[:, a], t.k.gravity_alignment, t.k.eps,
            t.k.gravity) * t.acc[:, a])
    if config.enable_horizontal_velocity_incentive:
        parts.append(factors.horizontal_velocity_incentive_residual(
            s0, t.k.min_horizontal, t.k.horizontal, t.k.eps) * act0 * t.full)
    if config.enable_orientation_smoothness:
        parts.append(factors.orientation_smoothness_residual(
            s0, s1, t.k.smooth) * t.pair[:, a] * t.full)
    parts.append((_mv(t.prior_sqrt_info, _boxminus(s0, t.prior_state))
                  + t.prior_r0) * t.prior)
    return torch.cat([r.reshape(B, -1) for r in parts], -1)


def _shift(x, fill=None):
    """x [B, K, ...] moved one slot towards 0; the last slot zero, or
    ``fill`` [...]."""
    last = (torch.zeros_like(x[:, :1]) if fill is None
            else fill.expand_as(x[:, :1]))
    return torch.cat([x[:, 1:], last], 1)


def _marginalize_oldest(win: SlidingWindow, config: WindowConfig):
    """Schur-complement slot 0 onto slot 1 and shift the window left.

    Linearises every factor that touches slot 0 and involves only slots 0
    and 1 over their 30-dim tangent, eliminates slot 0
    (``MarginalizationInfo::marginalize``, ``:762-979``; the i <-> i+2
    smoothness term is dropped, as the reference's fixed (slot1, slot0)
    layout drops it, ``:1023-1030``), and installs the 15-dim prior on the
    new slot 0. ``torch.linalg.eigh`` syncs with the host once, for every
    lane of a lane window.
    """
    B = _lanes_of(win)
    if B is None:
        return _one_lane(_marginalize_oldest(_as_lane(win), config))
    dtype, dev = win.meas_p.dtype, win.meas_p.device
    whiten0 = factors.imu_sqrt_info(_slot(win.preints, slice(0, 1)))
    r0, J = _residual_and_jacobian(
        lambda d, t: _marginal_residuals(t, config, d), (B, 30),
        _terms(win, config, whiten0))
    Jt = J.mT
    H = Jt @ J
    b = _mv(Jt, r0)

    eye15 = torch.eye(15, dtype=dtype, device=dev)
    Hmm = H[:, :15, :15] + 1e-8 * eye15
    Hmk = H[:, :15, 15:]
    Hkk = H[:, 15:, 15:]
    Hmm_inv = torch.linalg.inv_ex(0.5 * (Hmm + Hmm.mT))[0]
    H_new = Hkk - Hmk.mT @ (Hmm_inv @ Hmk)
    b_new = b[:, 15:] - _mv(Hmk.mT, _mv(Hmm_inv, b[:, :15]))

    # Eigendecomposition-regularised square root (``:940-978``)
    evals, evecs = torch.linalg.eigh(0.5 * (H_new + H_new.mT))
    evals_c = torch.clamp(evals, min=0.0)
    sqrt_info = (evecs * torch.sqrt(evals_c)[:, None, :]) @ evecs.mT
    # r0 such that sqrt_info dx + r0 reproduces the gradient
    inv_sqrt = (evecs * torch.where(
        evals_c > 1e-8, 1.0 / torch.sqrt(torch.clamp(evals_c, min=1e-8)),
        torch.zeros_like(evals_c))[:, None, :]) @ evecs.mT
    r0_new = _mv(inv_sqrt, b_new)

    ident = eye15[0, :4]
    states = NavState(*(_shift(x) for x in win.states))
    states = states._replace(q=_shift(win.states.q, ident))
    pre = Preintegrated(*(_shift(x) for x in win.preints))
    pre = pre._replace(delta_q=_shift(win.preints.delta_q, ident),
                       covariance=_shift(win.preints.covariance,
                                         eye15[:9, :9] * 1e-4))
    return win._replace(
        states=states, timestamps=_shift(win.timestamps),
        meas_p=_shift(win.meas_p), meas_valid=_shift(win.meas_valid),
        meas_v=_shift(win.meas_v), meas_v_valid=_shift(win.meas_v_valid),
        meas_q=_shift(win.meas_q, ident),
        meas_q_valid=_shift(win.meas_q_valid),
        mean_acc=_shift(win.mean_acc), acc_valid=_shift(win.acc_valid),
        active=_shift(win.active), count=win.count - 1, preints=pre,
        pair_dt=_shift(win.pair_dt), pair_valid=_shift(win.pair_valid),
        lin_ba=_shift(win.lin_ba), lin_bg=_shift(win.lin_bg),
        prior_sqrt_info=sqrt_info, prior_r0=r0_new,
        prior_state=_slot(win.states, 1),
        prior_valid=torch.ones_like(win.prior_valid))


def _put(buf, i: int, value):
    """A copy of the lane buffer ``buf`` [B, K, ...] with slot ``i`` set to
    ``value``: a tensor [B, ...] is copied, a Python number filled in on
    the device (assigned by index it would be a blocking copy from the
    host)."""
    out = buf.clone()
    if isinstance(value, torch.Tensor):
        out[:, i] = value
    else:
        out[:, i].fill_(value)
    return out


def window_push(win: SlidingWindow, state_guess: NavState, timestamp,
                meas_p, meas_valid, preint: Preintegrated, pair_dt,
                config: WindowConfig = WindowConfig(),
                meas_v=None, meas_v_valid=False,
                meas_q=None, meas_q_valid=False,
                mean_acc=None, acc_valid=False,
                count: int | None = None) -> SlidingWindow:
    """Append a keyframe, marginalising the oldest first if the window is
    full. ``preint`` integrates from the previous keyframe to this one
    (unused for the first keyframe). ``count`` is the caller's host copy
    of ``win.count``; without it the count is read from the device (one
    synchronisation). The window's count afterwards is ``min(count, K -
    1) + 1``. On a lane window every tensor argument carries the lane axis
    (a Python number stands for every lane) and the lanes share ``count``.
    """
    K = config.window_size
    B = _lanes_of(win)
    if B is None:
        def lane(x):
            return _as_lane(x) if isinstance(x, (torch.Tensor, tuple)) else x

        return _one_lane(window_push(
            _as_lane(win), lane(state_guess), lane(timestamp), lane(meas_p),
            lane(meas_valid), lane(preint), lane(pair_dt), config,
            meas_v=lane(meas_v), meas_v_valid=lane(meas_v_valid),
            meas_q=lane(meas_q), meas_q_valid=lane(meas_q_valid),
            mean_acc=lane(mean_acc), acc_valid=lane(acc_valid),
            count=int(win.count) if count is None else count))
    dtype, dev = win.meas_p.dtype, win.meas_p.device
    if count is None:
        count = int(win.count[0])
    if meas_v is None:
        meas_v = torch.zeros((B, 3), dtype=dtype, device=dev)
    if meas_q is None:
        meas_q = _ident(B, dtype, dev)
    if mean_acc is None:
        mean_acc = torch.zeros((B, 3), dtype=dtype, device=dev)
    if count >= K:
        win = _marginalize_oldest(win, config)
        count -= 1
    i, j = count, max(count - 1, 0)  # insertion slot, its pair's slot
    prev = _slot(win.states, j)
    return win._replace(
        states=NavState(*(_put(b, i, v)
                          for b, v in zip(win.states, state_guess))),
        timestamps=_put(win.timestamps, i, timestamp),
        meas_p=_put(win.meas_p, i, meas_p),
        meas_valid=_put(win.meas_valid, i, meas_valid),
        meas_v=_put(win.meas_v, i, meas_v),
        meas_v_valid=_put(win.meas_v_valid, i, meas_v_valid),
        meas_q=_put(win.meas_q, i, meas_q),
        meas_q_valid=_put(win.meas_q_valid, i, meas_q_valid),
        mean_acc=_put(win.mean_acc, i, mean_acc),
        acc_valid=_put(win.acc_valid, i, acc_valid),
        active=_put(win.active, i, True),
        count=win.count + 1,
        preints=Preintegrated(*(_put(b, j, v)
                                for b, v in zip(win.preints, preint))),
        pair_dt=_put(win.pair_dt, j, pair_dt) if i > 0 else win.pair_dt,
        pair_valid=_put(win.pair_valid, j, i > 0),
        lin_ba=_put(win.lin_ba, j, prev.ba),
        lin_bg=_put(win.lin_bg, j, prev.bg))


def _newest_index(win: SlidingWindow):
    return torch.clamp(win.count.long() - 1, min=0)


def reset_to_measurement(win: SlidingWindow, meas_p,
                         config: WindowConfig = WindowConfig()
                         ) -> SlidingWindow:
    """Divergence recovery (``resetStateToUwb/Gps``, ``uwb_imu_batch_node.
    cpp:4135-4287``): the newest state's position snaps to the measurement,
    its velocity and biases to zero, and the prior is dropped."""
    s = win.states
    sel = (torch.arange(s.p.shape[0], device=s.p.device)
           == _newest_index(win))[:, None]
    zero = torch.zeros_like(s.v)
    return win._replace(
        states=s._replace(p=torch.where(sel, meas_p, s.p),
                          v=torch.where(sel, zero, s.v),
                          ba=torch.where(sel, zero, s.ba),
                          bg=torch.where(sel, zero, s.bg)),
        prior_valid=torch.zeros_like(win.prior_valid),
        prior_sqrt_info=torch.zeros_like(win.prior_sqrt_info),
        prior_r0=torch.zeros_like(win.prior_r0))


def window_is_diverged(win: SlidingWindow, meas_p,
                       max_position_error: float = 5.0):
    """Newest state too far from the raw measurement (PositionDriftFactor
    limit, ``uwb_imu_node.cpp:595-604``): a 0-d bool tensor."""
    p = win.states.p.index_select(0, _newest_index(win).reshape(1))[0]
    return torch.linalg.norm(p - meas_p) > max_position_error
