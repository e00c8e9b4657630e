"""The port's estimator pieces against the JAX package on the CPU: the
``core/se3`` quaternion and transform pieces, the simulators, the ESKF,
trilateration and the ``convert`` helpers of their configs and state.

Inputs from numpy with fixed seeds; where JAX draws from a PRNG key, the
test draws JAX's normals and feeds them to the port. Bounds, each about
twice what was observed (f64 throughout):

- se3: quaternions, rotations and transforms within 1e-15 to 2e-15
  (observed <= 8.9e-16); ``so3_log`` near 0 and near pi within 2e-15 rad
  (observed 8.9e-16); ``inv3`` (the adjugate) against numpy's LU inverse
  of random normal matrices within 1.5e-13 (observed 7.1e-14);
- the trajectories within 2e-15 (observed 8.9e-16); the IMU simulator
  from JAX's draws within 1e-16 (observed 2.8e-17), the ranges within
  8e-15 (observed 3.6e-15 on 30 m ranges);
- ``predict``/``update_position`` within 2e-17 (observed 6.9e-18; the
  port's 3x3 inverse is the adjugate, JAX's an LU); ``eskf_run`` over 400
  ticks with ``dt <= 0`` ticks and invalid measurements: p, v, q within
  3e-16 (observed 1.2e-16), the final covariance within 1e-15 (observed
  4.4e-16);
- ``solve_position`` with and without Huber weights: positions within
  4e-14 m (observed 1.8e-14), RMS within 4e-15 (observed 1.9e-15); the
  batch within 2e-13 m and 1e-14 (observed 8.2e-14, 5.0e-15).
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.estimators import eskf as jeskf  # noqa: E402
from toyslam_tpu.estimators import trilateration as jtri  # noqa: E402
from toyslam_tpu.pipelines import fusion as jfusion  # noqa: E402
from toyslam_tpu.pipelines import icp_slam as jslam  # noqa: E402
from toyslam_tpu.sim import sensors as jsensors  # noqa: E402
from toyslam_tpu.sim import trajectories as jtraj  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import se3 as tse3  # noqa: E402
from toyslam_tpu_torch.estimators import eskf as teskf  # noqa: E402
from toyslam_tpu_torch.estimators import trilateration as ttri  # noqa: E402
from toyslam_tpu_torch.sim import sensors as tsensors  # noqa: E402
from toyslam_tpu_torch.sim import trajectories as ttraj  # noqa: E402

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------- se3


def test_quaternion_pieces_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4))
    r = rng.normal(size=(32, 4))
    v = rng.normal(size=(32, 3))
    axis = rng.normal(size=(32, 3))
    ang = rng.uniform(-np.pi, np.pi, 32)
    t = rng.uniform(0, 1, (32, 1))
    jq, jr = jnp.asarray(q), jnp.asarray(r)
    qn, rn = jse3.quat_normalize(jq), jse3.quat_normalize(jr)
    pairs = [
        (tse3.quat_multiply(_t(q), _t(r)), jse3.quat_multiply(jq, jr)),
        (tse3.quat_conjugate(_t(q)), jse3.quat_conjugate(jq)),
        (tse3.quat_normalize(_t(q)), qn),
        (tse3.quat_to_rot(_t(q)), jse3.quat_to_rot(jq)),
        (tse3.quat_boxplus(_t(q), _t(v) * 0.1),
         jse3.quat_boxplus(jq, jnp.asarray(v) * 0.1)),
        (tse3.quat_rotate(_t(qn), _t(v)), jse3.quat_rotate(qn, jnp.asarray(v))),
        (tse3.quat_from_axis_angle(_t(axis), _t(ang)),
         jse3.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang))),
        (tse3.quat_slerp(_t(qn), _t(rn), _t(t)),
         jse3.quat_slerp(qn, rn, jnp.asarray(t))),
        # the small-angle branch of slerp: q against itself
        (tse3.quat_slerp(_t(qn), _t(qn), _t(t)),
         jse3.quat_slerp(qn, qn, jnp.asarray(t))),
    ]
    for got, want in pairs:
        _close(got, want, 1e-15)
    assert torch.equal(tse3.quat_identity(torch.float64, CPU),
                       torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64))


def test_so3_log_near_zero_and_pi_and_transforms():
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(24, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([[0.0, 1e-9, 1e-7, 1e-5],
                             rng.uniform(0.1, 3.0, 12),
                             np.pi - np.array([0.0, 1e-9, 1e-7, 1e-5, 1e-3,
                                               1e-2, 0.1, 0.3])])
    R = np.asarray(jse3.so3_exp(jnp.asarray(axes * angles[:, None])))
    _close(tse3.so3_log(_t(R)), jse3.so3_log(jnp.asarray(R)), 2e-15)
    T = np.tile(np.eye(4), (24, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(24, 3))
    pts = rng.normal(size=(24, 10, 4))
    _close(tse3.transform_inverse(_t(T)), jse3.transform_inverse(
        jnp.asarray(T)), 1e-15)
    for p in (pts, pts[..., :3]):
        _close(tse3.transform_points(_t(T), _t(p)),
               jse3.transform_points(jnp.asarray(T), jnp.asarray(p)), 2e-15)
    M = rng.normal(size=(16, 3, 3))
    _close(tse3.inv3(_t(M)), np.linalg.inv(M), 1.5e-13)


# ----------------------------------------------------------- simulators


@pytest.mark.parametrize("name", ["circle", "helix", "figure8", "circuit",
                                  "line"])
def test_trajectories_match_jax(name):
    t = np.linspace(0.0, 80.0, 801)
    want = getattr(jtraj, name)(jnp.asarray(t))
    got = getattr(ttraj, name)(_t(t))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 2e-15)


def test_simulators_from_jax_draws():
    t = np.arange(300) * 0.005
    jt = jtraj.circle(jnp.asarray(t), radius=30.0, omega=0.08)
    tt = ttraj.circle(_t(t), radius=30.0, omega=0.08)
    key = jax.random.PRNGKey(4)
    acc, gyro = jsensors.simulate_imu(key, jt)
    k_a, k_g = jax.random.split(key)
    za = np.asarray(jax.random.normal(k_a, (300, 3), jnp.float64))
    zg = np.asarray(jax.random.normal(k_g, (300, 3), jnp.float64))
    tacc, tgyro = tsensors.imu_from_noise(tt, _t(za), _t(zg))
    _close(tacc, acc, 1e-16)
    _close(tgyro, gyro, 1e-16)
    beacons = jsensors.DEFAULT_BEACONS.astype(jnp.float64)
    ranges = jsensors.simulate_uwb_ranges(key, jt["pos"], beacons, 0.1)
    noise = 0.1 * np.asarray(jax.random.normal(key, (300, 5), jnp.float64))
    got = tsensors.ranges_from_noise(tt["pos"], tsensors.DEFAULT_BEACONS,
                                     _t(noise))
    _close(got, ranges, 8e-15)
    gen = torch.Generator().manual_seed(0)
    a2, g2 = tsensors.simulate_imu(gen, tt)
    r2 = tsensors.simulate_uwb_ranges(gen, tt["pos"])
    assert a2.shape == (300, 3) and g2.shape == (300, 3)
    assert r2.shape == (300, 5) and bool(torch.isfinite(r2).all())


# ------------------------------------------------------------------ ESKF


def _log(T=400, seed=6):
    """A level platform on a gentle curve: IMU at 200 Hz with noise, a
    position fix every 20th tick (every 7th of them dropped), and three
    ticks with dt <= 0."""
    rng = np.random.default_rng(seed)
    dt = np.full(T, 0.005)
    dt[[50, 51, 200]] = [0.0, -0.005, 0.0]
    acc = np.tile([0.05, 0.02, 9.81], (T, 1)) + 0.03 * rng.normal(size=(T, 3))
    gyro = np.tile([0.0, 0.0, 0.05], (T, 1)) + 0.002 * rng.normal(
        size=(T, 3))
    meas = np.zeros((T, 3))
    valid = np.zeros(T, bool)
    ticks = np.arange(19, T, 20)
    tt = (ticks + 1) * 0.005
    meas[ticks] = np.stack([0.5 * 0.05 * tt**2, 0.5 * 0.02 * tt**2,
                            np.zeros_like(tt)], 1) + 0.01 * rng.normal(
        size=(len(ticks), 3))
    valid[ticks] = True
    valid[ticks[::7]] = False
    return dt, acc, gyro, meas, valid


def _state_close(got, want, atol):
    for g, w in zip(got, want):
        _close(g, w, atol)


def test_predict_and_update_match_jax():
    params = jeskf.ESKFParams(acc_noise=0.03, meas_noise=0.01)
    tparams = convert.eskf_params(params._asdict())
    rng = np.random.default_rng(2)
    js = jeskf.init_state(jnp.float64, params)._replace(
        p=jnp.asarray(rng.normal(size=3)), v=jnp.asarray(rng.normal(size=3)),
        q=jse3.quat_normalize(jnp.asarray(rng.normal(size=4))),
        ba=jnp.asarray(0.01 * rng.normal(size=3)))
    ts = convert.eskf_state({k: np.asarray(v) for k, v in
                             js._asdict().items()}, CPU)
    acc, gyro = rng.normal(size=3) + [0, 0, 9.81], 0.1 * rng.normal(size=3)
    for dt in (0.005, 0.0, -0.01):
        want = jeskf.predict(js, jnp.asarray(acc), jnp.asarray(gyro), dt,
                             params)
        got = teskf.predict(ts, _t(acc), _t(gyro), dt, tparams)
        _state_close(got, want, 2e-17)
    js = jeskf.predict(js, jnp.asarray(acc), jnp.asarray(gyro), 0.005,
                       params)
    ts = teskf.predict(ts, _t(acc), _t(gyro), 0.005, tparams)
    z = rng.normal(size=3)
    for valid in (True, False):
        want = jeskf.update_position(js, jnp.asarray(z), params, valid)
        got = teskf.update_position(ts, _t(z), tparams,
                                    torch.tensor(valid))
        _state_close(got, want, 2e-17)


def test_eskf_run_matches_jax():
    dt, acc, gyro, meas, valid = _log()
    params = jeskf.ESKFParams(acc_noise=0.03, gyro_noise=0.002,
                              meas_noise=0.01)
    jlog = jeskf.ESKFLog(*(jnp.asarray(a) for a in (dt, acc, gyro, meas,
                                                    valid)))
    final, traj = jax.jit(jeskf.eskf_run)(jlog, None, params)
    tlog = teskf.ESKFLog(*(torch.from_numpy(a) for a in (dt, acc, gyro, meas,
                                                         valid)))
    tfinal, ttraj_ = teskf.eskf_run(tlog, None,
                                    convert.eskf_params(params._asdict()))
    assert ttraj_["p"].device.type == "cpu"
    for k in ("p", "v", "q"):
        _close(ttraj_[k], traj[k], 3e-16)
    _close(tfinal.P, final.P, 1e-15)
    # The dt <= 0 ticks left the state as it was.
    assert torch.equal(ttraj_["p"][50], ttraj_["p"][49])


# --------------------------------------------------------- trilateration


def _ranges(seed=9, T=40):
    rng = np.random.default_rng(seed)
    theta = np.arange(8) * 2 * np.pi / 8
    anchors = np.stack([50 * np.cos(theta), 50 * np.sin(theta),
                        3.0 * (np.arange(8) % 4)], -1)
    pos = np.stack([30 * np.cos(0.1 * np.arange(T)),
                    30 * np.sin(0.1 * np.arange(T)), np.ones(T)], -1)
    r = np.linalg.norm(pos[:, None] - anchors[None], axis=-1)
    r += 0.3 * rng.normal(size=r.shape)
    r[::5, 2] += 2.0  # NLOS spikes
    return r, anchors


@pytest.mark.parametrize("huber", [0.0, 0.5])
def test_solve_position_matches_jax(huber):
    r, anchors = _ranges()
    jcfg = jtri.TrilaterationConfig(huber_delta=huber)
    cfg = ttri.TrilaterationConfig(**jcfg._asdict())
    guess = np.array([1.0, 0.0, 0.5])
    valid = np.ones(8, bool)
    valid[3] = False
    for v in (None, valid):
        p, rms = jtri.solve_position(
            jnp.asarray(r[0]), jnp.asarray(anchors), jnp.asarray(guess),
            None if v is None else jnp.asarray(v), jcfg)
        tp, trms = ttri.solve_position(
            _t(r[0]), _t(anchors), _t(guess),
            None if v is None else torch.from_numpy(v), cfg)
        _close(tp, p, 4e-14)
        _close(trms, rms, 4e-15)
    p, rms = jtri.solve_positions_batch(jnp.asarray(r), jnp.asarray(anchors),
                                        jnp.asarray(guess), jcfg)
    tp, trms = ttri.solve_positions_batch(_t(r), _t(anchors), _t(guess), cfg)
    assert tp.shape == (r.shape[0], 3)
    _close(tp, p, 2e-13)
    _close(trms, rms, 1e-14)


def test_convert_helpers():
    jcfg = jslam.IcpSlamConfig(map_capacity=128, map_leaf=0.5)
    cfg = convert.icp_slam_config(jcfg._asdict())
    assert cfg.map_capacity == 128 and cfg.map_leaf == 0.5
    assert all(getattr(cfg.icp, k) == v for k, v in jcfg.icp._asdict().items()
               if k in cfg.icp._fields)
    fcfg = convert.fusion_config(jfusion.FusionConfig()._asdict())
    assert fcfg.eskf._asdict() == jfusion.FusionConfig().eskf._asdict()
    assert fcfg.odometry.ndt.grid_capacity == 1 << 15  # JAX's own value
    js = jeskf.init_state(jnp.float64)
    ts = convert.eskf_state(js, CPU)
    for g, w in zip(ts, js):
        assert g.dtype == torch.float64 and np.array_equal(g.numpy(),
                                                           np.asarray(w))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the card's default is tested in test_torch_gpu")
def test_convert_eskf_state_defaults_to_the_card():
    """Without a card, the default device raises: nothing falls back to
    the host."""
    with pytest.raises((RuntimeError, AssertionError)):
        convert.eskf_state(jeskf.init_state(jnp.float64))


