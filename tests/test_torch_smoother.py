"""The port's sliding-window smoother against the JAX package on the CPU:
``estimators/preintegration``, ``factors``, ``window``, ``deadreckon``,
``pipelines/batch_fusion`` and the ``fusion_demo`` app, with the
``convert`` and ``config`` helpers of their configs and state.

The same numpy inputs (a 3 m circle at 0.4 rad/s, a 200 Hz IMU from the
port's simulator with numpy normals, 0.1 m position fixes) go through
both packages in f64; JAX's side is one jit. Bounds, each about twice
what was observed:

- ``preintegrate`` over a chunk with an interior hole and gated dts:
  every field within 4e-17 (observed 1.4e-17), two chunks as a batch
  equal to each alone within 1e-15;
- ``imu_residual`` within 5e-16 (observed 2.2e-16); ``imu_sqrt_info``'s
  whitener within 5e-16 of its largest entry (observed 1.8e-16), the
  identity on both sides where the Cholesky fails;
- the 3-slot window of ``tests/test_window.py`` (a 5 m outlier on slot 0,
  a 30 deg yaw fix): ``window_push`` equal; the prior of
  ``_marginalize_oldest``, relative to its largest entry: with the Huber
  weight ``prior_sqrt_info`` within 8e-11 (observed 3.3e-11), with the
  yaw-only factor within 4e-9 (observed 1.5e-9: the square roots of
  eigenvalues near zero magnify rounding; eigenvectors are not compared,
  their signs and order being free), ``prior_r0`` within 2e-14 (observed
  8.3e-15); JAX's own inequalities (Huber shrinks the prior, the yaw
  factor adds heading information) hold on the port's priors;
  ``window_optimize`` with the Huber weight within 6e-13 (observed
  2.6e-13);
- ``batch_fusion`` in GPS mode with the yaw-only factor, velocity fixes,
  an IMU gap (chunk 6 empty), a fix 4 m off at keyframe 9 (a divergence
  reset) and a missing fix at keyframe 3: the same resets, keyframe
  positions within 6e-11 m (observed 2.9e-11), attitudes, velocities and
  biases within 2e-10 (observed 8.5e-11), the final prior within 2e-10
  of its largest entry (observed 6.8e-11). The window's normal equations
  are ill-conditioned (a condition number of ~1e17 on logs like the
  benchmark's), so rounding grows along a log;
- ``high_rate_trajectory`` within 4e-10 (it starts from keyframe states
  8.5e-11 apart; observed 1.9e-10), ``calibrate_stationary`` within
  3e-15 (observed 1.3e-15), ``dead_reckon`` within 4e-16 (observed
  1.8e-16);
- a resume from a checkpoint equal to the whole run bit for bit, and a
  window saved by either package loads in the other unchanged;
- the Jacobians of the window and of the marginalisation stay f32 in an
  f32 run (``torch.func`` promotes some 0-d values to f64);
- ``fusion_demo`` on the CPU over 3.5 s (14 keyframes, window 10): its files, and the smoothed track
  closer to the truth than the fixes.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_window as jtest_window  # noqa: E402

from toyslam_tpu import config as jconfig  # noqa: E402
from toyslam_tpu.estimators import deadreckon as jdr  # noqa: E402
from toyslam_tpu.estimators import factors as jfactors  # noqa: E402
from toyslam_tpu.estimators import preintegration as jpre  # noqa: E402
from toyslam_tpu.estimators import window as jwindow  # noqa: E402
from toyslam_tpu.pipelines import batch_fusion as jbf  # noqa: E402
from toyslam_tpu.utils import checkpoint as jckpt  # noqa: E402
from toyslam_tpu_torch import config as tconfig  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.estimators import deadreckon as tdr  # noqa: E402
from toyslam_tpu_torch.estimators import factors as tfactors  # noqa: E402
from toyslam_tpu_torch.estimators import preintegration as tpre  # noqa: E402
from toyslam_tpu_torch.estimators import window as twindow  # noqa: E402
from toyslam_tpu_torch.pipelines import batch_fusion as tbf  # noqa: E402
from toyslam_tpu_torch.sim import sensors as tsensors  # noqa: E402
from toyslam_tpu_torch.sim import trajectories as ttraj  # noqa: E402
from toyslam_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

CPU = "cpu"
M, R = 12, 20  # keyframes, IMU samples a keyframe
PARAMS = dict(acc_noise=0.03, gyro_noise=0.002)
BF_WINDOW = dict(window_size=6, gn_iterations=4, use_gps=True,
                 gps_pos_sigma=0.1, gps_pos_z_sigma_factor=1.0,
                 use_gps_velocity=True, gps_vel_sigma=0.05,
                 use_yaw_only_orientation=True, yaw_weight=2.0,
                 simplified_first_n=3)
HUBER = dict(window_size=3, pos_sigma=0.05, huber_delta=0.1)
YAW = dict(window_size=3, use_gps=True, gps_pos_sigma=0.1,
           gps_pos_z_sigma_factor=1.0, use_gps_velocity=False,
           yaw_weight=2.0)


def _log(seed=2):
    """A GPS log of M keyframes: IMU chunks [M, R], fixes of position
    (0.1 m), velocity (0.05 m/s) and attitude; chunk 6 empty, fix 3
    missing, fix 9 4 m off."""
    rng = np.random.default_rng(seed)
    T = M * R
    t = (torch.arange(T, dtype=torch.float64) + 1) / 200.0
    traj = ttraj.circle(t, radius=3.0, omega=0.4)
    acc, gyro = tsensors.imu_from_noise(
        traj, torch.from_numpy(rng.normal(size=(T, 3))),
        torch.from_numpy(rng.normal(size=(T, 3))))
    kf = np.arange(R - 1, T, R)
    valid = np.ones((M, R), bool)
    valid[6] = False
    p = traj["pos"].numpy()[kf] + 0.1 * rng.normal(size=(M, 3))
    p[9, 0] += 4.0
    p_ok = np.ones(M, bool)
    p_ok[3] = False
    return dict(acc=acc.numpy().reshape(M, R, 3),
                gyro=gyro.numpy().reshape(M, R, 3),
                dt=np.full((M, R), 0.005), valid=valid, t=t.numpy()[kf],
                p=p, p_ok=p_ok,
                v=traj["vel"].numpy()[kf] + 0.05 * rng.normal(size=(M, 3)),
                v_ok=np.ones(M, bool), q=traj["quat"].numpy()[kf],
                q_ok=np.ones(M, bool), gt=traj["pos"].numpy()[kf])


def _chunk(seed=0):
    """One chunk with an interior hole, a zero dt and an over-long dt, its
    biases and start-frame gravity."""
    rng = np.random.default_rng(seed)
    acc = np.tile([0.1, 0.0, 9.81], (R, 1)) + 0.05 * rng.normal(size=(R, 3))
    gyro = 0.1 * rng.normal(size=(R, 3))
    dt = np.full(R, 0.005)
    dt[3], dt[11] = 0.0, 0.7
    valid = np.ones(R, bool)
    valid[7:9] = False
    return dict(acc=acc, gyro=gyro, dt=dt, valid=valid,
                ba=0.01 * rng.normal(size=3), bg=0.001 * rng.normal(size=3),
                gs=np.array([0.1, -0.2, -9.8]))


def _states(seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(p=rng.normal(size=(2, 3)), q=q, v=rng.normal(size=(2, 3)),
                ba=0.01 * rng.normal(size=(2, 3)),
                bg=0.001 * rng.normal(size=(2, 3)))


def _small_window(lib, cfg, dtype):
    """``tests/test_window.py``'s 3-keyframe window through ``lib``'s
    window_push (the port's with its host count)."""
    if lib is jwindow:
        return jtest_window._small_window_with_outlier(cfg, dtype)
    win = twindow.window_init(cfg, dtype, CPU)
    pre = tpre.Preintegrated(*(x[0] for x in twindow._empty_preint(
        1, dtype, CPU)))
    zero = torch.zeros(3, dtype=dtype)
    g = tfactors.NavState(zero, twindow._ident(1, dtype, CPU)[0], zero,
                          zero, zero)
    c, s = math.cos(math.radians(15.0)), math.sin(math.radians(15.0))
    yaw_fix = torch.tensor([c, 0.0, 0.0, s], dtype=dtype)
    for k in range(3):
        meas = torch.tensor([5.0 if k == 0 else k * 0.1, 0.0, 0.0],
                            dtype=dtype)
        win = twindow.window_push(
            win, g._replace(p=torch.tensor([k * 0.1, 0.0, 0.0],
                                           dtype=dtype)),
            float(k), meas, True, pre, 0.5, cfg, meas_q=yaw_fix,
            meas_q_valid=k == 0, count=k)
    return win


def _side(lib, ch, st, log):
    """What the tests compare, through one package (``lib`` names the JAX
    or the port side); inputs are arrays of that side."""
    jax_side = lib == "jax"
    pre_m, fac, win_m, bf, dr = ((jpre, jfactors, jwindow, jbf, jdr)
                                 if jax_side else
                                 (tpre, tfactors, twindow, tbf, tdr))
    dtype = jnp.float64 if jax_side else torch.float64
    out = {}
    params = pre_m.PreintegrationParams(**PARAMS)
    pre = pre_m.preintegrate(ch["acc"], ch["gyro"], ch["dt"], ch["ba"],
                             ch["bg"], gravity_sensor=ch["gs"],
                             params=params, valid=ch["valid"])
    out["pre"] = pre
    s_i = fac.NavState(*(st[k][0] for k in ("p", "q", "v", "ba", "bg")))
    s_j = fac.NavState(*(st[k][1] for k in ("p", "q", "v", "ba", "bg")))
    out["imu_r"] = fac.imu_residual(s_i, s_j, pre, ch["dt"].sum(),
                                    s_i.ba * 0.5, s_i.bg * 2.0)
    out["sqrt_info"] = fac.imu_sqrt_info(pre)
    bad = pre._replace(covariance=-pre.covariance - ch["gs"][0] ** 2)
    out["sqrt_info_bad"] = fac.imu_sqrt_info(bad)
    out["deltas"] = pre_m.correct_for_bias_change(pre, ch["ba"], ch["bg"])

    WC = win_m.WindowConfig
    # The window does not depend on the factor configuration (only on K).
    win = _small_window(win_m, WC(**HUBER), dtype)
    out["win"] = win
    cfgs = {"huber": WC(**HUBER),
            "yaw": WC(**YAW)._replace(use_yaw_only_orientation=True)}
    if not jax_side:  # the JAX test's counterparts, on the port alone
        cfgs.update(plain=WC(**HUBER)._replace(huber_delta=0.0),
                    noyaw=WC(**YAW))
    for name, cfg in cfgs.items():
        out[f"marg_{name}"] = win_m._marginalize_oldest(win, cfg)
    out["opt_huber"] = win_m.window_optimize(win, cfgs["huber"])

    cfg = bf.BatchFusionConfig(window=WC(**BF_WINDOW), preint=params,
                               max_position_error=2.0)
    run = bf.batch_fusion(log["acc"], log["gyro"], log["dt"], log["valid"],
                          log["t"], log["p"], log["p_ok"], meas_v=log["v"],
                          meas_v_valid=log["v_ok"], meas_q=log["q"],
                          meas_q_valid=log["q_ok"], config=cfg)
    out["bf"] = run
    kf = fac.NavState(run.kf_p, run.kf_q, run.kf_v, run.kf_ba, run.kf_bg)
    out["high_rate"] = bf.high_rate_trajectory(
        kf, log["acc"], log["gyro"], log["dt"], log["valid"], cfg)
    acc, gyro = log["acc"][0], log["gyro"][0]
    gb, ab, q0 = dr.calibrate_stationary(acc, gyro)
    out["calib"] = (gb, ab, q0)
    out["dead_reckon"] = dr.dead_reckon(log["acc"][1], log["gyro"][1],
                                        log["dt"][1], gb, ab, q0)
    return out


@pytest.fixture(scope="module")
def sides():
    ch, st, log = _chunk(), _states(), _log()
    got = _side("torch", *({k: torch.from_numpy(np.asarray(v))
                            for k, v in d.items()} for d in (ch, st, log)))
    want = jax.jit(lambda *a: _side("jax", *a))(
        *({k: jnp.asarray(v) for k, v in d.items()} for d in (ch, st, log)))
    return got, want, log


def _close(got, want, atol, rtol=0.0):
    if hasattr(got, "_fields"):
        for g, w in zip(got, want):
            _close(g, w, atol, rtol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _eq(got, want):
    if hasattr(got, "_fields"):
        for g, w in zip(got, want):
            _eq(g, w)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_preintegrate_matches_jax(sides):
    got, want, _ = sides
    _close(got["pre"], want["pre"], 4e-17)
    _close(got["deltas"], want["deltas"], 4e-17)
    ch = {k: torch.from_numpy(np.asarray(v)) for k, v in _chunk().items()}
    ch2 = {k: torch.from_numpy(np.asarray(v)) for k, v in _chunk(1).items()}
    both = tpre.preintegrate(
        *(torch.stack([ch[k], ch2[k]]) for k in ("acc", "gyro", "dt", "ba",
                                                  "bg")),
        gravity_sensor=torch.stack([ch["gs"], ch2["gs"]]),
        valid=torch.stack([ch["valid"], ch2["valid"]]))
    for b, c in enumerate((ch, ch2)):
        one = tpre.preintegrate(c["acc"], c["gyro"], c["dt"], c["ba"],
                                c["bg"], gravity_sensor=c["gs"],
                                valid=c["valid"])
        for x, y in zip(both, one):
            np.testing.assert_allclose(x[b].numpy(), y.numpy(), rtol=0,
                                       atol=1e-15)


def test_imu_factors_match_jax(sides):
    got, want, _ = sides
    _close(got["imu_r"], want["imu_r"], 5e-16)
    U, ba_w, bg_w = got["sqrt_info"]
    jU, jba_w, jbg_w = want["sqrt_info"]
    _close(U, jU, 5e-16 * float(np.abs(np.asarray(jU)).max()))
    _close(ba_w, jba_w, 0, 1e-14)
    _close(bg_w, jbg_w, 0, 1e-14)
    _eq(got["sqrt_info_bad"][0], torch.eye(9, dtype=torch.float64))
    _eq(got["sqrt_info_bad"][0], want["sqrt_info_bad"][0])


def test_window_push_and_marginalization_match_jax(sides):
    got, want, _ = sides
    _eq(got["win"], want["win"])
    for name, rtol in (("huber", 8e-11), ("yaw", 4e-9)):
        m, jm = got[f"marg_{name}"], want[f"marg_{name}"]
        for f, r in (("prior_sqrt_info", rtol), ("prior_r0", 2e-14)):
            scale = float(np.abs(np.asarray(getattr(jm, f))).max())
            _close(getattr(m, f), getattr(jm, f), r * scale)
        _eq(m.states.p, jm.states.p)
        assert int(m.count) == 2 and bool(m.prior_valid)
    # JAX's own claims (tests/test_window.py) on the port's priors
    h, n = got["marg_huber"], got["marg_plain"]
    assert (torch.linalg.norm(h.prior_r0)
            < 0.5 * torch.linalg.norm(n.prior_r0))
    assert (torch.linalg.norm(h.prior_sqrt_info[:3, :3])
            < torch.linalg.norm(n.prior_sqrt_info[:3, :3]))
    y, ny = got["marg_yaw"], got["marg_noyaw"]
    assert not torch.allclose(y.prior_r0, ny.prior_r0)
    assert y.prior_sqrt_info[5, 5] >= ny.prior_sqrt_info[5, 5]
    _close(got["opt_huber"].states, want["opt_huber"].states, 6e-13)
    _eq(got["opt_huber"].opt_count, want["opt_huber"].opt_count)


def test_batch_fusion_reset_and_gap_match_jax(sides):
    got, want, log = sides
    run, jrun = got["bf"], want["bf"]
    _eq(run.reset, jrun.reset)
    assert run.reset.numpy()[9] and int(run.reset.sum()) == 1
    _close(run.kf_p, jrun.kf_p, 6e-11)
    for f in ("kf_q", "kf_v", "kf_ba", "kf_bg"):
        _close(getattr(run, f), getattr(jrun, f), 2e-10)
    err = np.linalg.norm(run.kf_p.numpy() - log["gt"], axis=1)
    assert np.isfinite(err).all() and err[10:].max() < 1.0
    _close(run.win.prior_sqrt_info, jrun.win.prior_sqrt_info,
           2e-10 * float(np.abs(np.asarray(jrun.win.prior_sqrt_info)).max()))


def test_high_rate_and_dead_reckon_match_jax(sides):
    got, want, _ = sides
    for g, w in zip(got["high_rate"], want["high_rate"]):
        _close(g, w, 4e-10)  # from keyframe states 8.5e-11 apart
    for g, w in zip(got["calib"], want["calib"]):
        _close(g, w, 3e-15)
    for g, w in zip(got["dead_reckon"], want["dead_reckon"]):
        _close(g, w, 4e-16)


def test_resume_bit_identical_and_checkpoints_cross(sides, tmp_path):
    full = sides[0]["bf"]
    log = {k: torch.from_numpy(np.asarray(v)) for k, v in sides[2].items()}
    cfg = tbf.BatchFusionConfig(
        window=twindow.WindowConfig(**BF_WINDOW),
        preint=tpre.PreintegrationParams(**PARAMS), max_position_error=2.0)
    keys = ("acc", "gyro", "dt", "valid", "t", "p", "p_ok")

    def run(sl, **kw):
        return tbf.batch_fusion(
            *(log[k][sl] for k in keys), meas_v=log["v"][sl],
            meas_v_valid=log["v_ok"][sl], meas_q=log["q"][sl],
            meas_q_valid=log["q_ok"][sl], config=cfg, **kw)

    half = run(slice(0, 8))
    path = tmp_path / "win.npz"
    tckpt.save_checkpoint(path, half.win)
    restored = tckpt.load_checkpoint(path, half.win)
    last = tfactors.NavState(half.kf_p[-1], half.kf_q[-1], half.kf_v[-1],
                             half.kf_ba[-1], half.kf_bg[-1])
    resumed = run(slice(8, None), init_window=restored, init_state=last,
                  initialized=True)
    for f in ("kf_p", "kf_q", "kf_v", "kf_ba", "kf_bg", "reset"):
        assert torch.equal(getattr(resumed, f), getattr(full, f)[8:])
    assert all(torch.equal(a, b) for a, b in zip(
        checkpoint_leaves(resumed.win), checkpoint_leaves(full.win)))
    # The port's window in JAX's structure and back, unchanged.
    jtemplate = jwindow.window_init(jwindow.WindowConfig(**BF_WINDOW),
                                    jnp.float64)
    jwin = jckpt.load_checkpoint(path, jtemplate)
    jckpt.save_checkpoint(tmp_path / "jwin.npz", jwin)
    back = tckpt.load_checkpoint(tmp_path / "jwin.npz", half.win)
    _eq(back, half.win)
    _eq(convert.sliding_window(jwin, device=CPU), half.win)


def checkpoint_leaves(tree):
    return [leaf for _, leaf in tckpt._flatten(tree)]


def test_f32_jacobians_stay_f32():
    cfg = twindow.WindowConfig(**HUBER)
    win = _small_window(twindow, cfg, torch.float32)
    seen = []
    orig = twindow._residual_and_jacobian

    def spy(fn, n, like):
        r0, J = orig(fn, n, like)
        seen.append((r0.dtype, J.dtype))
        return r0, J

    twindow._residual_and_jacobian = spy
    try:
        out = twindow.window_optimize(twindow._marginalize_oldest(win, cfg),
                                      cfg)
    finally:
        twindow._residual_and_jacobian = orig
    assert seen and all(d == (torch.float32,) * 2 for d in seen)
    assert out.states.p.dtype == torch.float32
    assert bool(torch.isfinite(out.states.p).all())


def test_fusion_demo_cpu(tmp_path):
    from toyslam_tpu_torch.apps import fusion_demo

    assert fusion_demo.main([str(tmp_path), "--duration", "3.5",
                             "--device", "cpu"]) == 0
    for name in ("trajectory.txt", "solution.csv", "metrics.jsonl"):
        assert (tmp_path / name).stat().st_size > 0
    with pytest.raises(NotImplementedError):
        fusion_demo.main([str(tmp_path), "--bag", "x.bag", "--device", "cpu"])


def test_smoother_configs_and_convert():
    for kind, conv in (("window", convert.window_config),
                       ("preintegration", convert.preintegration_params),
                       ("batch_fusion", convert.batch_fusion_config)):
        jcls = jconfig.default(kind)
        assert conv(jcls._asdict()) == tconfig.SECTIONS[kind]()
    example = Path(__file__).resolve().parents[1] / "configs" / "example.json"
    loaded = jconfig.load(example)
    for kind, conv in (("window", convert.window_config),
                       ("batch_fusion", convert.batch_fusion_config)):
        if kind in loaded:
            assert tconfig.load_section(example, kind) == conv(
                loaded[kind]._asdict())
    st = _states()
    nav = convert.nav_state(jfactors.NavState(
        *(st[k][0] for k in ("p", "q", "v", "ba", "bg"))), device=CPU)
    assert torch.equal(nav.q, torch.from_numpy(st["q"][0]))
