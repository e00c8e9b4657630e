"""JAX references for the PyTorch port's smoother on a machine without
JAX (``chip_smoke.py`` phase 26, ``tests/test_torch_gpu.py``):

    python tests/jax_smoother_refs.py            # writes the fixture
    python tests/jax_smoother_refs.py --drift    # prints the drift

- The inputs of ``tests/test_window.py::test_window_f32_matches_f64``:
  13 keyframes of 50 IMU samples at 200 Hz on a 3 m circle at 0.4
  rad/s, the IMU from ``sim/sensors.simulate_imu`` and 0.05 m position
  fixes, both drawn from ``jax.random.PRNGKey(5)`` as the test draws
  them, in f64, written to ``tests/fixtures/window_f32_k10_seed5.npz``
  (``tests/test_torch_smoother.py`` checks that the file holds them).
  The port's f32 run on the card is held to that test's bounds on them.
- ``--drift``: the JAX package's own f32-against-f64 drift of
  ``batch_fusion`` on ``bench.py``'s smoother log (smoother-w20: 256
  keyframes of 20 samples, window 20, seed 2), on the CPU; one JSON line.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "window_f32_k10_seed5.npz")


def window_inputs(n_kf=13, imu_per_kf=50, hz=200.0, seed=5):
    """The test's arrays: acc, gyro, quat [T, ...], meas [n_kf, 3], the
    attitude at t = 0 (q0) and the keyframes' true positions (gt)."""
    import jax
    import jax.numpy as jnp

    from toyslam_tpu.sim import sensors, trajectories

    dt = 1.0 / hz
    T = n_kf * imu_per_kf
    t = (jnp.arange(T, dtype=jnp.float64) + 1) * dt
    traj = trajectories.circle(t, radius=3.0, omega=0.4)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    acc, gyro = sensors.simulate_imu(k1, traj)
    kf_idx = jnp.arange(imu_per_kf - 1, T, imu_per_kf)
    meas = traj["pos"][kf_idx] + 0.05 * jax.random.normal(
        k2, (n_kf, 3), jnp.float64)
    q0 = trajectories.circle(jnp.zeros((), jnp.float64), 3.0, 0.4)["quat"]
    return {k: np.asarray(v, np.float64) for k, v in dict(
        acc=acc, gyro=gyro, quat=traj["quat"], meas=meas, q0=q0,
        gt=traj["pos"][kf_idx]).items()}


def bench_log(M=256, R=20, seed=2):
    """``bench.py``'s smoother log (f32 numpy, as it builds it)."""
    rng = np.random.default_rng(seed)
    t = np.arange(M) * 0.1
    meas_p = (np.stack([np.cos(t), np.sin(t), 0 * t], 1).astype(np.float32)
              + rng.normal(0, 0.05, (M, 3)).astype(np.float32))
    acc = (np.tile(np.asarray([0.0, 0.0, 9.81], np.float32), (M, R, 1))
           + rng.normal(0, 0.02, (M, R, 3)).astype(np.float32))
    gyro = rng.normal(0, 0.01, (M, R, 3)).astype(np.float32)
    return dict(acc=acc, gyro=gyro, dt=np.full((M, R), 0.005, np.float32),
                valid=np.ones((M, R), bool), t=t.astype(np.float32),
                p=meas_p)


def drift():
    """JAX's f32-vs-f64 batch_fusion drift on the bench log."""
    import jax
    import jax.numpy as jnp

    from toyslam_tpu.pipelines import batch_fusion

    log = bench_log()
    M = log["p"].shape[0]
    run = jax.jit(lambda *a: batch_fusion.batch_fusion(
        *a, config=batch_fusion.BatchFusionConfig()))
    out = {}
    for dt in (jnp.float32, jnp.float64):
        args = [jnp.asarray(log[k], dt) for k in ("acc", "gyro", "dt")]
        args += [jnp.asarray(log["valid"]), jnp.asarray(log["t"], dt),
                 jnp.asarray(log["p"], dt), jnp.ones(M, bool)]
        out[dt] = run(*args)
    dp = np.linalg.norm(np.asarray(out[jnp.float32].kf_p, np.float64)
                        - np.asarray(out[jnp.float64].kf_p), axis=1)
    dv = np.linalg.norm(np.asarray(out[jnp.float32].kf_v, np.float64)
                        - np.asarray(out[jnp.float64].kf_v), axis=1)
    return {"keyframes": M, "pos_max_m": float(dp.max()),
            "vel_median_m_s": float(np.median(dv)),
            "pos_at_keyframe_2_m": float(dp[2])}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if "--drift" in sys.argv[1:]:
        print(json.dumps(drift()))
    else:
        np.savez_compressed(FIXTURE, **window_inputs())
        print(f"wrote {FIXTURE}")
