"""The port's NDT + ESKF fusion and the ``uwb_demo`` app against the JAX
package on the CPU.

- ``ndt_eskf_fusion`` on ``tests/test_fusion.py:10-42``'s stationary scene
  and small config, in f64, through ``convert.fusion_config``: odometry
  poses equal, iterations and evaluations equal to JAX's
  ``ndt_odometry``, fused p, v and q within 3e-16 (observed 1.2e-16);
- ``uwb_demo --device cpu --duration 20 --seed 1``: its own gate (exit 0,
  fused ATE < 0.5 m) and fused below the raw trilateration ATE. The
  port's draws come from a ``torch.Generator``, so the numbers are not
  JAX's; the gates are.
"""

import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.pipelines import fusion as jfusion  # noqa: E402
from toyslam_tpu.pipelines import odometry as jodo  # noqa: E402
from toyslam_tpu.registration import ndt as jndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.pipelines import fusion as tfusion  # noqa: E402

def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------------ fusion


def test_ndt_eskf_fusion_matches_jax_f64():
    """``tests/test_fusion.py:10-42``'s stationary scene and small config,
    in f64."""
    rng = np.random.default_rng(42)
    S, N, R = 3, 800, 20
    base = np.concatenate([
        np.stack([rng.uniform(-8, 8, N // 2), rng.uniform(-8, 8, N // 2),
                  0.05 * rng.normal(size=N // 2)], 1),
        np.stack([rng.uniform(-8, 8, N - N // 2),
                  np.full(N - N // 2, 4.0)
                  + 0.05 * rng.normal(size=N - N // 2),
                  rng.uniform(0, 3, N - N // 2)], 1)], 0)
    xyzi = np.full((S, N, 4), 1e9)
    for i in range(S):
        xyzi[i, :, :3] = base + 0.01 * rng.normal(size=base.shape)
        xyzi[i, :, 3] = 0
    mask = np.ones((S, N), bool)
    T = S * R
    acc = np.tile([0, 0, 9.81], (T, 1)) + 0.01 * rng.normal(size=(T, 3))
    gyro = 0.001 * rng.normal(size=(T, 3))
    dt = np.full((T,), 0.01)
    jcfg = jfusion.FusionConfig(
        odometry=jodo.OdometryConfig(
            ndt=jndt.NDTConfig(resolution=1.0, max_iterations=10,
                               map_capacity=2048, grid_capacity=1 << 14),
            scan_leaf=0.5, work_capacity=1024),
        imu_per_scan=R)
    args = [jnp.asarray(a) for a in (xyzi, mask, acc, gyro, dt)]
    want = jax.jit(jfusion.ndt_eskf_fusion, static_argnums=5)(*args, jcfg)
    jodo_out = jax.jit(jodo.ndt_odometry, static_argnums=2)(
        args[0], args[1], jcfg.odometry)
    cfg = convert.fusion_config(jcfg._asdict())
    assert cfg.imu_per_scan == R and cfg.odometry.work_capacity == 1024
    got = tfusion.ndt_eskf_fusion(*(torch.from_numpy(a) for a in
                                    (xyzi, mask, acc, gyro, dt)), cfg)
    assert got.converged.all() and np.asarray(want.converged).all()
    assert np.array_equal(got.poses.numpy(), np.asarray(want.poses))
    assert got.odometry.iterations.tolist() == np.asarray(
        jodo_out.iterations).tolist()
    assert got.odometry.evaluations.tolist() == np.asarray(
        jodo_out.evaluations).tolist()
    for g, w in ((got.fused_p, want.fused_p), (got.fused_v, want.fused_v),
                 (got.fused_q, want.fused_q)):
        _close(g, w, 3e-16)
    assert float(np.linalg.norm(got.fused_p[-1].numpy())) < 0.5


def test_uwb_demo_cpu_gates(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "toyslam_tpu_torch.apps.uwb_demo",
         str(tmp_path), "--device", "cpu", "--duration", "20", "--seed",
         "1"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    tri = float(re.search(r"trilateration: .*?ATE ([\d.]+) m",
                          proc.stdout).group(1))
    fused = float(re.search(r"ESKF fused .*?ATE ([\d.]+) m",
                            proc.stdout).group(1))
    assert "float64" in proc.stdout
    assert fused < 0.5 and fused < tri
    for f in ("solution_uwb.csv", "solution_eskf.csv", "anchors.json"):
        assert (tmp_path / f).exists()
