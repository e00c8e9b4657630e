"""The slice end to end: NDT odometry of the PyTorch port against the JAX
package, and the port importing without JAX.

Four generated 16 x 512-ray scans go through both ``ndt_odometry``s under
the shipped ``OdometryConfig`` (frozen line search, 4 regathers, eps 1e-3)
with the working capacity cut to 4096 for the small scans. Bounds: f64
poses within 1e-8 m (observed ~1e-14) with equal per-scan iterations,
evaluations and gathers; f32 within 5e-4 m (observed ~2e-4: f32 map sums
and host Newton steps round differently from JAX's).
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.pipelines import odometry as jodo  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.pipelines import odometry as todo  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402

CFG = jodo.OdometryConfig(work_capacity=4096)


@pytest.fixture(scope="module")
def scans():
    xyzi, mask, _ = spinning_lidar_scans(2, 4, 16, 512)
    return xyzi, mask


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8),
                                       (np.float32, 5e-4)])
def test_ndt_odometry_matches_jax(scans, dtype, tol):
    xyzi, mask = scans
    want = jax.jit(lambda s, m: jodo.ndt_odometry(s, m, CFG))(
        jnp.asarray(xyzi, dtype), jnp.asarray(mask))
    got = todo.ndt_odometry(torch.from_numpy(xyzi.astype(dtype)),
                            torch.from_numpy(mask),
                            convert.odometry_config(CFG._asdict()))
    assert got.converged.all() and np.asarray(want.converged).all()
    np.testing.assert_allclose(got.poses.numpy()[:, :3, 3],
                               np.asarray(want.poses)[:, :3, 3], atol=tol)
    np.testing.assert_allclose(got.poses.numpy()[:, :3, :3],
                               np.asarray(want.poses)[:, :3, :3], atol=tol)
    if dtype == np.float64:
        for f in ("iterations", "evaluations", "gathers"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.host_syncs.numpy(),
                                  got.evaluations.numpy())


def test_online_steps_match_batch_and_rerun_is_bit_identical(scans):
    xyzi, mask = (torch.from_numpy(a) for a in scans)
    cfg = convert.odometry_config(CFG._asdict())
    batch = todo.ndt_odometry(xyzi, mask, cfg)
    state = todo.odometry_init(xyzi[0], mask[0], cfg)
    for i in range(1, xyzi.shape[0]):
        state, res = todo.odometry_step(state, xyzi[i], mask[i], cfg)
        assert torch.equal(state.pose, batch.poses[i])
        assert res.iterations == int(batch.iterations[i])
    again = todo.ndt_odometry(xyzi, mask, cfg)
    assert torch.equal(again.poses, batch.poses)


def test_port_imports_without_jax():
    """Every module of the port imports, and an NDT, an ICP and a GICP align
    run, with JAX made unimportable."""
    code = """
import sys
sys.modules["jax"] = None
import importlib, pkgutil
import toyslam_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import numpy as np, torch
from toyslam_tpu_torch.core import pointcloud
from toyslam_tpu_torch.registration import ndt
pts = np.random.default_rng(0).uniform(-5, 5, (2000, 3))
pts[:, 2] *= 0.1
cloud = pointcloud.from_numpy(pts, device="cpu")
r = ndt.ndt_align(ndt.build_ndt_map(cloud, ndt.NDTConfig(resolution=2.0)),
                  cloud)
assert r.converged
from toyslam_tpu_torch.registration import gicp, icp
small = pointcloud.from_numpy(pts[:500], capacity=512, device="cpu")
assert icp.icp_align(small, small).converged
assert gicp.gicp_align(small, small).converged
assert not any(k == "jax" or k.startswith(("jax.", "toyslam_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
