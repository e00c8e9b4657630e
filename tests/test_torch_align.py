"""NDT align of the PyTorch port against the JAX package and the f64 oracle
``tests/golden_ndt.py``.

One map built by JAX reaches the port through
``toyslam_tpu_torch/convert.py``, so align parity is tested apart from
map-build parity (``test_torch_ndt.py``). Inputs: two generated LiDAR
scans, 0.3 m downsampled by JAX. Bounds, about twice the deviation
observed: f64 pose6 within 1e-9 with equal iterations, evaluations and
gathers (the counters are the work-parity check of
``tests/test_ndt.py:196-212``); f32 within 1e-4 m and 1e-5 rad; against
the f64 oracle, the bounds of ``tests/test_ndt.py:193-212``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.registration import ndt as jndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.registration import ndt as tndt  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402

CFG = jndt.NDTConfig(resolution=1.0, map_capacity=2048,
                     grid_capacity=1 << 14, transformation_epsilon=1e-3)
build_j = jax.jit(jndt.build_ndt_map, static_argnums=1)
align_j = jax.jit(jndt.ndt_align, static_argnums=3)


@pytest.fixture(scope="module")
def scans():
    """Two consecutive 16 x 512-ray scans, 0.3 m downsampled by JAX."""
    xyzi, mask, _ = spinning_lidar_scans(11, 2, 16, 512)
    ds = jax.jit(jpc.voxel_downsample, static_argnums=(1, 2))
    out = []
    for k in range(2):
        c = ds(jpc.PointCloud(jnp.asarray(xyzi[k], jnp.float64),
                              jnp.asarray(mask[k])), 0.3, 4096)
        out.append((np.asarray(c.xyzi), np.asarray(c.mask)))
    return out


def _clouds(cloud, dtype):
    xyzi, mask = cloud
    return (jpc.PointCloud(jnp.asarray(xyzi, dtype), jnp.asarray(mask)),
            convert.point_cloud(xyzi.astype(dtype), mask, device="cpu"))


def _port_map(jmap):
    return convert.ndt_map({k: np.asarray(v) for k, v in jmap._asdict().items()},
                           device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["exact", "turbo"])
def test_ndt_align_on_one_map_matches_jax(scans, dtype, mode):
    cfg = CFG if mode == "exact" else CFG._replace(frozen_linesearch=True,
                                                   regather_iterations=2)
    jc0, _ = _clouds(scans[0], dtype)
    jc1, tc1 = _clouds(scans[1], dtype)
    mj = build_j(jc0, cfg)
    rj = align_j(mj, jc1, jnp.eye(4, dtype=dtype), cfg)
    rt = tndt.ndt_align(_port_map(mj), tc1, np.eye(4, dtype=dtype),
                        convert.ndt_config(cfg._asdict()))
    assert bool(rj.converged) and rt.converged
    pj, pt = np.asarray(rj.pose6), rt.pose6.numpy()
    if dtype == np.float64:
        np.testing.assert_allclose(pt, pj, atol=1e-9)
        assert rt.iterations == int(rj.iterations)
        assert rt.evaluations == int(rj.evaluations)
        assert rt.gathers == int(rj.gathers)
        np.testing.assert_allclose(float(rt.trans_probability),
                                   float(rj.trans_probability), rtol=1e-9)
    else:
        np.testing.assert_allclose(pt[:3], pj[:3], atol=1e-4)
        np.testing.assert_allclose(pt[3:], pj[3:], atol=1e-5)
    assert rt.host_syncs == rt.evaluations  # one copy per evaluation
    if mode == "turbo":
        assert rt.gathers < rt.evaluations


def test_f64_align_matches_golden_oracle():
    """The port's f64 exact align against the independent NumPy oracle on a
    cropped scan pair (the oracle has no hash table, so the crop keeps every
    voxel id inside the grid capacity): pose within 1e-3 m / 1e-4 rad,
    Newton iterations equal (ours counts the final pass) and evaluations
    within one (ours counts the init evaluation)."""
    import golden_ndt

    xyzi, mask, _ = spinning_lidar_scans(5, 2, 32, 1024)
    clouds = []
    for k in range(2):
        pts = xyzi[k, mask[k], :3].astype(np.float64)
        pts = pts[(np.abs(pts[:, 0]) < 20) & (np.abs(pts[:, 1]) < 20)]
        ds = tpc.voxel_downsample(tpc.from_numpy(pts, dtype=torch.float64,
                                                 device="cpu"),
                                  0.2)
        clouds.append(ds)
    cfg = tndt.NDTConfig(resolution=1.0, grid_capacity=1 << 17,
                         map_capacity=16384)
    m = tndt.build_ndt_map(clouds[0], cfg)
    r = tndt.ndt_align(m, clouds[1], np.eye(4), cfg)
    assert r.converged

    t_pts, s_pts = (c.xyzi.numpy()[c.mask.numpy(), :3] for c in clouds)
    leaves, min_b, max_b, div = golden_ndt.build_map(t_pts, 1.0)
    assert len(leaves) == int(m.valid.sum())  # no voxel lost to aliasing
    _, p_gold, it_gold, nev_gold = golden_ndt.align(
        leaves, min_b, max_b, div, s_pts)
    p = r.pose6.numpy()
    assert np.abs(p[:3] - p_gold[:3]).max() < 1e-3, (p, p_gold)
    assert np.abs(p[3:] - p_gold[3:]).max() < 1e-4, (p, p_gold)
    assert r.iterations == it_gold + 1, (r.iterations, it_gold)
    assert abs(r.evaluations - (nev_gold + 1)) <= 1, (r.evaluations, nev_gold)
