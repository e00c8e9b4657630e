"""NDT map build and derivatives of the PyTorch port against the JAX
package (the aligns are in ``test_torch_align.py``).

Both packages get the same numpy inputs: generated LiDAR scans
(``toyslam_tpu_torch/sim/urban_scans.py``), downsampled by the JAX package
so that map and align parity are tested apart from the downsample. A map
built by JAX reaches the port through ``toyslam_tpu_torch/convert.py``, so
align parity is also tested apart from map-build parity.

Bounds, about twice the deviation observed on these inputs:
- map build: ids, validity and id channels exact; f64 means 1e-12 m and
  icov rtol 1e-10; f32 means 2e-6 m and icov 2e-5 of the row's largest
  entry (the port sums a voxel sequentially, JAX by a lane tree);
- derivatives: f64 rtol 1e-10; f32 as the kernel tests (score rtol 1e-5,
  grad rtol 1e-4 / atol 1e-5, Hessian rtol 1e-4 / atol 1e-4);
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


@pytest.fixture(scope="module")
def scans():
    """Two consecutive 16 x 512-ray scans, 0.3 m downsampled by JAX (f64
    arrays; each test casts)."""
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


@pytest.mark.parametrize("dtype,mean_tol,icov_tol",
                         [(np.float64, 1e-12, 1e-10),
                          (np.float32, 2e-6, 2e-5)])
def test_build_ndt_map_matches_jax(scans, dtype, mean_tol, icov_tol):
    jc, tc = _clouds(scans[0], dtype)
    mj = build_j(jc, CFG)
    mt = tndt.build_ndt_map(tc, convert.ndt_config(CFG._asdict()))
    v = np.asarray(mj.valid)
    assert 100 < v.sum()
    np.testing.assert_array_equal(mt.unique_ids.numpy(),
                                  np.asarray(mj.unique_ids))
    np.testing.assert_array_equal(mt.valid.numpy(), v)
    np.testing.assert_array_equal(mt.vid_of_slot.numpy(),
                                  np.asarray(mj.vid_of_slot))
    for a in ("min_b", "div", "div_mul"):
        np.testing.assert_array_equal(getattr(mt, a).numpy(),
                                      np.asarray(getattr(mj, a)))
    np.testing.assert_allclose(mt.mean3.numpy()[:, v],
                               np.asarray(mj.mean3)[:, v], atol=mean_tol)
    icov_j = np.asarray(mj.icov6)[:, v]
    scale = np.abs(icov_j).max(0)
    assert (np.abs(mt.icov6.numpy()[:, v] - icov_j) <= icov_tol * scale).all()
    # Hash table: same occupied slots, identical flag and id channels.
    ht_t, ht_j = mt.hash_table.numpy(), np.asarray(mj.hash_table)
    np.testing.assert_array_equal(ht_t[:, 9:], ht_j[:, 9:])
    np.testing.assert_allclose(ht_t[:, :3], ht_j[:, :3], atol=mean_tol)


def test_hash_alias_stress_matches_jax(rng):
    """The aliasing case of ``tests/test_ndt.py:538``: grid ids far beyond
    the 2^14 hash slots. Both packages keep the same voxels, the gate
    accepts exactly the non-collided ones, every accepted row is an exact
    map row, and the port's gather of the JAX map is bit-identical to
    JAX's."""
    n_c = 2500
    centers = rng.uniform(-200, 200, (n_c, 3)).astype(np.float32)
    centers[:, 2] = np.abs(centers[:, 2]) * 0.05
    pts = (centers[:, None, :]
           + rng.normal(0, 0.12, (n_c, 10, 3))).reshape(-1, 3)
    xyzi = np.concatenate([pts, np.zeros((len(pts), 1))], 1).astype(np.float32)
    cfg = jndt.NDTConfig(resolution=1.0, map_capacity=4096,
                         grid_capacity=1 << 14)
    mj = build_j(jpc.from_numpy(xyzi, capacity=len(pts)), cfg)
    mt = tndt.build_ndt_map(tpc.from_numpy(xyzi, device="cpu"),
                            convert.ndt_config(cfg._asdict()))
    valid = mt.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(mj.valid))
    ids = mt.unique_ids.numpy()[valid]
    slots = ids & (cfg.grid_capacity - 1)
    uniq, counts = np.unique(slots, return_counts=True)
    collided = np.isin(slots, uniq[counts > 1])
    assert collided.any()

    table = mt.table.numpy()[valid]
    means = torch.from_numpy(np.ascontiguousarray(table[:, :3]))
    ones = torch.ones(len(means), dtype=torch.bool)
    stats = tndt.gather_neighborhood(mt, means, ones, np.zeros(6, np.float32),
                                     1.0, tndt._OFFSETS["DIRECT1"])
    gate = stats.valid.numpy()
    packed = stats.packed.numpy()
    np.testing.assert_array_equal(gate, ~collided)
    np.testing.assert_array_equal(packed[0:3, gate].T, table[gate, :3])
    np.testing.assert_array_equal(packed[3:9, gate].T, table[gate, 3:9])

    ref = jax.jit(lambda m, x, mk, p: jndt.gather_neighborhood(
        m, x, mk, p, 1.0, jndt._OFFSETS["DIRECT1"], use_pallas=False))(
        mj, jnp.asarray(table[:, :3]), jnp.ones(len(table), bool),
        jnp.zeros(6, jnp.float32))
    got = tndt.gather_neighborhood(_port_map(mj), means, ones,
                                   np.zeros(6, np.float32), 1.0,
                                   tndt._OFFSETS["DIRECT1"])
    assert np.array_equal(got.packed.numpy(), np.asarray(ref.packed))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compute_derivatives_matches_jax(scans, dtype):
    """All three forms: fresh gather (K1's path), given stats (K2 + K3's
    path), and both against the JAX jnp derivatives."""
    jc0, _ = _clouds(scans[0], dtype)
    jc1, tc1 = _clouds(scans[1], dtype)
    mj = build_j(jc0, CFG)
    mt = _port_map(mj)
    p = np.array([0.12, -0.05, 0.03, 0.004, -0.006, 0.01], dtype)
    d1, d2, _ = tndt.gauss_coefficients(1.0, 0.55)
    offs = jndt._OFFSETS["DIRECT7"]

    @jax.jit
    def ref(m, x, mk, pp):
        return jndt.compute_derivatives(m, x, mk, pp, dtype(d1), dtype(d2),
                                        1.0, offs, use_pallas=False)

    want = [np.asarray(a) for a in ref(mj, jc1.xyzi[:, :3], jc1.mask,
                                       jnp.asarray(p))]
    xyz = tc1.xyzi[:, :3]
    exact = tndt.compute_derivatives(mt, xyz, tc1.mask, p, d1, d2, 1.0, offs)
    stats = tndt.gather_neighborhood(mt, xyz, tc1.mask, p, 1.0, offs)
    frozen = tndt.compute_derivatives(mt, xyz, tc1.mask, p, d1, d2, 1.0, offs,
                                      stats=stats)
    for got in (exact, frozen):
        got = [g.numpy() for g in got]
        if dtype == np.float64:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)
        else:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
            np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    assert want[0] > 100  # the scans overlap: a real objective
