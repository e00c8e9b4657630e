"""The port's lane axis (the fleet) against its single-lane path and the
JAX package, on the CPU.

- K1/K3's lane plain versions (``ndt_kernels.*_lanes_plain``, which the
  lane wrappers take for CPU tensors): each lane bit-identical to the
  single-lane plain version at DIRECT1/7/27, for a subset of lanes in
  shuffled order, and without lane ids equal to naming every lane; the
  lanes' plain neighbour hash bit-identical to the single-lane hash, its
  slots offset by each lane's first row in the stacked table;
- ``voxel_downsample_lanes`` and ``build_ndt_map_lanes``: each lane
  bit-identical to the single-lane function on it, with ragged masks, a
  lane with every point masked and lanes in different grids;
- ``ndt_align_lanes`` on ``tests/test_ndt.py:625``'s three lanes of
  different convergence speed, in f64, exact and frozen + 4 regathers:
  each lane at B = 3 bit-identical to its source aligned alone at B = 1
  (``ndt_align``, counters included: other lanes, their regathers and
  finished lanes dropping out leave a lane's bits alone), one host sync a
  round; against JAX's ``jax.vmap(ndt.ndt_align)``:
  iterations, evaluations and gathers equal, poses within 6e-15 (observed
  2.9e-15; JAX's vmap reorders its reductions);
- the ESKF over lanes: each lane within 5e-16 of ``eskf_run`` alone in
  f64 (observed 1.7e-16: a batched matrix product on the CPU rounds
  otherwise than a 2-D one) and within 5e-16 of ``jax.vmap(eskf_run)``
  (observed 2.2e-16);
- ``ndt_align`` at DIRECT1 and DIRECT27 (ROADMAP item 2), exact and
  frozen + 4 regathers, against JAX in f64: counts equal, poses within
  1e-13 (observed up to 4.6e-14).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.estimators import eskf as jeskf  # noqa: E402
from toyslam_tpu.registration import ndt as jndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.estimators import eskf as teskf  # noqa: E402
from toyslam_tpu_torch.ops import ndt_kernels  # noqa: E402
from toyslam_tpu_torch.registration import ndt as tndt  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402

ALIGN_VS_JAX_TOL = 6e-15
PARITY_TOL = 1e-13
ESKF_TOL = 5e-16


def _same(a, b):
    return torch.equal(a, b) and a.dtype == b.dtype


# ------------------------------------------------------------ lane clouds


@pytest.fixture(scope="module")
def lane_scans():
    """Three lanes of two 16 x 512-ray scans from different seeds (different
    scenes, so different grids), f32, with a ragged mask on lane 1 and
    every point of lane 2's second scan masked."""
    xs, ms = [], []
    for seed in (3, 5, 8):
        x, m, _ = spinning_lidar_scans(seed, 2, 16, 512)
        xs.append(x)
        ms.append(m)
    xyzi = torch.from_numpy(np.stack(xs)).float()
    mask = torch.from_numpy(np.stack(ms))
    mask[1, :, ::7] = False
    mask[1, 1, 3000:] = False
    mask[2, 1] = False
    return xyzi, mask


def test_voxel_downsample_lanes_equal_single(lane_scans):
    xyzi, mask = lane_scans
    for s in range(2):
        for intensity in (False, True):
            got = tpc.voxel_downsample_lanes(xyzi[:, s], mask[:, s], 0.3,
                                             4096, with_intensity=intensity)
            for b in range(3):
                want = tpc.voxel_downsample(
                    tpc.PointCloud(xyzi[b, s], mask[b, s]), 0.3, 4096,
                    with_intensity=intensity)
                assert _same(got.xyzi[b], want.xyzi)
                assert _same(got.mask[b], want.mask)
    assert int(got.mask[2].sum()) == 0 and int(got.mask[0].sum()) > 1000


def test_build_ndt_map_lanes_equal_single(lane_scans):
    xyzi, mask = lane_scans
    cfg = tndt.NDTConfig(map_capacity=2048, grid_capacity=1 << 14)
    for s in range(2):
        ds = tpc.voxel_downsample_lanes(xyzi[:, s], mask[:, s], 0.3, 4096)
        got = tndt.build_ndt_map_lanes(ds, cfg)
        assert got.hash_table.shape == (3, 1 << 14, 16)
        for b in range(3):
            want = tndt.build_ndt_map(tpc.PointCloud(ds.xyzi[b], ds.mask[b]),
                                      cfg)
            for name, g, w in zip(want._fields, got, want):
                assert _same(g[b], w), (s, b, name)
    assert not torch.equal(got.min_b[0], got.min_b[1])


@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_k1_k3_lane_plain_versions_equal_single(lane_scans, search):
    xyzi, mask = lane_scans
    cfg = tndt.NDTConfig(map_capacity=2048, grid_capacity=1 << 14)
    tgt = tpc.voxel_downsample_lanes(xyzi[:, 0], mask[:, 0], 0.3, 4096)
    src = tpc.voxel_downsample_lanes(xyzi[:, 1], mask[:, 1], 0.3, 4096)
    m = tndt.build_ndt_map_lanes(tgt, cfg)
    d1, d2, _ = tndt.gauss_coefficients(1.0, 0.55)
    k = tndt._OFFSETS[search]
    ev = tndt._LaneEvaluator(m, src.xyzi, src.mask, 1.0, k, d1, d2)
    lane_ids = torch.tensor([2, 0], dtype=torch.int32)
    params = ev.params([
        np.array([0.3, -0.1, 0.0, 0.0, 0.0, 0.004], np.float32),
        np.array([-0.2, 0.1, 0.05, 0.01, 0.0, -0.02], np.float32)])
    xyz, off = ev.xyz, ev.offsets
    idx = lane_ids.long()
    # Each lane's h offset by its first row in the stacked table.
    hashed = ndt_kernels.ndt_neighbor_hash_lanes_plain(
        params, xyz[idx], src.mask[idx], m.min_b[idx], m.div[idx], 1 << 14,
        1.0, off, ev.row0[idx])
    stats = torch.zeros((3, 10, len(k) * xyz.shape[2]))
    for y, b in enumerate(lane_ids.tolist()):
        single = ndt_kernels.ndt_neighbor_hash_plain(
            params[y], xyz[b], src.mask[b], m.min_b[b], m.div[b], 1 << 14,
            1.0, off)
        assert _same(hashed[0][y], single[0] + b * (1 << 14))
        for g, w in zip(hashed[1:], single[1:]):
            assert _same(g[y], w)
        stats[b] = ndt_kernels.ndt_gather_repack_plain(m.hash_table[b],
                                                       *single)
    k3 = ndt_kernels.ndt_terms_packed_lanes(params, xyz, stats, lane_ids)
    k1 = ndt_kernels.ndt_terms_gathered_lanes(
        params, xyz, src.mask, m.hash_table, m.min_b, m.div, 1.0, off,
        lane_ids)
    assert k1.shape == k3.shape == (2, 28)
    for y, b in enumerate(lane_ids.tolist()):
        assert _same(k3[y], ndt_kernels.ndt_terms_packed_plain(
            params[y], xyz[b], stats[b]))
        assert _same(k1[y], ndt_kernels.ndt_terms_gathered_plain(
            params[y], xyz[b], src.mask[b], m.hash_table[b], m.min_b[b],
            m.div[b], 1.0, off))
    # Lane 2's source is masked whole: its sums are exactly zero.
    assert not bool(k1[0].any()) and not bool(k3[0].any())
    assert float(k1[1, 0].abs()) > 0 and float(k3[1, 0].abs()) > 0
    # No lane ids: every lane in order, as ids 0, 1, 2 name them.
    every = torch.arange(3, dtype=torch.int32)
    p3 = torch.cat([params, params[:1]])
    assert _same(
        ndt_kernels.ndt_terms_packed_lanes(p3, xyz, stats, None),
        ndt_kernels.ndt_terms_packed_lanes(p3, xyz, stats, every))
    assert _same(
        ndt_kernels.ndt_terms_gathered_lanes(
            p3, xyz, src.mask, m.hash_table, m.min_b, m.div, 1.0, off, None),
        ndt_kernels.ndt_terms_gathered_lanes(
            p3, xyz, src.mask, m.hash_table, m.min_b, m.div, 1.0, off,
            every))


# ---------------------------------------------------------- lockstep align


def _make_cloud_pair(rng, n):
    """``tests/test_ndt.py``'s floor + two walls scene, f64."""
    floor = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                      0.05 * rng.normal(size=n)], 1)
    wall1 = np.stack([rng.uniform(-20, 20, n // 2),
                      np.full(n // 2, 8.0) + 0.05 * rng.normal(size=n // 2),
                      rng.uniform(0, 5, n // 2)], 1)
    wall2 = np.stack([np.full(n // 2, -12.0)
                      + 0.05 * rng.normal(size=n // 2),
                      rng.uniform(-20, 20, n // 2), rng.uniform(0, 5, n // 2)],
                     1)
    return np.concatenate([floor, wall1, wall2], 0)


@pytest.fixture(scope="module")
def three_lanes():
    """``tests/test_ndt.py:625``'s lanes: near-identity (fast), moderate and
    a large offset (slow) sources of one 2000-point scene, f64."""
    pts = _make_cloud_pair(np.random.default_rng(42), 2000)
    lane_p = np.array([[0.01, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [0.3, -0.2, 0.1, 0.02, -0.015, 0.04],
                       [1.2, 0.8, -0.3, 0.05, 0.04, -0.08]])
    sources = []
    for p6 in lane_p:
        T = np.asarray(jse3.pose6_to_matrix(jnp.asarray(p6, jnp.float64)))
        sources.append(np.concatenate(
            [(pts - T[:3, 3]) @ T[:3, :3], np.zeros((len(pts), 1))], 1))
    return pts, np.stack(sources)


LANE_CFG = jndt.NDTConfig(resolution=2.0, transformation_epsilon=1e-3,
                          max_iterations=50)


@pytest.mark.parametrize("mode", ["exact", "frozen4"])
def test_ndt_align_lanes_equal_single_and_jax_vmap(three_lanes, mode):
    pts, sources = three_lanes
    jcfg = LANE_CFG if mode == "exact" else LANE_CFG._replace(
        frozen_linesearch=True, regather_iterations=4)
    cfg = convert.ndt_config(jcfg._asdict())
    B = len(sources)
    target = tpc.from_numpy(pts, dtype=torch.float64, device="cpu")
    lanes = tpc.PointCloud(torch.from_numpy(sources),
                           torch.ones(sources.shape[:2], dtype=torch.bool))
    m = tndt.build_ndt_map_lanes(
        tpc.PointCloud(target.xyzi[None].expand(B, -1, -1).contiguous(),
                       target.mask[None].expand(B, -1).contiguous()), cfg)
    got = tndt.ndt_align_lanes(m, lanes, None, cfg)
    singles = [tndt.ndt_align(tndt.build_ndt_map(target, cfg),
                              tpc.PointCloud(lanes.xyzi[b], lanes.mask[b]),
                              None, cfg) for b in range(B)]
    for b, r in enumerate(singles):
        assert _same(got.pose6[b], r.pose6) and _same(got.transform[b],
                                                      r.transform)
        assert _same(got.trans_probability[b], r.trans_probability)
        assert bool(got.converged[b]) == r.converged
        assert (int(got.iterations[b]), int(got.evaluations[b]),
                int(got.gathers[b])) == (r.iterations, r.evaluations,
                                         r.gathers)
    its = got.iterations.tolist()
    assert len(set(its)) >= 2, its  # the lockstep masking is exercised
    # One host sync a round, a round an evaluation of every running lane.
    assert got.host_syncs.tolist() == [int(got.evaluations.max())] * B

    jm = jax.jit(jndt.build_ndt_map, static_argnums=1)(
        jpc.from_numpy(pts, dtype=jnp.float64), jcfg)
    want = jax.jit(jax.vmap(lambda x, mk: jndt.ndt_align(
        jm, jpc.PointCloud(x, mk), jnp.eye(4, dtype=jnp.float64), jcfg)))(
        jnp.asarray(sources), jnp.ones(sources.shape[:2], bool))
    for name in ("iterations", "evaluations", "gathers"):
        assert getattr(got, name).tolist() == np.asarray(
            getattr(want, name)).tolist(), name
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(want.pose6),
                               rtol=0, atol=ALIGN_VS_JAX_TOL)


@pytest.mark.parametrize("mode", ["exact", "frozen4"])
@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT27"])
def test_direct1_direct27_align_matches_jax_f64(three_lanes, search, mode):
    """ROADMAP item 2: DIRECT1 and DIRECT27 aligns against JAX's in f64."""
    pts, sources = three_lanes
    jcfg = LANE_CFG._replace(search_method=search)
    if mode == "frozen4":
        jcfg = jcfg._replace(frozen_linesearch=True, regather_iterations=4)
    jm = jax.jit(jndt.build_ndt_map, static_argnums=1)(
        jpc.from_numpy(pts, dtype=jnp.float64), jcfg)
    want = jax.jit(jndt.ndt_align, static_argnums=3)(
        jm, jpc.PointCloud(jnp.asarray(sources[1]),
                           jnp.ones(len(pts), bool)),
        jnp.eye(4, dtype=jnp.float64), jcfg)
    cfg = convert.ndt_config(jcfg._asdict())
    got = tndt.ndt_align(
        tndt.build_ndt_map(tpc.from_numpy(pts, dtype=torch.float64,
                                          device="cpu"), cfg),
        tpc.PointCloud(torch.from_numpy(sources[1]),
                       torch.ones(len(pts), dtype=torch.bool)),
        None, cfg)
    assert bool(want.converged) and got.converged
    assert (got.iterations, got.evaluations, got.gathers) == (
        int(want.iterations), int(want.evaluations), int(want.gathers))
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(want.pose6),
                               rtol=0, atol=PARITY_TOL)


# -------------------------------------------------------------- the ESKF


def test_eskf_lanes_match_single_and_jax_vmap():
    rng = np.random.default_rng(7)
    B, T = 4, 80
    acc = np.tile([0.0, 0.12, 9.81], (B, T, 1)) + 0.03 * rng.normal(
        size=(B, T, 3))
    gyro = np.tile([0.0, 0.0, 0.04], (B, T, 1)) + 0.002 * rng.normal(
        size=(B, T, 3))
    dt = np.full((B, T), 0.005)
    dt[1, 11] = 0.0  # a dropped tick on one lane only
    meas = np.cumsum(0.0015 * np.ones((B, T, 3)), 1) + 0.01 * rng.normal(
        size=(B, T, 3))
    valid = np.zeros((B, T), bool)
    valid[:, 19::20] = True
    valid[2, 39] = False
    arrays = (dt, acc, gyro, meas, valid)
    params = teskf.ESKFParams(acc_noise=0.03, gyro_noise=0.002,
                              meas_noise=0.01)
    _, got = teskf.eskf_run(teskf.ESKFLog(*map(torch.from_numpy, arrays)),
                            None, params)
    assert got["p"].shape == (B, T, 3) and got["q"].shape == (B, T, 4)
    _, want = jax.jit(jax.vmap(lambda *a: jeskf.eskf_run(
        jeskf.ESKFLog(*a), None, jeskf.ESKFParams(**params._asdict()))))(
        *map(jnp.asarray, arrays))
    for b in range(B):
        _, one = teskf.eskf_run(teskf.ESKFLog(*(torch.from_numpy(a[b])
                                                for a in arrays)),
                                None, params)
        for k in ("p", "v", "q"):
            np.testing.assert_allclose(got[k][b].numpy(), one[k].numpy(),
                                       rtol=0, atol=ESKF_TOL)
    for k in ("p", "v", "q"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ESKF_TOL)
    # The lanes differ (the masked tick and the missing fix): no lane copies
    # another.
    assert not torch.equal(got["p"][1], got["p"][0])
