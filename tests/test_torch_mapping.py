"""The mapping slice of the PyTorch port against the JAX package on the CPU:
``ndt_mapping``, ``mapping_step`` with checkpoints, and the map merge at
overflow (coarse-to-fine odometry: ``tests/test_torch_odometry.py``).

Four generated 16 x 512-ray scans, the shipped ``OdometryConfig`` with the
working capacity cut to 4096, a 4096-voxel map (3349 voxels used).
Bounds: f64 poses and map points within 1e-8 m of JAX's (observed 1.1e-14
and 1.1e-13), equal per-scan iterations, evaluations and gathers; f32
poses within 2e-6 m and map points within 2e-5 m (observed 8.0e-7 and
8.6e-6: f32 sums and host Newton steps round differently, and a map point
moves with its scan's pose); equal map masks in both. A JAX checkpoint
resumes in the port within the f64 bounds; the port's own resumes and
chained steps are bit-identical to its uninterrupted batch run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.pipelines import odometry as jodo  # noqa: E402
from toyslam_tpu.utils import checkpoint as jckpt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.pipelines import odometry as todo  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402
from toyslam_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

CFG = jodo.OdometryConfig(work_capacity=4096)
MAP_CAP = 4096
OVERFLOW_CAP = 1024  # below the ~2200 voxels of two merged scans
TOL = {np.float64: (1e-8, 1e-8), np.float32: (2e-6, 2e-5)}


@pytest.fixture(scope="module")
def scans():
    xyzi, mask, _ = spinning_lidar_scans(2, 4, 16, 512)
    return xyzi, mask


def _port(scans, dtype):
    xyzi, mask = scans
    return torch.from_numpy(xyzi.astype(dtype)), torch.from_numpy(mask)


def _cfg(**kw):
    return convert.odometry_config(CFG._replace(**kw)._asdict())


_JAX_MAPPING = {}


def _jax_mapping(scans, dtype):
    """JAX's ndt_mapping of the scans, one jit a dtype for the module."""
    if dtype not in _JAX_MAPPING:
        xyzi, mask = scans
        _JAX_MAPPING[dtype] = jax.jit(
            lambda s, m: jodo.ndt_mapping(s, m, MAP_CAP, CFG))(
            jnp.asarray(xyzi, dtype), jnp.asarray(mask))
    return _JAX_MAPPING[dtype]


def _assert_poses(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, :3, :], want[:, :3, :], atol=tol)


def _assert_counts(got, want):
    for f in ("iterations", "evaluations", "gathers"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ndt_mapping_matches_jax(scans, dtype):
    want = _jax_mapping(scans, dtype)
    got = todo.ndt_mapping(*_port(scans, dtype), MAP_CAP, _cfg())
    tol_pose, tol_map = TOL[dtype]
    assert got.odometry.converged.all()
    assert np.asarray(want.odometry.converged).all()
    _assert_poses(got.odometry.poses, want.odometry.poses, tol_pose)
    mask = got.map_mask.numpy()
    assert 0 < mask.sum() < MAP_CAP  # the map is not full
    if dtype == np.float64:
        _assert_counts(got.odometry, want.odometry)
    np.testing.assert_array_equal(mask, np.asarray(want.map_mask))
    np.testing.assert_allclose(got.map_xyzi.numpy()[mask],
                               np.asarray(want.map_xyzi)[mask], atol=tol_map)


def test_mapping_steps_match_batch_bit_for_bit(scans):
    xyzi, mask = _port(scans, np.float32)
    cfg = _cfg()
    batch = todo.ndt_mapping(xyzi, mask, MAP_CAP, cfg)
    state = todo.mapping_init(xyzi[0], mask[0], MAP_CAP, cfg)
    for i in range(1, xyzi.shape[0]):
        state, out = todo.mapping_step(state, xyzi[i], mask[i], cfg)
        assert torch.equal(out[0], batch.odometry.poses[i])
        assert out[3] == int(batch.odometry.iterations[i])
    assert torch.equal(state.map_cloud.xyzi, batch.map_xyzi)
    assert torch.equal(state.map_cloud.mask, batch.map_mask)
    # Mapping keeps intensity; the poses are odometry's all the same.
    odo = todo.ndt_odometry(xyzi, mask, cfg)
    assert torch.equal(odo.poses, batch.odometry.poses)


def test_overflowing_map_masks_match_jax(scans):
    """Two merges into a map of OVERFLOW_CAP voxels: the voxels past the
    capacity drop in ascending voxel-id order in both packages."""
    xyzi, mask = scans
    poses = np.asarray(_jax_mapping(scans, np.float64).odometry.poses)
    mcfg = CFG._replace(keep_intensity=True)
    merge = jax.jit(jodo._merge_into_map, static_argnums=3)
    ds = jax.jit(jpc.voxel_downsample, static_argnums=(1, 2))
    jds = [ds(jpc.PointCloud(jnp.asarray(xyzi[k], np.float64),
                             jnp.asarray(mask[k])),
              CFG.scan_leaf, CFG.work_capacity) for k in range(3)]
    jmap = jpc.pad_to(ds(jds[0], CFG.map_leaf, None), OVERFLOW_CAP)
    txyzi, tmask = _port(scans, np.float64)
    tcfg = _cfg(keep_intensity=True)
    tds = [todo._downsample(txyzi[k], tmask[k], tcfg) for k in range(3)]
    tmap = tpc.pad_to(tpc.voxel_downsample(tds[0], CFG.map_leaf),
                      OVERFLOW_CAP)
    for k in (1, 2):
        pose = torch.tensor(poses[k])
        unbounded = todo._merge_into_map(
            tpc.pad_to(tmap, 4 * OVERFLOW_CAP), tds[k], pose, tcfg)
        assert int(unbounded.mask.sum()) > OVERFLOW_CAP
        jmap = merge(jmap, jds[k], jnp.asarray(poses[k]), mcfg)
        tmap = todo._merge_into_map(tmap, tds[k], pose, tcfg)
        assert bool(tmap.mask.all())
        np.testing.assert_array_equal(tmap.mask.numpy(),
                                      np.asarray(jmap.mask))
        np.testing.assert_allclose(tmap.xyzi.numpy(), np.asarray(jmap.xyzi),
                                   atol=1e-8)


def test_merge_keeps_pad_rows(scans):
    xyzi, mask = _port(scans, np.float32)
    cfg = _cfg(keep_intensity=True)
    ds = todo._downsample(xyzi[1], mask[1], cfg)
    empty = tpc.pad_to(tpc.PointCloud(ds.xyzi[:0], ds.mask[:0]), 8192)
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([5.0, -3.0, 1.0])
    merged = todo._merge_into_map(empty, ds, pose, cfg)
    n = int(merged.mask.sum())
    assert n > 0
    assert bool((merged.xyzi[n:, :3] == tpc.PAD_COORD).all())
    assert bool((merged.xyzi[n:, 3] == 0).all())


def test_jax_checkpoint_resumes_in_port(scans, tmp_path):
    """JAX maps scans 1-2 and writes a checkpoint; the port loads it (and,
    through ``convert.mapping_state``, JAX's state itself) and maps the
    rest within 1e-8 of JAX finishing the run; JAX loads the port's
    checkpoint of the end state."""
    xyzi, mask = scans
    jx, jm = jnp.asarray(xyzi, np.float64), jnp.asarray(mask)
    step = jax.jit(jodo.mapping_step, static_argnums=3)
    jstate = jax.jit(jodo.mapping_init, static_argnums=(2, 3))(
        jx[0], jm[0], MAP_CAP, CFG)
    for i in (1, 2):
        jstate, _ = step(jstate, jx[i], jm[i], CFG)
    path = tmp_path / "jax_state.npz"
    jckpt.save_checkpoint(path, jstate)
    jend, jout = step(jstate, jx[3], jm[3], CFG)

    txyzi, tmask = _port(scans, np.float64)
    cfg = _cfg()
    template = todo.mapping_init(txyzi[0], tmask[0], MAP_CAP, cfg)
    loaded = tckpt.load_checkpoint(path, template)
    direct = convert.mapping_state(jstate, device="cpu")
    ends = []
    for state in (loaded, direct):
        assert state.map_cloud.mask.dtype == torch.bool
        assert state.odometry.pose.device.type == "cpu"
        end, out = todo.mapping_step(state, txyzi[3], tmask[3], cfg)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                                   atol=1e-8)
        assert out[3] == int(jout[3])
        np.testing.assert_array_equal(end.map_cloud.mask.numpy(),
                                      np.asarray(jend.map_cloud.mask))
        np.testing.assert_allclose(end.map_cloud.xyzi.numpy(),
                                   np.asarray(jend.map_cloud.xyzi),
                                   atol=1e-8)
        ends.append(end)
    assert torch.equal(ends[0].map_cloud.xyzi, ends[1].map_cloud.xyzi)

    back = tmp_path / "port_state.npz"
    tckpt.save_checkpoint(back, ends[0])
    restored = jckpt.load_checkpoint(back, jend)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(jend)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-8)


def test_port_resume_is_bit_identical(scans, tmp_path):
    xyzi, mask = _port(scans, np.float32)
    cfg = _cfg()
    full = todo.ndt_mapping(xyzi, mask, MAP_CAP, cfg)
    state = todo.mapping_init(xyzi[0], mask[0], MAP_CAP, cfg)
    state, _ = todo.mapping_step(state, xyzi[1], mask[1], cfg)
    path = tmp_path / "state.npz"
    tckpt.save_checkpoint(path, (state, np.int32(2)))
    template = (todo.mapping_init(xyzi[0], mask[0], MAP_CAP, cfg),
                np.int32(0))
    state, start = tckpt.load_checkpoint(path, template)
    assert int(start) == 2
    for i in range(int(start), xyzi.shape[0]):
        state, out = todo.mapping_step(state, xyzi[i], mask[i], cfg)
        assert torch.equal(out[0], full.odometry.poses[i])
    assert torch.equal(state.map_cloud.xyzi, full.map_xyzi)
    assert torch.equal(state.map_cloud.mask, full.map_mask)


def test_checkpoint_checks_shapes(scans, tmp_path):
    xyzi, mask = _port(scans, np.float32)
    state = todo.mapping_init(xyzi[0], mask[0], MAP_CAP, _cfg())
    path = tmp_path / "state.npz"
    tckpt.save_checkpoint(path, state)
    other = todo.mapping_init(xyzi[0], mask[0], MAP_CAP // 2, _cfg())
    with pytest.raises(ValueError, match="map_cloud"):
        tckpt.load_checkpoint(path, other)


def test_default_grid_equals_the_golden_align():
    """The port's ``OdometryConfig`` departs from JAX's in ``grid_capacity``
    (1 << 16, not 1 << 15). On the first pair of the golden sequence of
    ``chip_smoke.py`` phase 17, an exact f64 align at the port's grid
    equals the f64 golden NDT (``tests/golden_ndt.py``) to 1e-10 m
    (observed 2e-15); at JAX's grid it lands 5e-4 m away, because map
    voxels that share a hash slot drop out."""
    import golden_ndt

    a_xyzi, a_mask, _ = spinning_lidar_scans(1, 2, 32, 2048,
                                             fov_deg=(-30.67, 10.67))
    scene = a_xyzi[0][a_mask[0]]
    rng = np.random.default_rng(0)
    cfg = todo.OdometryConfig()
    ds = []
    for k in range(2):
        c = scene.copy()
        c[:, 0] -= 0.3 * k
        c[:, 1] -= 0.1 * k
        c[:, :3] += rng.normal(0, 0.01, (len(c), 3)).astype(np.float32)
        ds.append(todo._downsample(torch.from_numpy(c).double(),
                                   torch.ones(len(c), dtype=torch.bool),
                                   cfg))
    clouds = [d.xyzi[d.mask][:, :3].numpy() for d in ds]
    n = cfg.ndt
    leaves, min_b, max_b, div = golden_ndt.build_map(clouds[0], n.resolution)
    gold, _, _, _ = golden_ndt.align(
        leaves, min_b, max_b, div, clouds[1], cfg_res=n.resolution,
        step_size=n.step_size, eps=n.transformation_epsilon,
        max_iter=n.max_iterations)
    exact = n._replace(frozen_linesearch=False, regather_iterations=1 << 30)
    dist = {}
    for grid in (n.grid_capacity, CFG.ndt.grid_capacity):
        g = exact._replace(grid_capacity=grid)
        res = todo.ndt.ndt_align(todo.ndt.build_ndt_map(ds[0], g), ds[1],
                                 None, g)
        dist[grid] = np.linalg.norm(res.transform.numpy()[:3, 3]
                                    - gold[:3, 3])
    assert n.grid_capacity == 1 << 16 and CFG.ndt.grid_capacity == 1 << 15
    assert dist[1 << 16] < 1e-10
    assert dist[1 << 15] > 1e-5
