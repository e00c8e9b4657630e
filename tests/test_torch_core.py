"""Core layer of the PyTorch port against the JAX package: se3, segment
sums, eigh3 and the voxel downsample.

Inputs are made with numpy from a seed and fed to both packages. Bounds:
f64 results agree to 1e-12 (same formulas, rounding-level differences in
library functions); f32 downsample centroids to 1e-5 m (the port sums each
voxel sequentially, the JAX package by a lane tree); voxel order, counts
and masks exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.ops.eigh3 import eigh3_soa as j_eigh3_soa  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.core import se3 as tse3  # noqa: E402
from toyslam_tpu_torch.ops import segment  # noqa: E402
from toyslam_tpu_torch.ops.eigh3 import eigh3_soa  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402

DTYPES = [(np.float64, 1e-12), (np.float32, 1e-5)]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_euler_chart_matches_jax(rng):
    # Both branches of Eigen's eulerAngles(0,1,2) (roll > 0 flips).
    rpy = rng.uniform(-3.0, 3.0, (64, 3))
    rpy[:, 1] = rng.uniform(-1.5, 1.5, 64)
    R_j = np.asarray(jse3.euler_xyz_to_rot(jnp.asarray(rpy)))
    R_t = tse3.euler_xyz_to_rot(_t(rpy)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-12)
    np.testing.assert_allclose(tse3.rot_to_euler_xyz(_t(R_j)).numpy(),
                               np.asarray(jse3.rot_to_euler_xyz(
                                   jnp.asarray(R_j))), atol=1e-12)
    p = np.concatenate([rng.normal(size=(64, 3)), rpy], 1)
    T_j = np.asarray(jse3.pose6_to_matrix(jnp.asarray(p)))
    np.testing.assert_allclose(tse3.pose6_to_matrix(_t(p)).numpy(), T_j,
                               atol=1e-12)
    np.testing.assert_allclose(tse3.matrix_to_pose6(_t(T_j)).numpy(),
                               np.asarray(jse3.matrix_to_pose6(
                                   jnp.asarray(T_j))), atol=1e-12)
    # The chart round-trips on the Eigen branch.
    T_back = tse3.pose6_to_matrix(tse3.matrix_to_pose6(_t(T_j))).numpy()
    np.testing.assert_allclose(T_back, T_j, atol=1e-12)


@pytest.mark.parametrize("rank", [6, 4])
def test_svd_solve_matches_jax(rng, rank):
    """Full-rank and rank-deficient 6x6 systems (the thresholded
    singular values drop out of the least-squares solve)."""
    M = rng.normal(size=(6, rank))
    A = M @ M.T
    b = rng.normal(size=6)
    want = np.asarray(jse3.svd_solve(jnp.asarray(A), jnp.asarray(b)))
    got = tse3.svd_solve(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_segment_sums_match_numpy_oracle(rng):
    n, S = 2000, 300
    keys = np.sort(rng.integers(0, 500, n)).astype(np.int32)
    keys[-150:] = segment.INT_MAX  # invalid tail
    vals = rng.normal(size=(n, 3))
    vals[-150:] = 0.0
    # One row of the lane forms (B = 1).
    kt = torch.from_numpy(keys)[None]
    vt = torch.from_numpy(vals)[None]
    first, pos, n_unique = segment.run_bookkeeping_lanes(kt)
    sums, starts = segment.seg_reduce_lanes(kt, vt, first, pos, S)
    first, pos, n_unique = first[0], pos[0], n_unique[0]
    sums, starts = sums[0], starts[0]
    uniq, idx = np.unique(keys[:-150], return_index=True)
    assert int(n_unique) == len(uniq)
    assert np.array_equal(first.numpy().nonzero()[0], idx)
    k = min(S, len(uniq))
    want = np.stack([vals[:-150][keys[:-150] == u].sum(0) for u in uniq[:k]])
    np.testing.assert_allclose(sums.numpy()[:k], want, atol=1e-12)
    assert np.array_equal(starts.numpy()[:k], idx[:k])
    assert not sums.numpy()[k:].any()
    bc = segment.seg_broadcast_lanes(sums[None], pos[None])[0].numpy()
    np.testing.assert_array_equal(bc[idx[:k]], sums.numpy()[:k])
    # Reruns are bit-identical (no scheduling-dependent sums).
    again, _ = segment.seg_reduce_lanes(kt, vt, first[None], pos[None], S)
    assert torch.equal(sums, again[0])


@pytest.mark.parametrize("B", [1, 3])
def test_sort_lanes_matches_each_rows_stable_sort(rng, B):
    """One sort of B rows (int64 lane-major keys, or the int32 keys at B =
    1) gives each row's stable sort, ``order`` indexing the flat rows."""
    keys = rng.integers(-50, 50, (B, 400)).astype(np.int32)
    keys[:, -40:] = segment.INT_MAX
    kt = torch.from_numpy(keys)
    got, order = segment.sort_lanes(kt)
    for b in range(B):
        want, want_order = torch.sort(kt[b], stable=True)
        assert torch.equal(got[b], want)
        assert torch.equal(order[b], want_order + b * keys.shape[1])


def test_segment_sums_all_invalid():
    kt = torch.full((1, 64), segment.INT_MAX, dtype=torch.int32)
    first, pos, n_unique = segment.run_bookkeeping_lanes(kt)
    sums, _ = segment.seg_reduce_lanes(kt, torch.zeros(1, 64, 2), first, pos,
                                       8)
    assert int(n_unique) == 0 and not first.any() and not sums.any()


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_eigh3_soa_matches_jax(rng, dtype, tol):
    A = rng.normal(size=(512, 3, 3))
    A = (A @ np.swapaxes(A, 1, 2)).astype(dtype)  # PSD, like covariances
    comps = [A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2],
             A[:, 2, 2]]
    ev_j, vec_j = jax.jit(j_eigh3_soa)(*map(jnp.asarray, comps))
    ev_t, vec_t = eigh3_soa(*map(_t, comps))
    scale = np.abs(np.asarray(ev_j)).max()
    for a, b in zip(ev_t, ev_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol * scale)
    for a, b in zip(vec_t, vec_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol * 10)


@pytest.fixture(scope="module")
def scan():
    xyzi, mask, _ = spinning_lidar_scans(3, 1, 16, 512)
    return xyzi[0], mask[0]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("capacity,with_intensity",
                         [(4096, True), (4096, False), (1000, True),
                          (10000, False)])
def test_voxel_downsample_matches_jax(scan, dtype, tol, capacity,
                                      with_intensity):
    """Sorted voxel order, valid lanes first, truncation at capacity and
    padding beyond the input size, with and without intensity."""
    xyzi, mask = scan
    ds_j = jax.jit(jpc.voxel_downsample, static_argnums=(1, 2, 3))(
        jpc.PointCloud(jnp.asarray(xyzi, dtype), jnp.asarray(mask)), 0.3,
        capacity, with_intensity)
    ds_t = tpc.voxel_downsample(
        tpc.PointCloud(_t(xyzi.astype(dtype)), _t(mask)), 0.3, capacity,
        with_intensity=with_intensity)
    v = np.asarray(ds_j.mask)
    assert ds_t.xyzi.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert np.array_equal(ds_t.mask.numpy(), v)
    assert 0 < v.sum() <= capacity
    if capacity == 1000:
        assert v.all()  # more voxels than slots: truncated
    got, want = ds_t.xyzi.numpy(), np.asarray(ds_j.xyzi)
    np.testing.assert_allclose(got[v], want[v], atol=tol)
    np.testing.assert_array_equal(got[~v], want[~v])  # sentinel lanes
