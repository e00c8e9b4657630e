"""The last public names of the JAX package in the PyTorch port, each
against its JAX counterpart: ``ops/eigh3.eigh3``, ``core/pointcloud.
voxel_ids`` and ``unique_voxel_slots``, ``runtime/native.available``,
``estimators/factors.GRAVITY_W``, ``core/se3.svd_solve``'s
``rcond_factor`` and ``registration/ndt.compute_derivatives``'
``compute_hessian``.

Inputs are made with numpy from a seed. Bounds: eigh3 (f64) within 1e-12
in eigenvalues and in eigenvectors up to sign; where an eigenvalue
repeats, the basis of its eigenspace is set by rounding noise (the
off-diagonal entries left at ~1e-16 pick the rotations), so there the
eigenspace's projector is held to 1e-12 instead of each vector. Voxel ids
and slots are int for int. svd_solve within rtol 1e-12 of JAX at three
cutoffs (1.3e-15 seen), and bit-equal to its former fixed cutoff at the
default. The NDT score and gradient (f64) within rtol 1e-10 of JAX, as
``test_torch_ndt.py``; the analytic gradient and Hessian against
``torch.func`` within JAX's own autodiff bounds
(``tests/test_ndt.py::test_derivatives_match_autodiff``: rtol 1e-8 and
1e-6; 4e-16 and 2e-15 of the largest entry seen).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.estimators import factors as jfactors  # noqa: E402
from toyslam_tpu.ops.eigh3 import eigh3 as j_eigh3  # noqa: E402
from toyslam_tpu.registration import ndt as jndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.core import se3 as tse3  # noqa: E402
from toyslam_tpu_torch.estimators import factors  # noqa: E402
from toyslam_tpu_torch.ops.eigh3 import eigh3  # noqa: E402
from toyslam_tpu_torch.registration import ndt as tndt  # noqa: E402
from toyslam_tpu_torch.runtime import native  # noqa: E402

NDT_CFG = jndt.NDTConfig(resolution=2.0, map_capacity=1024,
                         grid_capacity=1 << 12)
OFFSETS = tndt._OFFSETS["DIRECT7"]


def _spectra(rng):
    """64 symmetric f64 3x3 matrices: distinct eigenvalues, a repeated
    pair, one and two zero eigenvalues, a multiple of I, and zeros."""
    lam = rng.uniform(-3.0, 3.0, (64, 3))
    lam[32:44, 1] = lam[32:44, 0]
    lam[44:52, 0] = 0.0
    lam[52:56, :2] = 0.0
    lam[56:60, 1:] = lam[56:60, :1]
    lam[60:] = 0.0
    Q, _ = np.linalg.qr(rng.normal(size=(64, 3, 3)))
    A = Q @ (lam[:, :, None] * np.swapaxes(Q, 1, 2))
    return 0.5 * (A + np.swapaxes(A, 1, 2))


def test_eigh3_matches_jax(rng):
    A = _spectra(rng)
    jw, jv = (np.asarray(a) for a in jax.jit(j_eigh3)(jnp.asarray(A)))
    tw, tv = eigh3(torch.from_numpy(A))
    assert tw.shape == (64, 3) and tv.shape == (64, 3, 3)
    tw, tv = tw.numpy(), tv.numpy()
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tv @ (tw[:, :, None] * np.swapaxes(tv, 1, 2)),
                               A, rtol=0, atol=1e-12)
    repeats = 0
    for b in range(64):
        scale = max(np.abs(jw[b]).max(), 1e-300)
        # Groups of equal eigenvalues: split where the sorted ones part.
        cuts = [0] + [j for j in (1, 2)
                      if jw[b, j] - jw[b, j - 1] > 1e-9 * scale] + [3]
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            if hi - lo == 1:  # an eigenvector, up to sign
                s = np.sign(jv[b, :, lo] @ tv[b, :, lo])
                np.testing.assert_allclose(s * tv[b, :, lo], jv[b, :, lo],
                                           rtol=0, atol=1e-12)
            else:  # the repeated eigenvalue's eigenspace
                repeats += 1
                np.testing.assert_allclose(
                    tv[b, :, lo:hi] @ tv[b, :, lo:hi].T,
                    jv[b, :, lo:hi] @ jv[b, :, lo:hi].T, rtol=0, atol=1e-12)
    assert repeats == 24  # the rows of _spectra with a repeat


def _masked_cloud(rng, n=4096):
    xyzi = np.concatenate([rng.uniform(-6.0, 6.0, (n, 3)),
                           rng.uniform(0.0, 1.0, (n, 1))], 1)
    xyzi = xyzi.astype(np.float32)
    mask = rng.random(n) > 0.25
    xyzi[~mask, :3] = tpc.PAD_COORD
    return xyzi, mask


@pytest.mark.parametrize("capacity", [None, 300])
def test_voxel_ids_and_slots_match_jax(rng, capacity):
    """Without a capacity, and with one below the number of voxels (points
    past it get slot == capacity)."""
    xyzi, mask = _masked_cloud(rng)
    jids = jax.jit(jpc.voxel_ids, static_argnums=1)(
        jpc.PointCloud(jnp.asarray(xyzi), jnp.asarray(mask)), 0.5)
    tids = tpc.voxel_ids(tpc.PointCloud(torch.from_numpy(xyzi),
                                        torch.from_numpy(mask)), 0.5)
    jslots = jax.jit(jpc.unique_voxel_slots, static_argnums=1)(jids[0],
                                                              capacity)
    tslots = tpc.unique_voxel_slots(tids[0], capacity)
    for got, want in zip(tids + tslots, jids + jslots):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n_unique = int(tslots[2])
    assert n_unique > 300  # the capacity cuts
    if capacity is not None:
        assert (tslots[1].numpy()[mask] == capacity).any()


def test_native_available():
    assert native.available()


@pytest.mark.parametrize("cc", ["missing", "failing"])
def test_native_available_false_when_the_build_fails(monkeypatch, tmp_path,
                                                     cc):
    """A compiler that is not there, or one that fails: False, no raise;
    the entry points still raise."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CC", str(tmp_path / "no-cc") if cc == "missing"
                       else "false")
    assert native.available() is False
    assert native._lib is None
    with pytest.raises(RuntimeError):
        native.lzf_decompress(b"\x00a", 1)


def test_gravity_w_matches_jax():
    np.testing.assert_array_equal(factors.GRAVITY_W.numpy(),
                                  np.asarray(jfactors.GRAVITY_W))
    assert factors.GRAVITY_W[2] == -factors.GRAVITY


def _rank_deficient(rng):
    """A symmetric 6x6 of singular values 10, 1, 1e-2, 1e-5, 0, 0."""
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    A = Q @ np.diag([10.0, 1.0, 1e-2, 1e-5, 0.0, 0.0]) @ Q.T
    return 0.5 * (A + A.T), rng.normal(size=6)


@pytest.mark.parametrize("rcond_factor,kept",
                         [(1e-8, 4), (1e-4, 3), (5e-2, 2)])
def test_svd_solve_rcond_matches_jax(rng, rcond_factor, kept):
    A, b = _rank_deficient(rng)
    want = np.asarray(jax.jit(jse3.svd_solve)(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(rcond_factor)))
    got = tse3.svd_solve(torch.from_numpy(A), torch.from_numpy(b),
                         rcond_factor).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # The cutoff keeps `kept` singular values: the solution lies in their
    # span.
    u, s, _ = np.linalg.svd(A)
    assert (s > rcond_factor * s[0]).sum() == kept
    np.testing.assert_allclose(u[:, kept:].T @ got, 0.0, atol=1e-6)


def _svd_solve_fixed_cutoff(A, b):
    """``svd_solve`` as it was before ``rcond_factor``: the cutoff fixed at
    ``eps * n * max_sv``."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    cutoff = torch.finfo(A.dtype).eps * A.shape[-1] * s.amax(-1, keepdim=True)
    keep = s > cutoff
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    ub = (u * b[..., :, None]).sum(-2)
    return (vt * (s_inv * ub)[..., :, None]).sum(-2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_svd_solve_default_is_unchanged(rng, dtype):
    A, b = _rank_deficient(rng)
    M = rng.normal(size=(5, 6, 6))
    A = torch.from_numpy(np.concatenate([A[None], M @ np.swapaxes(M, 1, 2)]))
    b = torch.from_numpy(np.concatenate([b[None], rng.normal(size=(5, 6))]))
    A, b = A.to(dtype), b.to(dtype)
    got, want = tse3.svd_solve(A, b), _svd_solve_fixed_cutoff(A, b)
    assert torch.equal(got, want)
    assert torch.equal(tse3.svd_solve(A, b, None), want)


def _floor_and_walls(rng, n):
    """The three planes of ``tests/test_ndt.py``'s cloud pair."""
    floor = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                      0.05 * rng.normal(size=n)], 1)
    h = n // 2
    wall1 = np.stack([rng.uniform(-20, 20, h),
                      8.0 + 0.05 * rng.normal(size=h), rng.uniform(0, 5, h)],
                     1)
    wall2 = np.stack([-12.0 + 0.05 * rng.normal(size=h),
                      rng.uniform(-20, 20, h), rng.uniform(0, 5, h)], 1)
    return np.concatenate([floor, wall1, wall2], 0)


@pytest.fixture()
def ndt_problem(rng):
    """A f64 map of the planes and a shifted quarter of them as source."""
    pts = _floor_and_walls(rng, 500)
    xyzi = np.concatenate([pts, np.zeros((len(pts), 1))], 1)
    src = pts[::4] + 0.1
    p = np.array([0.05, -0.12, 0.08, 0.02, -0.03, 0.05])
    return xyzi, src, p


def test_compute_derivatives_without_hessian_matches_jax(ndt_problem):
    xyzi, src, p = ndt_problem
    ones = np.ones(len(xyzi), bool)
    jmap = jax.jit(jndt.build_ndt_map, static_argnums=1)(
        jpc.PointCloud(jnp.asarray(xyzi), jnp.asarray(ones)), NDT_CFG)
    tmap = convert.ndt_map({k: np.asarray(v)
                            for k, v in jmap._asdict().items()}, device="cpu")
    d1, d2, _ = tndt.gauss_coefficients(NDT_CFG.resolution,
                                        NDT_CFG.outlier_ratio)
    src_mask = np.ones(len(src), bool)

    @jax.jit
    def ref(m, x, mk, pp):
        return jndt.compute_derivatives(m, x, mk, pp, d1, d2,
                                        NDT_CFG.resolution, OFFSETS,
                                        compute_hessian=False,
                                        use_pallas=False)

    score_j, grad_j, hess_j = ref(jmap, jnp.asarray(src),
                                  jnp.asarray(src_mask), jnp.asarray(p))
    args = (tmap, torch.from_numpy(src), torch.from_numpy(src_mask), p, d1,
            d2, NDT_CFG.resolution, OFFSETS)
    score, grad, hess = tndt.compute_derivatives(*args, compute_hessian=False)
    assert hess is None and hess_j is None
    np.testing.assert_allclose(score.numpy(), np.asarray(score_j),
                               rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=1e-10,
                               atol=1e-12)
    assert float(score_j) > 10  # a real objective: many pairs in range
    # The same sums as with the Hessian, bit for bit.
    full = tndt.compute_derivatives(*args)
    assert torch.equal(full[0], score) and torch.equal(full[1], grad)
    assert full[2].shape == (6, 6)


def test_derivatives_match_autodiff(ndt_problem):
    """The port's analytic gradient and Hessian against ``torch.func`` of
    the NDT score written here from its pieces: the pose chart, the
    neighbourhood gathered at p, and the Gaussian terms with the
    reference's guard (``ndt_omp_impl.hpp:506-507``)."""
    xyzi, src, p = ndt_problem
    cfg = convert.ndt_config(NDT_CFG._asdict())
    tmap = tndt.build_ndt_map(tpc.PointCloud(
        torch.from_numpy(xyzi), torch.ones(len(xyzi), dtype=torch.bool)), cfg)
    d1, d2, _ = tndt.gauss_coefficients(cfg.resolution, cfg.outlier_ratio)
    xyz = torch.from_numpy(src)
    mask = torch.ones(len(src), dtype=torch.bool)
    stats = tndt.gather_neighborhood(tmap, xyz, mask, p, cfg.resolution,
                                     OFFSETS).packed
    K = len(OFFSETS)
    mean = stats[0:3].T
    xx, xy, xz, yy, yz, zz = stats[3:9]
    icov = torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)
    gathered = stats[9] > 0.5

    def score(pp):
        T = tse3.pose6_to_matrix(pp)
        q = (xyz @ T[:3, :3].T + T[:3, 3]).repeat(K, 1) - mean
        qCq = torch.einsum("ni,nij,nj->n", q, icov, q)
        e = torch.exp(-0.5 * d2 * qCq)
        ok = gathered & (d2 * e <= 1.0) & (d2 * e >= 0.0)
        return torch.where(ok, -d1 * e, torch.zeros_like(e)).sum()

    s, g, H = tndt.compute_derivatives(tmap, xyz, mask, p, d1, d2,
                                       cfg.resolution, OFFSETS)
    pt = torch.from_numpy(p)
    assert int(gathered.sum()) > 50
    np.testing.assert_allclose(s.numpy(), score(pt).numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), torch.func.grad(score)(pt).numpy(),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(H.numpy(),
                               torch.func.hessian(score)(pt).numpy(),
                               rtol=1e-6, atol=1e-8)
