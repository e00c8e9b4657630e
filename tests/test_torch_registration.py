"""The ICP/GICP slice of the PyTorch port against the JAX package on CPU.

Inputs come from numpy with fixed seeds: ``tests/test_gicp.py``'s floor +
wall recipe with a cross wall added as the target, a second independent
draw of the same scene moved by a known pose with 1 cm noise as the
source, both padded so that the sentinel lanes are exercised. Every
tolerance is stated where it is used, with its reason. The CUDA kernels
themselves are held against the plain versions tested here by
``tests/test_torch_gpu.py`` on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import golden_gicp  # noqa: E402
from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.ops import gicp_pallas, nn_pallas  # noqa: E402
from toyslam_tpu.registration import gicp as jgicp  # noqa: E402
from toyslam_tpu.registration import icp as jicp  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.core import se3 as tse3  # noqa: E402
from toyslam_tpu_torch.ops import gicp_kernels, nn_kernels  # noqa: E402
from toyslam_tpu_torch.registration import gicp as tgicp  # noqa: E402
from toyslam_tpu_torch.registration import icp as ticp  # noqa: E402

TRUE_P = np.array([0.3, -0.2, 0.1, 0.01, -0.02, 0.05])
BF16_ULP = 2.0 ** -8  # bf16 spacing relative to the value, at most


def _structured_cloud(rng, n):
    """Floor + wall as ``tests/test_gicp.py:9`` builds them, plus a cross
    wall at x = -8, so that two independent draws fix all six degrees of
    freedom; n // 3 points each."""
    m = n // 3

    def noise():
        return 0.02 * rng.normal(size=m)

    floor = np.stack([rng.uniform(-10, 10, m), rng.uniform(-10, 10, m),
                      noise()], 1)
    wall = np.stack([rng.uniform(-10, 10, m), 5.0 + noise(),
                     rng.uniform(0, 4, m)], 1)
    cross = np.stack([-8.0 + noise(), rng.uniform(-10, 5, m),
                      rng.uniform(0, 4, m)], 1)
    return np.concatenate([floor, wall, cross], 0)


@pytest.fixture(scope="module")
def pair():
    """(target, source) numpy points and the true source -> target pose."""
    rng = np.random.default_rng(3)
    T = np.asarray(jse3.pose6_to_matrix(jnp.asarray(TRUE_P, jnp.float64)))
    tgt = _structured_cloud(rng, 1024)
    src = (_structured_cloud(rng, 1024) - T[:3, 3]) @ T[:3, :3]
    return tgt, src + 0.01 * rng.normal(size=src.shape), T


def _both(points, capacity, dtype):
    """One padded cloud in both packages."""
    j = jpc.from_numpy(points, capacity=capacity, dtype=dtype)
    return j, convert.point_cloud(np.asarray(j.xyzi), np.asarray(j.mask),
                                  device="cpu")


def _rel(got, want):
    """Largest error of the 27 GN sums, each relative to the largest sum of
    its group (gradient, A_tt, A_tr, A_rr)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return max(np.abs(got[g] - want[g]).max() / np.abs(want[g]).max()
               for g in (slice(0, 6), slice(6, 12), slice(12, 21),
                         slice(21, 27)))


@pytest.mark.parametrize("scale", [1e-9, 0.3, 2.5])
def test_skew_and_so3_exp_match_jax(scale):
    """Both branches of ``so3_exp`` (Taylor below 1e-7 rad); f64 agrees to
    rounding (bound 1e-15, observed <= 4.5e-16)."""
    w = np.random.default_rng(1).normal(size=(5, 3)) * scale
    for fn in ("skew", "so3_exp"):
        got = getattr(tse3, fn)(torch.from_numpy(w)).numpy()
        want = np.asarray(getattr(jse3, fn)(jnp.asarray(w)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_k4_plain_matches_pallas(pair):
    """K4's plain version against ``nn_pallas.nearest_neighbor`` in
    interpret mode, ``mode="highest"``: 2048 query rows (half of them pad
    rows at 1e9) against 3072 target columns (two scene draws, then
    sentinel columns), a 4 x 3 tile grid. The two round ``s.t`` differently
    (XLA's dot vs per-step rounding), so the partials agree to rtol 1e-6 /
    atol 1e-4 (f32 spacing at |2 s.t| ~ 100 to 2e10), and an index may
    differ only where the two candidates tie within 1e-6 of the row's
    scale."""
    tgt, src, T = pair
    second = _structured_cloud(np.random.default_rng(9), 1024)
    _, tt = _both(np.concatenate([tgt, second]), 3072, jnp.float32)
    _, ts = _both(src, 2048, jnp.float32)
    tgt_t, tsq = nn_kernels.target_operands(tt.xyzi[:, :3], tt.mask, 1e9)
    Tt = torch.tensor(T, dtype=torch.float32)
    moved = (ts.xyzi[:, :3] @ Tt[:3, :3].T + Tt[:3, 3]).contiguous()
    best, idx = nn_kernels.nearest_neighbor_plain(moved, tgt_t, tsq)
    jbest, jidx = nn_pallas.nearest_neighbor(
        jnp.asarray(moved.numpy()), jnp.asarray(tgt_t.numpy()),
        jnp.asarray(tsq.numpy())[None], mode="highest", interpret=True)
    jbest, jidx = np.asarray(jbest), np.asarray(jidx)
    assert best.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_allclose(best.numpy(), jbest, rtol=1e-6, atol=1e-4)
    d64 = (tsq.double().numpy()[None]
           - 2.0 * moved.double().numpy() @ tgt_t.double().numpy())
    rows = np.flatnonzero(idx.numpy() != jidx)
    gap = np.abs(d64[rows, idx.numpy()[rows]] - d64[rows, jidx[rows]])
    assert (gap <= 1e-6 * np.abs(d64[rows]).max(1)).all(), (rows, gap)
    valid = ts.mask.numpy()
    assert (idx.numpy() == jidx)[valid].all()
    assert (idx.numpy()[valid] < 2048).all()  # sentinel columns never win


def test_k5_plain_matches_pallas(pair):
    """K5's plain version against ``nn_pallas.neg_dist_bf16`` in interpret
    mode. The TPU kernel forms ``s.t`` from a bf16 x3 split (~2^-16
    relative), the port in f32: on valid x valid entries within 2 bf16
    ulps + 5e-3 (the self-distance diagonal cancels to ~|s|^2 2^-16) on
    more than 99.9 % (``tests/test_gicp.py:113-120``)."""
    tgt, _, _ = pair
    _, tc = _both(tgt[:900], 1024, jnp.float32)
    xyz, mask = tc.xyzi[:, :3].contiguous(), tc.mask
    sq = (xyz * xyz).sum(1)
    tgt_t, tsq = nn_kernels.target_operands(xyz, mask, 1e9)
    got = nn_kernels.neg_dist_bf16_plain(xyz, sq, tgt_t, tsq)
    want = nn_pallas.neg_dist_bf16(
        jnp.asarray(xyz.numpy()), jnp.asarray(sq.numpy())[:, None],
        jnp.asarray(tgt_t.numpy()), jnp.asarray(tsq.numpy())[None],
        interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (1024, 1024)
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    vm = mask.numpy()
    g, w = got[vm][:, vm], want[vm][:, vm]
    assert (np.abs(g - w) <= 2 * BF16_ULP * np.abs(w) + 5e-3).mean() > 0.999
    assert (got[:, ~vm] < -5e8).all()  # sentinel columns rank last


def test_k6_plain_matches_pallas():
    """K6's plain version against ``gicp_pallas.gicp_terms`` in interpret
    mode on 2048 random correspondences (SPD Mahalanobis, 30 % rejected):
    f32 sums of 2048 terms in another order, within rtol 1e-5 of the
    largest sum of each group."""
    rng = np.random.default_rng(5)
    n = 2048
    xyz = rng.uniform(-20, 20, (3, n)).astype(np.float32)
    q = (xyz + rng.normal(0, 0.1, (3, n))).astype(np.float32)
    L = rng.normal(size=(n, 3, 3))
    M = L @ L.transpose(0, 2, 1) + np.eye(3)
    m6 = M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T.astype(np.float32)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    T = np.asarray(jse3.pose6_to_matrix(jnp.asarray(TRUE_P, jnp.float64)))
    params = np.concatenate([T[:3, :3].ravel(), T[:3, 3]]).astype(np.float32)
    want = gicp_pallas.gicp_terms(
        jnp.asarray(params)[None], *(jnp.asarray(a).reshape(-1, 16, 128)
                                     for a in (xyz, q, m6)),
        jnp.asarray(w).reshape(16, 128), interpret=True)
    got = gicp_kernels.gicp_terms_plain(*(
        torch.tensor(np.ascontiguousarray(a))
        for a in (params, xyz, q, m6, w)))
    assert got.shape == (27,) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("exact_knn", [True, False])
def test_f64_covariances_match_jax_and_golden(exact_knn):
    """f64 ranks in full precision either way (``gicp.py:127-131``): the
    covariances equal JAX's and the golden oracle's to 1e-9 (as
    ``tests/test_gicp.py:218-229``)."""
    pts = _structured_cloud(np.random.default_rng(42), 600)
    got = tgicp.compute_covariances(torch.from_numpy(pts),
                                    torch.ones(600, dtype=torch.bool), 20,
                                    0.001, exact_knn).numpy()
    want = np.asarray(jgicp.compute_covariances(
        jnp.asarray(pts), jnp.ones(600, bool), 20, 0.001, exact_knn))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        got, golden_gicp.compute_covariances(pts, k=20, eps=0.001),
        rtol=0, atol=1e-9)


def test_f32_bf16_covariances_match_jax_by_rows(pair):
    """f32 with ``exact_knn=False`` ranks on bf16 in both packages, from
    operands rounded differently, so a bf16 tie can swap the 20th
    neighbour: more than 90 % of the valid rows agree to rtol/atol 1e-2
    (``tests/test_gicp.py:132-133``); the rest are still plane covariances
    (eigenvalues (1e-3, 1, 1) to 1e-3)."""
    tgt, _, _ = pair
    jc, tc = _both(tgt, 2048, jnp.float32)
    got = tgicp.compute_covariances(tc.xyzi[:, :3], tc.mask, 20,
                                    0.001).numpy()
    want = np.asarray(jgicp.compute_covariances(jc.xyzi[:, :3], jc.mask,
                                                20, 0.001))
    vm = tc.mask.numpy()
    rows = np.isclose(got, want, rtol=1e-2, atol=1e-2).all((1, 2))
    assert rows[vm].mean() > 0.9, rows[vm].mean()
    ev = np.linalg.eigvalsh(got[vm].astype(np.float64))
    np.testing.assert_allclose(ev, np.broadcast_to([1e-3, 1, 1], ev.shape),
                               atol=1e-3)
    np.testing.assert_array_equal(got[~vm], np.broadcast_to(np.eye(3),
                                                            got[~vm].shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sparse_cloud_covariances_are_identity(dtype):
    """Fewer valid points than k: the k-th neighbour is a padded sentinel,
    so every covariance is the identity (``tests/test_gicp.py:69-82``)."""
    pts = np.random.default_rng(0).normal(0, 1.0, (5, 3))
    c = tpc.from_numpy(pts, capacity=64, dtype=dtype, device="cpu")
    C = tgicp.compute_covariances(c.xyzi[:, :3], c.mask, 20, 1e-3)
    assert torch.equal(C, torch.eye(3, dtype=dtype).expand(64, 3, 3))


def test_icp_steps_match_jax(pair):
    """One ICP iteration's parts on f64 (bound 1e-12, observed ~1e-15):
    the association through K4's plain version gives JAX's indices and
    distances (the JAX jnp path forms ``|s|^2 - 2 s.t + |t|^2``, K4's route
    ``(|t|^2 - 2 s.t) + |s|^2``), and Kabsch gives JAX's R, t."""
    tgt, src, T = pair
    jt, tt = _both(tgt, 2048, jnp.float64)
    js, ts = _both(src, 1536, jnp.float64)
    jidx, jdist = jicp.nearest_neighbor_association(
        js.xyzi[:, :3], js.mask, jt.xyzi[:, :3], jt.mask)
    idx, dist = ticp.nearest_neighbor_association(
        ts.xyzi[:, :3], ts.mask, tt.xyzi[:, :3], tt.mask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0,
                               atol=1e-12)
    matched = tt.xyzi[idx, :3]
    w = ts.mask.double()
    R, t = ticp.svd_motion_estimation(ts.xyzi[:, :3], matched, w)
    jR, jt_ = jicp.svd_motion_estimation(js.xyzi[:, :3],
                                         jnp.asarray(matched.numpy()),
                                         jnp.asarray(w.numpy()))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt_), rtol=0,
                               atol=1e-12)
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-12


# Pose bounds at ~2x the deviation from JAX observed on this file's data
# (max |T_port - T_jax| over the 4x4): ICP f64 6.0e-15 (14 iterations
# each), f32 1.32e-4 (f32 rounding over 14 slow iterations); GICP f64
# 3.6e-16 (4 outer iterations each, both k-NN routes), f32 exact 6.9e-7,
# f32 bf16 route 1.27e-4 (bf16 ties swap a few covariance neighbours).
@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1.2e-14),
                                       (jnp.float32, 3e-4)])
def test_icp_matches_jax(pair, dtype, tol):
    tgt, src, T = pair
    jt, tt = _both(tgt, 2048, dtype)
    js, ts = _both(src, 1536, dtype)
    want = jax.jit(jicp.icp_align)(js, jt)
    got = ticp.icp_align(ts, tt, None, convert.icp_config(
        jicp.ICPConfig()._asdict()))
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), rtol=0, atol=tol)
    assert got.host_syncs == got.iterations
    if dtype == jnp.float64:
        assert got.iterations == int(want.iterations)
        np.testing.assert_allclose(float(got.error), float(want.error),
                                   rtol=1e-9)


@pytest.mark.parametrize("dtype,exact_knn,tol", [
    (jnp.float64, False, 1e-15), (jnp.float64, True, 1e-15),
    (jnp.float32, False, 3e-4), (jnp.float32, True, 2e-6)])
def test_gicp_matches_jax(pair, dtype, exact_knn, tol):
    tgt, src, T = pair
    jt, tt = _both(tgt, 2048, dtype)
    js, ts = _both(src, 2048, dtype)
    cfg = jgicp.GICPConfig(exact_knn=exact_knn)
    want = jax.jit(lambda a, b: jgicp.gicp_align(a, b, config=cfg))(js, jt)
    got = tgicp.gicp_align(ts, tt, None, convert.gicp_config(cfg._asdict()))
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), rtol=0, atol=tol)
    assert got.host_syncs == got.iterations
    if dtype == jnp.float64:
        assert got.iterations == int(want.iterations)
    # Both land on the true pose to the 1 cm noise's resolution.
    Tg = got.transform.double().numpy()
    assert np.linalg.norm(Tg[:3, 3] - T[:3, 3]) < 0.01
    assert np.abs(Tg[:3, :3] - T[:3, :3]).max() < 2e-3


@pytest.mark.parametrize("which", ["source", "target", "both"])
def test_empty_clouds_stay_finite(which):
    """An empty source or target never gives a NaN transform
    (``tests/test_icp.py:107-124``)."""
    pts = np.random.default_rng(0).uniform(-5, 5, (512, 3))
    full = tpc.from_numpy(pts, capacity=1024, device="cpu")
    empty = tpc.from_numpy(np.zeros((0, 3)), capacity=1024, device="cpu")
    src = empty if which in ("source", "both") else full
    tgt = empty if which in ("target", "both") else full
    for r in (ticp.icp_align(src, tgt), tgicp.gicp_align(src, tgt)):
        assert torch.isfinite(r.transform).all(), r.transform


def test_wrappers_take_cpu_tensors_to_plain():
    """On CPU tensors each of K4-K6 and the GN update is its plain version
    and launches nothing; a device with no kernel, or mixed devices,
    raise."""
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    tgt_t, tsq = nn_kernels.target_operands(src, torch.ones(64, dtype=bool),
                                            1e9)
    ssq = (src * src).sum(1)
    g = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=12), rng.normal(size=(3, 64)),
        rng.normal(size=(3, 64)), rng.normal(size=(6, 64)),
        rng.uniform(size=64))]
    nn_kernels.reset_launch_counts()
    gicp_kernels.reset_launch_counts()
    for a, b in ((nn_kernels.nearest_neighbor(src, tgt_t, tsq),
                  nn_kernels.nearest_neighbor_plain(src, tgt_t, tsq)),
                 ((nn_kernels.neg_dist_bf16(src, ssq, tgt_t, tsq),),
                  (nn_kernels.neg_dist_bf16_plain(src, ssq, tgt_t, tsq),)),
                 ((gicp_kernels.gicp_terms(*g),),
                  (gicp_kernels.gicp_terms_plain(*g),)),
                 ((gicp_kernels.gicp_update(g[1][0, :27], g[0], 1e-6),),
                  (gicp_kernels.gicp_update_plain(g[1][0, :27], g[0],
                                                  1e-6),))):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert set(nn_kernels.LAUNCHES.values()) == {0}
    assert gicp_kernels.LAUNCHES == {"gicp_terms": 0, "gicp_update": 0}
    with pytest.raises(ValueError, match="no nearest-neighbour kernel"):
        nn_kernels.nearest_neighbor(src.to("meta"), tgt_t.to("meta"),
                                    tsq.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        gicp_kernels.gicp_terms(g[0].to("meta"), *g[1:])
    with pytest.raises(ValueError, match="several devices"):
        gicp_kernels.gicp_update(g[1][0, :27], g[0].to("meta"), 1e-6)


def test_convert_helpers():
    """The configs keep every shared field and drop the TPU dispatch
    knobs; the tensors the helpers make default to the card, and without
    one that default raises instead of falling back to the CPU."""
    jcfg = jgicp.GICPConfig(k_correspondences=10, exact_knn=True,
                            max_iterations=7, use_pallas_nn=True,
                            nn_mode="x6")
    tcfg = convert.gicp_config(jcfg._asdict())
    assert tcfg._asdict() == {k: v for k, v in jcfg._asdict().items()
                              if k in tgicp.GICPConfig._fields}
    assert set(jcfg._fields) - set(tcfg._fields) == {
        "use_pallas_nn", "nn_mode", "use_pallas_terms", "use_pallas_cov"}
    icfg = convert.icp_config(jicp.ICPConfig(eps=1e-3, nn_mode="x3")._asdict())
    assert icfg == ticp.ICPConfig(eps=1e-3, max_iterations=100)
    assert ticp.ICPConfig() == convert.icp_config(jicp.ICPConfig()._asdict())
    if torch.cuda.is_available():
        pytest.skip("the no-card default is checked on a machine without one")
    pts = np.zeros((4, 3))
    for make in (lambda: tpc.from_numpy(pts),
                 lambda: convert.point_cloud(np.zeros((4, 4)),
                                             np.ones(4, bool))):
        with pytest.raises((AssertionError, RuntimeError)):
            make()
