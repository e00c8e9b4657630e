"""The CUDA kernels K1-K6 against their plain versions on the card.

Needs a CUDA device and ``nvcc``; every test skips without a card. The
file imports no JAX, so it runs on a machine that has only the port:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Bounds: K2 bit-identical (it does no arithmetic); K1/K3 sums within rtol
1e-4 of the largest sum of their group (score, gradient, Hessian): f32
sums over ~10^5 pairs in another order; an NDT align on the card within
1e-4 m / 1e-5 rad of the same align through the plain versions on the CPU.
K4 indices equal on 99.9 % of the rows, every other row a tie within 1e-6
of the row's scale; K5 within 1 bf16 ulp on 99.9 % of the valid entries
(both round each step as their plain versions do); K6 sums within rtol
1e-4 of the largest sum of their group. A GICP align on the card within
1e-3 m / 1e-3 rad of the same align on the CPU (a bf16 tie can swap a
covariance neighbour; the CPU and the card break top-k ties differently).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from toyslam_tpu_torch.core import pointcloud  # noqa: E402
from toyslam_tpu_torch.ops import gicp_kernels, nn_kernels  # noqa: E402
from toyslam_tpu_torch.ops import ndt_kernels  # noqa: E402
from toyslam_tpu_torch.registration import gicp, ndt  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def clouds():
    xyzi, mask, _ = spinning_lidar_scans(4, 2, 32, 1024)
    return [pointcloud.voxel_downsample(pointcloud.PointCloud(
        torch.from_numpy(xyzi[k]), torch.from_numpy(mask[k])), 0.3, 8192,
        with_intensity=False) for k in range(2)]


def _close(got, want, rtol=1e-4):
    got, want = got.double().cpu(), want.double().cpu()
    for sl in (slice(0, 1), slice(1, 7), slice(7, 28)):
        scale = want[sl].abs().max().clamp(min=1e-30)
        assert ((got[sl] - want[sl]).abs().max() / scale) <= rtol


def test_kernels_match_plain_on_card(cuda, clouds):
    cfg = ndt.NDTConfig(grid_capacity=1 << 15, map_capacity=8192)
    m = ndt.build_ndt_map(pointcloud.PointCloud(*(t.to(cuda)
                                                  for t in clouds[0])), cfg)
    src = clouds[1]
    d1, d2, _ = ndt.gauss_coefficients(1.0, 0.55)
    ev = ndt._Evaluator(m, src.xyzi[:, :3].to(cuda), src.mask.to(cuda), 1.0,
                        ndt._OFFSETS["DIRECT7"], d1, d2)
    params = ev.params(np.array([0.3, 0.0, 0.0, 0.0, 0.0, 0.004],
                                np.float32))
    h, nvid, okm = ev.neighbor_hash(params)
    ndt_kernels.reset_launch_counts()
    stats = ndt_kernels.ndt_gather_repack(m.hash_table, h, nvid, okm)
    plain = ndt_kernels.ndt_gather_repack_plain(m.hash_table, h, nvid, okm)
    assert torch.equal(stats.view(torch.int32), plain.view(torch.int32))
    assert 0 < float(stats[9].sum()) < stats.shape[1]
    _close(ndt_kernels.ndt_terms_packed(params, ev.xyz, stats),
           ndt_kernels.ndt_terms_packed_plain(params, ev.xyz, stats))
    _close(ndt_kernels.ndt_terms_gathered(params, ev.xyz, m.hash_table, h,
                                          nvid, okm),
           ndt_kernels.ndt_terms_gathered_plain(params, ev.xyz, m.hash_table,
                                                h, nvid, okm))
    assert ndt_kernels.LAUNCHES == {"ndt_terms_gathered": 1,
                                    "ndt_gather_repack": 1,
                                    "ndt_terms_packed": 1}
    with pytest.raises(TypeError):
        ndt_kernels.ndt_terms_packed(params.double(), ev.xyz.double(),
                                     stats.double())


@pytest.mark.parametrize("frozen", [False, True])
def test_align_on_card_matches_cpu(cuda, clouds, frozen):
    cfg = ndt.NDTConfig(grid_capacity=1 << 15, map_capacity=8192,
                        transformation_epsilon=1e-3,
                        frozen_linesearch=frozen,
                        regather_iterations=4 if frozen else 1 << 30)
    res = {}
    for dev in ("cpu", cuda):
        tgt, src = (pointcloud.PointCloud(*(t.to(dev) for t in c))
                    for c in clouds)
        res[str(dev)] = ndt.ndt_align(ndt.build_ndt_map(tgt, cfg), src,
                                      None, cfg)
    a, b = res["cpu"], res[str(cuda)]
    assert a.converged and b.converged
    np.testing.assert_allclose(b.pose6[:3], a.pose6[:3], atol=1e-4)
    np.testing.assert_allclose(b.pose6[3:], a.pose6[3:], atol=1e-5)


def _gicp_problem(cuda, clouds):
    src, tgt = (pointcloud.PointCloud(*(t.to(cuda) for t in c))
                for c in (clouds[1], clouds[0]))
    return gicp._problem(src, tgt, gicp.GICPConfig())


def test_nn_and_gicp_kernels_match_plain_on_card(cuda, clouds):
    prob = _gicp_problem(cuda, clouds)
    nn_kernels.reset_launch_counts()
    gicp_kernels.reset_launch_counts()
    for n in (prob.src.shape[0], 1000):  # 1000: ragged tiles
        src = prob.src[:n]
        best, idx = nn_kernels.nearest_neighbor(src, prob.tgt_t, prob.tsq)
        pbest, pidx = nn_kernels.nearest_neighbor_plain(src, prob.tgt_t,
                                                        prob.tsq)
        differ = (idx != pidx).cpu().numpy()
        assert differ.mean() <= 1e-3
        d = (prob.tsq[None] - 2.0 * src.double() @ prob.tgt_t.double()
             ).cpu().numpy()
        rows = np.flatnonzero(differ)
        gap = np.abs(d[rows, idx.cpu().numpy()[rows]]
                     - d[rows, pidx.cpu().numpy()[rows]])
        assert (gap <= 1e-6 * np.abs(d[rows]).max(1)).all()
        torch.testing.assert_close(best, pbest, rtol=1e-6, atol=1e-4)

        ssq = (src * src).sum(1)
        got = nn_kernels.neg_dist_bf16(src, ssq, prob.tgt_t, prob.tsq)
        want = nn_kernels.neg_dist_bf16_plain(src, ssq, prob.tgt_t, prob.tsq)
        valid = prob.mask[:n, None] & (prob.tsq < 1e8)[None]
        g, w = got.float()[valid], want.float()[valid]
        ulp = 2.0 ** -8 * w.abs()
        assert float(((g - w).abs() <= ulp).double().mean()) >= 0.999

    q, m6, w = gicp._correspondences(prob, torch.eye(3, device=cuda),
                                     torch.zeros(3, device=cuda))
    params = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0.1, -0.05, 0.02],
                          device=cuda)
    got = gicp_kernels.gicp_terms(params, prob.xyz, q, m6, w).double().cpu()
    want = gicp_kernels.gicp_terms_plain(params, prob.xyz, q, m6,
                                         w).double().cpu()
    for sl in (slice(0, 6), slice(6, 12), slice(12, 21), slice(21, 27)):
        assert ((got[sl] - want[sl]).abs().max()
                / want[sl].abs().max()) <= 1e-4
    assert nn_kernels.LAUNCHES == {"nearest_neighbor": 3,
                                   "neg_dist_bf16": 2}
    assert gicp_kernels.LAUNCHES == {"gicp_terms": 1}
    with pytest.raises(TypeError):
        gicp_kernels.gicp_terms(params.double(), prob.xyz.double(),
                                q.double(), m6.double(), w.double())


def test_gicp_align_on_card_matches_cpu(cuda, clouds):
    res = {}
    for dev in ("cpu", cuda):
        src, tgt = (pointcloud.PointCloud(*(t.to(dev) for t in c))
                    for c in (clouds[1], clouds[0]))
        res[str(dev)] = gicp.gicp_align(src, tgt)
    a, b = res["cpu"], res[str(cuda)]
    assert a.converged and b.converged
    assert b.host_syncs == b.iterations
    np.testing.assert_allclose(b.transform[:3, 3], a.transform[:3, 3],
                               atol=1e-3)
    np.testing.assert_allclose(b.transform[:3, :3], a.transform[:3, :3],
                               atol=1e-3)
