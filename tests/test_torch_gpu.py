"""The CUDA kernels K1-K6, D1 and D2 against their plain versions on the
card.

Needs a CUDA device and ``nvcc``; every test skips without a card. The
file imports no JAX, so it runs on a machine that has only the port:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Bounds: K2 bit-identical (it does no arithmetic); K1/K3 sums within rtol
1e-4 of the largest sum of their group (score, gradient, Hessian): f32
sums over ~10^5 pairs in another order, exactly zero where the plain sums
are (every point masked, every gate shut), bit-identical on a rerun, one
device operation a call; K1's neighbour hash bit-equal to the plain hash
where the mask flag holds, the flag equal everywhere (near voxel faces
too); an NDT align on the card within 1e-4 m / 1e-5 rad of the same align
through the plain versions on the CPU.
K4 bit-identical in both outputs on every row, padded rows included (its
tensor-core screen only picks the columns that it rescores in f32 as the
plain version rounds); K5 within 1 bf16 ulp on 99.9 % of the valid
entries (it rounds each step as its plain version does); K6 sums within rtol
1e-4 of the largest sum of their group, bit-identical on a rerun, one device
operation a call, at N from 1 to past its 256-correspondence blocks and
several waves of them. A GICP align on the card within
1e-3 m / 1e-3 rad of the same align on the CPU (a bf16 tie can swap a
covariance neighbour; the CPU and the card break top-k ties differently).
Mapping on the card: poses equal to odometry's bit for bit, and a
checkpoint that keeps devices and dtypes and resumes bit-identically.
``fitness_score`` through K4 equal to its plain route bit for bit;
``convert.eskf_state`` puts the state on the card by default;
``eskf_run`` and ``solve_positions_batch`` make no host synchronisation
(PyTorch's sync debug mode set to raise) and land near the same f64 runs
on the CPU: the ESKF's p, v, q within 1e-4 over 400 ticks (CPU f32
against f64 differs by 3.2e-7; the card's f32 may round otherwise, by FMA
contraction), the fixes within 1e-3 m (CPU f32 against f64: 1.4e-4 m, the
vertical DOP of ~12 of the anchor ring magnifying f32 rounding).
K1/K3 with a lane axis (the fleet): each lane of a launch over L = 1, 3
or 64 lanes in shuffled order bit-identical to the single-lane launch on
its inputs, within rtol 1e-4 of the plain versions as above, a rerun
bit-identical, one device operation a lane launch; a 4-lane
``fleet_fusion`` with its odometry equal to the single-lane runs bit for
bit and its fused track within 1e-5 m of theirs (f32; the batched matrix
products of the lanes' ESKF may round otherwise than the 2-D ones).
D1: ``highest`` bit-identical; the split modes within 2^-16 of the largest
|s.t| (the same exact bf16 products, summed by the tensor core in place of
the plain version's f32 adds; a bf16-level sum would miss by ~2^-9). D2
bit-identical (the same tree of f32 adds), one device operation a call.
All at ragged shapes: no shape gate.
GNSS on the card: ``solve_epochs_local`` makes no host synchronisation,
reruns bit-identically and lands within 2e-3 m of the host's f64 local
solve (the smoke run reads 2.6e-4 m at gnss-1024); RAIM and the urban
simulator in f64 on the card match the host within 1e-6 m with the same
decisions and classes; ``convert``'s GNSS helpers and ``store_init`` put
their tensors on the card by default.
``runtime/loader.ScanStream`` on the card (pinned ring, side-stream
copies, an event and ``record_stream``) yields every scan bit-identical
to the packed stack, with a consumer stream of its own that spins before
each read.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import pointcloud  # noqa: E402
from toyslam_tpu_torch.diag import gicp_call_ops  # noqa: E402
from toyslam_tpu_torch.estimators import eskf, trilateration  # noqa: E402
from toyslam_tpu_torch.ops import gather_kernels, gicp_kernels  # noqa: E402
from toyslam_tpu_torch.ops import nn_kernels, ranking_kernels  # noqa: E402
from toyslam_tpu_torch.ops import ndt_kernels  # noqa: E402
from toyslam_tpu_torch.pipelines import odometry  # noqa: E402
from toyslam_tpu_torch.registration import gicp, ndt  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402
from toyslam_tpu_torch.utils import checkpoint  # noqa: E402

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
    k1_args = (params, ev.xyz, ev.mask, m.hash_table, m.min_b, m.div,
               ev.inv_leaf, ev.offsets)
    _close(ndt_kernels.ndt_terms_gathered(*k1_args),
           ndt_kernels.ndt_terms_gathered_plain(*k1_args))
    assert ndt_kernels.LAUNCHES == {"ndt_terms_gathered": 1,
                                    "ndt_gather_repack": 1,
                                    "ndt_terms_packed": 1}
    with pytest.raises(TypeError):
        ndt_kernels.ndt_terms_packed(params.double(), ev.xyz.double(),
                                     stats.double())
    with pytest.raises(ValueError):  # more offsets than a warp's queue holds
        ndt_kernels.ndt_terms_packed(params, ev.xyz[:, :1].contiguous(),
                                     torch.zeros(10, 28, device=cuda))


@pytest.fixture(scope="module")
def ndt_scene(cuda, clouds):
    """The 1 m map of the first cloud and the second cloud, on the card."""
    cfg = ndt.NDTConfig(grid_capacity=1 << 15, map_capacity=8192)
    m = ndt.build_ndt_map(pointcloud.PointCloud(*(t.to(cuda)
                                                  for t in clouds[0])), cfg)
    return m, clouds[1].xyzi[:, :3].to(cuda), clouds[1].mask.to(cuda)


def _ndt_case(ndt_scene, search, shape="full"):
    """(K1 operands, K3 operands) at a pose 0.3 m off, for one shape."""
    m, xyz, mask = ndt_scene
    table = m.hash_table
    if shape == "n1":
        xyz, mask = xyz[:1], mask[:1]
    elif shape == "ragged_1000":  # neither a multiple of 32 nor of 128
        xyz, mask = xyz[:1000], mask[:1000]
    elif shape == "all_masked":
        mask = torch.zeros_like(mask)
    elif shape == "gates_shut":  # no row's valid flag is 1
        table = torch.zeros_like(table)
    d1, d2, _ = ndt.gauss_coefficients(1.0, 0.55)
    ev = ndt._Evaluator(m, xyz, mask, 1.0, ndt._OFFSETS[search], d1, d2)
    params = ev.params(np.array([0.3, 0.0, 0.0, 0.0, 0.0, 0.004],
                                np.float32))
    stats = ndt_kernels.ndt_gather_repack_plain(table,
                                                *ev.neighbor_hash(params))
    return ((params, ev.xyz, ev.mask, table, m.min_b, m.div, ev.inv_leaf,
             ev.offsets), (params, ev.xyz, stats))


def _k1_k3_match_plain(k1_args, k3_args, zero=False):
    for name, args in (("ndt_terms_gathered", k1_args),
                       ("ndt_terms_packed", k3_args)):
        got = getattr(ndt_kernels, name)(*args)
        again = getattr(ndt_kernels, name)(*args)
        want = getattr(ndt_kernels, name + "_plain")(*args)
        assert got.shape == (28,) and bool(torch.isfinite(got).all())
        _close(got, want)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        if zero:
            assert not bool(want.any()) and not bool(got.any())


NDT_SHAPES = ("full", "n1", "ragged_1000", "all_masked", "gates_shut")


@pytest.mark.parametrize("shape", NDT_SHAPES)
@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_ndt_sums_match_plain_on_card(cuda, ndt_scene, search, shape):
    """K1 and K3 against their plain versions, twice each (bit-identical)."""
    ndt_kernels.reset_launch_counts()
    _k1_k3_match_plain(*_ndt_case(ndt_scene, search, shape),
                       zero=shape in ("all_masked", "gates_shut"))
    assert ndt_kernels.LAUNCHES == {"ndt_terms_gathered": 2,
                                    "ndt_gather_repack": 0,
                                    "ndt_terms_packed": 2}


def test_ndt_sums_over_several_waves_on_card(cuda, ndt_scene):
    """More points than one wave of blocks holds (the wrapper's
    MAX_BLOCKS x THREADS): the grid-stride loop takes each thread round
    again. The cloud repeated until it spans more than one wave, its valid
    points in every copy."""
    m, xyz, mask = ndt_scene
    reps = -(-ndt_kernels.MAX_BLOCKS * ndt_kernels.THREADS // len(mask)) + 3
    k1_args, k3_args = _ndt_case((m, xyz.repeat(reps, 1), mask.repeat(reps)),
                                 "DIRECT7")
    assert k1_args[1].shape[1] > ndt_kernels.MAX_BLOCKS * ndt_kernels.THREADS
    _k1_k3_match_plain(k1_args, k3_args)


def test_ndt_sums_one_device_operation_a_call(cuda, ndt_scene):
    from torch.profiler import ProfilerActivity, profile

    k1_args, k3_args = _ndt_case(ndt_scene, "DIRECT7")
    for fn, args in ((ndt_kernels.ndt_terms_gathered, k1_args),
                     (ndt_kernels.ndt_terms_packed, k3_args)):
        fn(*args)  # the stream's counter is made (zeroed) at the first call
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        ops = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(c for _, c in ops) == 1, ops



@pytest.fixture(scope="module")
def lane_scene(cuda):
    """Four lanes on the card: the 1 m lane map of each lane's first
    downsampled scan (its own scene and grid) and its second scan, with
    per-lane poses and the frozen neighbourhoods of DIRECT7 there."""
    xs, ms = [], []
    for seed in (4, 6, 7, 9):
        x, m, _ = spinning_lidar_scans(seed, 2, 16, 1024)
        xs.append(x)
        ms.append(m)
    xyzi = torch.from_numpy(np.stack(xs)).to(cuda)
    mask = torch.from_numpy(np.stack(ms)).to(cuda)
    cfg = ndt.NDTConfig(map_capacity=8192)
    tgt = pointcloud.voxel_downsample_lanes(xyzi[:, 0], mask[:, 0], 0.3,
                                            8192, with_intensity=False)
    src = pointcloud.voxel_downsample_lanes(xyzi[:, 1], mask[:, 1], 0.3,
                                            8192, with_intensity=False)
    return ndt.build_ndt_map_lanes(tgt, cfg), src


def _lane_case(lane_scene, search, lanes):
    """K1 and K3 lane operands of ``lanes`` (an id a grid row, lanes of
    the 4-lane scene repeated up to 64 rows) and the single-lane operands
    of each row."""
    m, src = lane_scene
    B = src.mask.shape[0]
    d1, d2, _ = ndt.gauss_coefficients(1.0, 0.55)
    evs = [ndt._Evaluator(ndt.NDTMap(*(f[b] for f in m)), src.xyzi[b, :, :3],
                          src.mask[b], 1.0, ndt._OFFSETS[search], d1, d2)
           for b in range(B)]
    rows = []
    for y, b in enumerate(lanes):
        p = np.array([0.1 + 0.01 * y, -0.05, 0.0, 0.0, 0.0, 0.002 * b],
                     np.float32)
        rows.append(evs[b].params(p))
    params = torch.stack(rows)
    xyz = torch.stack([ev.xyz for ev in evs])
    stats = torch.stack([ndt_kernels.ndt_gather_repack_plain(
        m.hash_table[b], *evs[b].neighbor_hash(params[
            lanes.index(b)] if b in lanes else params[0]))
        for b in range(B)])
    ids = torch.tensor(lanes, dtype=torch.int32, device=params.device)
    k1 = (params, xyz, src.mask, m.hash_table, m.min_b, m.div, 1.0,
          evs[0].offsets, ids)
    k3 = (params, xyz, stats, ids)
    singles = [((params[y], xyz[b], src.mask[b], m.hash_table[b], m.min_b[b],
                 m.div[b], 1.0, evs[0].offsets), (params[y], xyz[b], stats[b]))
               for y, b in enumerate(lanes)]
    return k1, k3, singles


LANE_SETS = {"L1": [2], "L3": [3, 0, 2],
             "L64": [int(b) for b in np.random.default_rng(3).integers(0, 4,
                                                                        64)]}


@pytest.mark.parametrize("lanes", list(LANE_SETS))
@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_ndt_lane_kernels_equal_single_lane_on_card(cuda, lane_scene, search,
                                                    lanes):
    """Each grid row of a K1/K3 lane launch against the single-lane launch
    on its lane's inputs (bit for bit) and the plain version (rtol 1e-4);
    a rerun bit-identical."""
    k1, k3, singles = _lane_case(lane_scene, search, LANE_SETS[lanes])
    ndt_kernels.reset_launch_counts()
    got = {"ndt_terms_gathered": ndt_kernels.ndt_terms_gathered_lanes(*k1),
           "ndt_terms_packed": ndt_kernels.ndt_terms_packed_lanes(*k3)}
    L = len(LANE_SETS[lanes])
    assert ndt_kernels.LAUNCHES["ndt_terms_gathered"] == 1
    assert ndt_kernels.LANE_ROWS == {"ndt_terms_gathered": L,
                                     "ndt_terms_packed": L}
    again = {"ndt_terms_gathered": ndt_kernels.ndt_terms_gathered_lanes(*k1),
             "ndt_terms_packed": ndt_kernels.ndt_terms_packed_lanes(*k3)}
    for name, out in got.items():
        assert out.shape == (L, 28) and bool(torch.isfinite(out).all())
        assert torch.equal(out.view(torch.int32),
                           again[name].view(torch.int32))
        for y, (a1, a3) in enumerate(singles):
            args = a1 if name == "ndt_terms_gathered" else a3
            one = getattr(ndt_kernels, name)(*args)
            assert torch.equal(out[y].view(torch.int32),
                               one.view(torch.int32)), (name, y)
            _close(out[y], getattr(ndt_kernels, name + "_plain")(*args))


def test_ndt_lane_kernels_one_device_operation_a_launch(cuda, lane_scene):
    """A lane launch of K1 or K3 over 64 lanes is one device operation
    (the warm-up call grows the stream's counters to 64 lanes; the
    profiler session is primed, as a bare session can miss its first
    events)."""
    k1, k3, _ = _lane_case(lane_scene, "DIRECT7", LANE_SETS["L64"])
    for fn, args, kernel in (
            (ndt_kernels.ndt_terms_gathered_lanes, k1,
             "terms_gathered_kernel"),
            (ndt_kernels.ndt_terms_packed_lanes, k3, "terms_packed_kernel")):
        _one_device_operation(lambda f=fn, a=args: f(*a), kernel)


def test_fleet_fusion_four_lanes_equal_single_lanes_on_card(cuda):
    from toyslam_tpu_torch.pipelines import fusion

    xs, ms = [], []
    for seed in (4, 6, 7, 9):
        x, m, _ = spinning_lidar_scans(seed, 3, 16, 1024)
        xs.append(x)
        ms.append(m)
    scans = torch.from_numpy(np.stack(xs)).to(cuda)
    masks = torch.from_numpy(np.stack(ms)).to(cuda)
    T = 3 * 20
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(np.tile([0.0, 0.12, 9.81], (4, T, 1))
                           + 0.03 * rng.normal(size=(4, T, 3))).to(
        cuda, torch.float32)
    gyro = torch.from_numpy(np.tile([0.0, 0.0, 0.04], (4, T, 1))
                            + 0.002 * rng.normal(size=(4, T, 3))).to(
        cuda, torch.float32)
    dt = torch.full((4, T), 0.005, device=cuda)
    cfg = fusion.FusionConfig(odometry=odometry.OdometryConfig(
        work_capacity=8192))
    ndt_kernels.reset_launch_counts()
    fleet = fusion.fleet_fusion(scans, masks, acc, gyro, dt, cfg, chunk=4)
    assert ndt_kernels.LANE_ROWS["ndt_terms_packed"] > 0
    assert bool(fleet.converged.all())
    for b in range(4):
        one = fusion.ndt_eskf_fusion(scans[b], masks[b], acc[b], gyro[b],
                                     dt[b], cfg)
        assert torch.equal(fleet.poses[b], one.poses)
        assert torch.equal(fleet.odometry.evaluations[b],
                           one.odometry.evaluations)
        assert float((fleet.fused_p[b] - one.fused_p).abs().max()) < 1e-5


def _face_sources(T, xyz, leaf, n_base=256):
    """Points of the cloud moved so that their transforms lie within an ulp
    of voxel faces, each with every -1/0/+1 ulp combination per axis; and
    whether an FMA-contracted transform would put any in another voxel."""
    T = T.astype(np.float64)
    R, t = T[:3, :3], T[:3, 3]
    faces = np.round((xyz[:n_base] @ R.T + t) / leaf) * leaf
    base = ((faces - t) @ R).astype(np.float32)
    steps = np.array(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij")
                     ).reshape(3, -1).T
    pts = np.repeat(base, len(steps), 0)
    for a in range(3):
        s = np.tile(steps[:, a], n_base)
        pts[s < 0, a] = np.nextafter(pts[s < 0, a], np.float32(-np.inf))
        pts[s > 0, a] = np.nextafter(pts[s > 0, a], np.float32(np.inf))
    T32, inv = T.astype(np.float32), np.float32(1.0 / leaf)
    x, y, z = pts.T
    crossed = False
    for r in range(3):
        rounded = ((T32[r, 0] * x + T32[r, 1] * y) + T32[r, 2] * z) + T32[r, 3]
        inner = (np.float64(T32[r, 0]) * x + T32[r, 1] * y).astype(np.float32)
        fused = ((np.float64(T32[r, 2]) * z + inner).astype(np.float32)
                 + T32[r, 3])
        crossed |= bool((np.floor(rounded * inv)
                         != np.floor(fused * inv)).any())
    return pts, crossed


@pytest.mark.parametrize("leaf", [0.1, 1.0])
@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_neighbor_hash_on_card_matches_plain(cuda, clouds, search, leaf):
    """K1's hash (``neighbor_hash_kernel``, K1's device functions) against
    the plain hash on the card: the cloud with its 1e9 padding, and points
    within an ulp of voxel faces, where an FMA would pick another voxel."""
    cfg = ndt.NDTConfig(resolution=leaf, grid_capacity=1 << 16,
                        map_capacity=8192)
    m = ndt.build_ndt_map(pointcloud.PointCloud(*(t.to(cuda)
                                                  for t in clouds[0])), cfg)
    ev = ndt._Evaluator(m, clouds[1].xyzi[:, :3].to(cuda),
                        clouds[1].mask.to(cuda), leaf, ndt._OFFSETS[search],
                        0.0, 0.0)
    p = np.array([0.31, -0.17, 0.05, 0.02, -0.01, 0.3], np.float32)
    params = ev.params(p)
    T = params[2:14].cpu().numpy().reshape(3, 4)
    valid = clouds[1].mask.numpy()
    faces, crossed = _face_sources(T, clouds[1].xyzi[:, :3].numpy()[valid],
                                   leaf)
    assert crossed
    xyz = torch.cat([ev.xyz, torch.from_numpy(faces.T).to(cuda)], 1)
    mask = torch.cat([ev.mask, torch.ones(len(faces), dtype=torch.bool,
                                          device=cuda)])
    args = (params, xyz.contiguous(), mask, m.min_b, m.div,
            m.hash_table.shape[0], ev.inv_leaf, ev.offsets)
    h, nvid, okm = ndt_kernels.ndt_neighbor_hash(*args)
    ph, pnvid, pokm = ndt_kernels.ndt_neighbor_hash_plain(*args)
    assert torch.equal(okm, pokm)
    assert torch.equal(h[okm], ph[okm]) and torch.equal(nvid[okm], pnvid[okm])
    assert 0 < int(okm.sum()) < okm.numel()


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
        assert torch.equal(idx, pidx) and torch.equal(best, pbest)

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


PAD = pointcloud.PAD_COORD
K4_CASES = ("register_65k_1e9", "register_65k_1e30", "rows_1000",
            "cols_1000", "ragged_37x5", "wide_200m", "duplicates",
            "padded_rows", "sphere_origin", "all_sentinel_1e9",
            "all_sentinel_1e30", "register_65k_one_loose", "random_tsq")


@pytest.fixture(scope="module")
def register_65k(cuda):
    """The registration pair of ``chip_smoke.py``: two 32 x 2048-ray scans,
    the 0.1 m downsample, padded to 32768 points; the source moved by
    0.2 m / 0.01 rad so that no row sits on a target point."""
    xyzi, mask, _ = spinning_lidar_scans(1, 2, 32, 2048,
                                         fov_deg=(-30.67, 10.67))
    clouds = [pointcloud.pad_to(pointcloud.voxel_downsample(
        pointcloud.PointCloud(torch.from_numpy(xyzi[k]).to(cuda),
                              torch.from_numpy(mask[k]).to(cuda)), 0.1),
        32768) for k in range(2)]
    c, s = np.cos(0.01), np.sin(0.01)
    R = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=torch.float32,
                     device=cuda)
    src = (clouds[1].xyzi[:, :3] @ R.T + torch.tensor([0.2, -0.1, 0.05],
                                                       device=cuda))
    return src.contiguous(), clouds[0].xyzi[:, :3], clouds[0].mask


def _k4_case(name, cuda, register_65k):
    rng = np.random.default_rng(13)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    def ops(src, tgt, mask, sentinel=1e9):
        return (src.contiguous(),
                *nn_kernels.target_operands(tgt, mask, sentinel))

    ones = torch.ones(4096, dtype=torch.bool, device=cuda)
    if name == "register_65k_one_loose":
        # One valid column with tsq under |t|^2: the kernel must take the
        # general limit (S = sum |s_i| T_i) in place of the |s| R one.
        src, tgt_t, tsq = ops(*register_65k)
        tsq = tsq.clone()
        tsq[int(register_65k[2].nonzero()[7])] *= 0.5
        return src, tgt_t, tsq
    if name.startswith("register_65k"):
        return ops(*register_65k, 1e30 if name.endswith("1e30") else 1e9)
    if name == "random_tsq":  # tsq unrelated to |t|^2: the general limit
        src, tgt_t, _ = ops(f32(rng.uniform(-50, 50, (3000, 3))),
                            f32(rng.uniform(-50, 50, (4096, 3))), ones)
        return src, tgt_t, f32(rng.uniform(0, 1e4, 4096))
    if name == "rows_1000":
        src, tgt, mask = register_65k
        return ops(src[:1000], tgt, mask)
    if name == "cols_1000":
        src, tgt, mask = register_65k
        return ops(src, tgt[:1000], mask[:1000])
    if name == "ragged_37x5":
        return ops(f32(rng.uniform(-20, 20, (37, 3))),
                   f32(rng.uniform(-20, 20, (5, 3))),
                   torch.tensor([True, True, False, True, True],
                                device=cuda), 1e30)
    if name == "wide_200m":
        return ops(f32(rng.uniform(-200, 200, (3000, 3))),
                   f32(rng.uniform(-200, 200, (4096, 3))), ones)
    if name == "duplicates":  # exact ties: the first index must win
        base = f32(rng.uniform(-30, 30, (1024, 3)))
        return ops(base.clone(), base.repeat(4, 1), ones)
    if name == "padded_rows":
        src = f32(rng.uniform(-50, 50, (2000, 3)))
        src[::2] = PAD
        src[1::4] = -PAD
        return ops(src, f32(rng.uniform(-50, 50, (4096, 3))),
                   f32(rng.uniform(size=4096)) < 0.8)
    if name == "sphere_origin":
        v = rng.normal(size=(4096, 3))
        return ops(f32(rng.uniform(-1e-3, 1e-3, (1024, 3))),
                   f32(100.0 * v / np.linalg.norm(v, axis=1, keepdims=True)),
                   ones)
    src = f32(rng.uniform(-50, 50, (1000, 3)))
    src[::3] = PAD
    return ops(src, f32(rng.uniform(-50, 50, (4096, 3))), ~ones,
               1e30 if name.endswith("1e30") else 1e9)


@pytest.mark.parametrize("name", K4_CASES)
def test_nearest_neighbor_bit_identical_on_card(cuda, register_65k, name):
    """K4 against its plain version, both outputs, every row; the counts
    output changes nothing and counts at least the winning column."""
    src, tgt_t, tsq = _k4_case(name, cuda, register_65k)
    nn_kernels.reset_launch_counts()
    best, idx = nn_kernels.nearest_neighbor(src, tgt_t, tsq)
    cbest, cidx, counts = nn_kernels.nearest_neighbor(src, tgt_t, tsq,
                                                      counts=True)
    pbest, pidx = nn_kernels.nearest_neighbor_plain(src, tgt_t, tsq)
    assert torch.equal(idx, pidx), int((idx != pidx).sum())
    assert torch.equal(best.view(torch.int32), pbest.view(torch.int32))
    assert torch.equal(cidx, idx) and torch.equal(cbest, best)
    assert bool((counts >= 1).all())
    assert bool((counts <= tgt_t.shape[1]).all())
    if name.startswith("all_sentinel"):
        assert bool((idx == 0).all())
        assert bool((counts == tgt_t.shape[1]).all())
    assert nn_kernels.LAUNCHES["nearest_neighbor"] == 2


SPLIT_RTOL = 2.0 ** -16  # D1 split modes vs plain, of the largest |s.t|


@pytest.mark.parametrize("mode", ranking_kernels.MODES)
def test_split_dot_matches_plain_on_card(cuda, mode):
    rng = np.random.default_rng(5)
    ranking_kernels.reset_launch_counts()
    for n, m in ((1000, 3000), (37, 3001)):  # ragged; 3001: scalar stores
        s = torch.from_numpy(rng.uniform(-120, 120, (n, 3)).astype(
            np.float32)).to(cuda)
        t_t = torch.from_numpy(rng.uniform(-120, 120, (3, m)).astype(
            np.float32)).to(cuda)
        got = ranking_kernels.split_dot(s, t_t, mode)
        want = ranking_kernels.split_dot_plain(s, t_t, mode)
        assert got.shape == (n, m) and bool(torch.isfinite(got).all())
        if mode == "highest":
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= SPLIT_RTOL * scale
    assert ranking_kernels.LAUNCHES == {
        k: 2 if k == mode else 0 for k in ranking_kernels.MODES}


@pytest.mark.parametrize("case", ("wide_200m", "rows_1e9"))
def test_tensor_core_sum_within_the_k4_budget(cuda, case):
    """K4's margin assumes that the tensor core misses the exact sum of its
    bf16 products by at most 2^-17 of the sum of their magnitudes
    (``csrc/nn_kernels.cu``). D1's ``concat9`` is the same ``mma.sync``
    over the same x3 split: per entry it stays within 2^-18 of that sum,
    half the assumed error, at +-200 m and with source rows at the padding
    coordinate 1e9 (whole rows, and one axis only beside small ones)."""
    rng = np.random.default_rng(9)
    s = rng.uniform(-200, 200, (1024, 3))
    if case == "rows_1e9":
        s[::4] = PAD
        s[1::4, 0] = -PAD
    s = torch.from_numpy(s.astype(np.float32)).to(cuda)
    t_t = torch.from_numpy(rng.uniform(-200, 200, (3, 4096)).astype(
        np.float32)).to(cuda)
    got = ranking_kernels.split_dot(s, t_t, "concat9")
    ratio = ranking_kernels.sum_error(got, s, t_t, "concat9")
    assert float(ratio.max()) <= 2.0 ** -18, float(ratio.max())


def test_lane_row_sum_matches_plain_on_card(cuda):
    rng = np.random.default_rng(6)
    gather_kernels.reset_launch_counts()
    table = torch.from_numpy(rng.normal(size=(3, 1000, 16)).astype(
        np.float32)).to(cuda)
    for shape in ((3, 1001), (3, 7, 11)):
        ids = torch.from_numpy(rng.integers(-1100, 1100, size=shape).astype(
            np.int32)).to(cuda)
        got = gather_kernels.lane_row_sum(ids, table)
        want = gather_kernels.lane_row_sum_plain(ids, table)
        assert got.shape == shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert gather_kernels.LAUNCHES == {"lane_row_sum": 2}
    with pytest.raises(TypeError):
        gather_kernels.lane_row_sum(ids.long(), table)


def _one_device_operation(fn, kernel, calls=20):
    """fn() is one device operation, the kernel named ``kernel``: ``calls``
    calls under torch.profiler are ``calls`` launches of it and nothing
    else (``gicp_call_ops.profiled`` primes the session)."""
    prof = gicp_call_ops.profiled(fn, calls)
    assert prof["ops"] == calls, prof["by_name"]
    assert all(kernel in k for k in prof["by_name"]), prof["by_name"]


@pytest.mark.parametrize("n", [1, 255, 256, 257, 32768, 100003])
def test_gicp_terms_one_launch_on_card(cuda, n):
    """K6 on generated correspondences (SPD Mahalanobis, 30 % rejected)
    against its plain version, twice (bit-identical), one device operation
    a call."""
    rng = np.random.default_rng(n)
    xyz = rng.uniform(-20, 20, (3, n))
    q = xyz + rng.normal(0, 0.1, (3, n))
    L = rng.normal(size=(n, 3, 3))
    M = L @ L.transpose(0, 2, 1) + np.eye(3)
    m6 = M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T
    w = (rng.uniform(size=n) > 0.3).astype(np.float64)
    c, s_ = np.cos(0.1), np.sin(0.1)
    params = np.array([c, -s_, 0, s_, c, 0, 0, 0, 1, 0.3, -0.2, 0.1])
    args = [torch.tensor(a, dtype=torch.float32, device=cuda)
            for a in (params, xyz, q, m6, w)]
    gicp_kernels.reset_launch_counts()
    got = gicp_kernels.gicp_terms(*args)
    again = gicp_kernels.gicp_terms(*args)
    assert gicp_kernels.LAUNCHES == {"gicp_terms": 2}
    assert got.shape == (27,) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = gicp_kernels.gicp_terms_plain(*args).double().cpu()
    got = got.double().cpu()
    for sl in (slice(0, 6), slice(6, 12), slice(12, 21), slice(21, 27)):
        scale = want[sl].abs().max().clamp(min=1e-30)
        assert ((got[sl] - want[sl]).abs().max() / scale) <= 1e-4
    _one_device_operation(lambda: gicp_kernels.gicp_terms(*args),
                          "gicp_terms_kernel")


@pytest.mark.parametrize("lanes,cap,ids_shape", [
    (3, 1000, (1001,)),
    (2, 8193, (37, 13)),
    (1, 5, (300,)),
    (1, 8192, (458753,)),
    (2, 40000, (5, 999)),
])
def test_lane_row_sum_ragged_on_card(cuda, lanes, cap, ids_shape):
    """D2 at ragged shapes, bit-identical to its plain version, every id
    kind included: negative, past the end, and the int32 extremes; one
    device operation a call."""
    rng = np.random.default_rng(cap)
    table = torch.from_numpy(rng.normal(size=(lanes, cap, 16)).astype(
        np.float32)).to(cuda)
    ids = rng.integers(-cap - 50, cap + 50, size=(lanes, *ids_shape))
    ids.reshape(lanes, -1)[:, :4] = [-2**31, 2**31 - 1, -1, cap]
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    gather_kernels.reset_launch_counts()
    got = gather_kernels.lane_row_sum(ids, table)
    assert gather_kernels.LAUNCHES == {"lane_row_sum": 1}
    want = gather_kernels.lane_row_sum_plain(ids, table)
    assert got.shape == ids.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    _one_device_operation(lambda: gather_kernels.lane_row_sum(ids, table),
                          "lane_row_sum_kernel")


@pytest.fixture(scope="module")
def mapping_scans(cuda):
    xyzi, mask, _ = spinning_lidar_scans(2, 5, 32, 1024)
    return torch.from_numpy(xyzi).to(cuda), torch.from_numpy(mask).to(cuda)


def test_mapping_on_card_poses_equal_odometry(cuda, mapping_scans):
    """Mapping forces keep_intensity; its poses are odometry's bit for bit
    (the downsample sums each channel on its own), K2 and K3 launched."""
    xyzi, mask = mapping_scans
    cfg = odometry.OdometryConfig(work_capacity=8192)
    ndt_kernels.reset_launch_counts()
    out = odometry.ndt_mapping(xyzi, mask, 8192, cfg)
    assert ndt_kernels.LAUNCHES["ndt_gather_repack"] > 0
    assert ndt_kernels.LAUNCHES["ndt_terms_packed"] > 0
    odo = odometry.ndt_odometry(
        xyzi, mask, cfg._replace(keep_intensity=True))
    assert bool(out.odometry.converged.all())
    assert torch.equal(out.odometry.poses, odo.poses)
    assert out.map_xyzi.device.type == "cuda"
    assert 0 < int(out.map_mask.sum()) < 8192


def test_checkpoint_round_trip_on_card(cuda, mapping_scans, tmp_path):
    """A mapping state saved on the card comes back on the card with its
    dtypes (f32 clouds, bool masks, host f32 poses), and the resumed run
    is bit-identical to the run without a break."""
    xyzi, mask = mapping_scans
    cfg = odometry.OdometryConfig(work_capacity=8192)
    full = odometry.ndt_mapping(xyzi, mask, 8192, cfg)
    state = odometry.mapping_init(xyzi[0], mask[0], 8192, cfg)
    for i in (1, 2):
        state, _ = odometry.mapping_step(state, xyzi[i], mask[i], cfg)
    checkpoint.save_checkpoint(tmp_path / "s.npz", state)
    template = odometry.mapping_init(xyzi[0], mask[0], 8192, cfg)
    back = checkpoint.load_checkpoint(tmp_path / "s.npz", template)
    for got, want in zip(checkpoint._flatten(back),
                         checkpoint._flatten(state)):
        assert got[1].device == want[1].device
        assert got[1].dtype == want[1].dtype
        assert torch.equal(got[1], want[1])
    assert back.map_cloud.xyzi.device.type == "cuda"
    assert back.odometry.pose.device.type == "cpu"
    for i in range(3, xyzi.shape[0]):
        back, out = odometry.mapping_step(back, xyzi[i], mask[i], cfg)
        assert torch.equal(out[0], full.odometry.poses[i])
    assert torch.equal(back.map_cloud.xyzi, full.map_xyzi)
    assert torch.equal(back.map_cloud.mask, full.map_mask)


def _no_host_sync(fn):
    """fn() with PyTorch's sync debug mode raising on any synchronising
    call."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def test_fitness_score_k4_equals_plain_route_on_card(cuda, clouds):
    tgt, src = (pointcloud.PointCloud(*(t.to(cuda) for t in c))
                for c in clouds)
    T = torch.eye(4)
    T[0, 3], T[1, 3] = 0.3, -0.05
    nn_kernels.reset_launch_counts()
    got = ndt.fitness_score(src, tgt, T)
    assert nn_kernels.LAUNCHES["nearest_neighbor"] == 1
    with mock.patch.object(nn_kernels, "nearest_neighbor",
                           nn_kernels.nearest_neighbor_plain):
        want = ndt.fitness_score(src, tgt, T)
    assert got.is_cuda and float(got) > 0
    assert torch.equal(got, want)
    cut = ndt.fitness_score(src, tgt, T, max_range=0.2)
    assert float(cut) < float(got)


def _eskf_log(device, dtype, T=400):
    rng = np.random.default_rng(6)
    dt = np.full(T, 0.005)
    dt[[50, 200]] = 0.0
    acc = np.tile([0.05, 0.02, 9.81], (T, 1)) + 0.03 * rng.normal(size=(T, 3))
    gyro = np.tile([0.0, 0.0, 0.05], (T, 1)) + 0.002 * rng.normal(
        size=(T, 3))
    meas = 0.01 * rng.normal(size=(T, 3))
    valid = np.zeros(T, bool)
    valid[19::20] = True
    return eskf.ESKFLog(*(torch.from_numpy(a).to(device, dtype)
                          if a.dtype != bool else torch.from_numpy(a).to(
                              device) for a in (dt, acc, gyro, meas, valid)))


def test_eskf_run_no_host_sync_on_card(cuda):
    log = _eskf_log(cuda, torch.float32)
    params = eskf.ESKFParams(acc_noise=0.03, meas_noise=0.01)
    _, traj = _no_host_sync(lambda: eskf.eskf_run(log, None, params))
    _, ref = eskf.eskf_run(_eskf_log("cpu", torch.float64), None, params)
    assert traj["p"].is_cuda and traj["p"].shape == (400, 3)
    for k in ("p", "v", "q"):
        assert float((traj[k].double().cpu() - ref[k]).abs().max()) < 1e-4


def test_convert_eskf_state_defaults_to_card(cuda):
    fields = eskf.init_state(torch.float64, device="cpu")._asdict()
    state = convert.eskf_state(fields)
    assert all(x.is_cuda and x.dtype == torch.float64 for x in state)
    assert all(torch.equal(x.cpu(), fields[k])
               for k, x in state._asdict().items())


def test_solve_positions_batch_no_host_sync_on_card(cuda):
    rng = np.random.default_rng(9)
    theta = np.arange(8) * 2 * np.pi / 8
    anchors = np.stack([50 * np.cos(theta), 50 * np.sin(theta),
                        3.0 * (np.arange(8) % 4)], -1)
    pos = np.stack([30 * np.cos(0.01 * np.arange(600)),
                    30 * np.sin(0.01 * np.arange(600)), np.ones(600)], -1)
    ranges = np.linalg.norm(pos[:, None] - anchors[None], axis=-1)
    ranges += 0.3 * rng.normal(size=ranges.shape)
    cfg = trilateration.TrilaterationConfig(huber_delta=0.5)
    args = [torch.from_numpy(a) for a in (ranges, anchors,
                                          np.array([1.0, 0.0, 0.5]))]
    on_card = [a.to(cuda, torch.float32) for a in args]
    p, rms = _no_host_sync(
        lambda: trilateration.solve_positions_batch(*on_card, config=cfg))
    p64, _ = trilateration.solve_positions_batch(*args, config=cfg)
    assert p.is_cuda and p.shape == (600, 3) and bool(torch.isfinite(rms).all())
    assert float((p.double().cpu() - p64).abs().max()) < 1e-3


def test_loam_odometry_no_host_sync_on_card(cuda):
    """loam_odometry over 5 scans of the LOAM test world (16 x 360 rays)
    on the card in f32 makes no host synchronisation and lands within 1e-4
    m of the f64 run on the CPU (CPU f32 against f64: 8.6e-7 m over 6
    scans; a feature pick that flips between f32 and f64 moves a pose by
    more), with the same keyframes."""
    from toyslam_tpu_torch.pipelines import loam
    from toyslam_tpu_torch.sim import loam_world

    scans, poses = loam_world.drive(5, 3, step_dtype=np.float64)
    xyzi, mask = loam_world.pack(scans)
    cfg = loam.LoamConfig(n_rings=16, vertical_fov_deg=(-25.0, 5.0))
    x, m = torch.from_numpy(xyzi), torch.from_numpy(mask)
    xc, mc = x.to(cuda), m.to(cuda)
    out = _no_host_sync(lambda: loam.loam_odometry(xc, mc, cfg))
    ref = loam.loam_odometry(x.double(), m, cfg)
    assert out.positions.is_cuda
    assert float((out.positions.double().cpu() - ref.positions).abs()
                 .max()) < 1e-4
    assert int(out.n_keyframes) == int(ref.n_keyframes)
    assert float((ref.positions - torch.from_numpy(poses[:, :3, 3])).norm(
        dim=1).max()) < 0.3


def test_batch_fusion_on_card_matches_cpu(cuda):
    """batch_fusion over a 12-keyframe GPS log (window 6: 6
    marginalisations, an IMU gap, a divergence reset; the log of
    tests/test_torch_smoother.py) on the card in f32 against the f64 run
    on the CPU: positions within 5e-2 m (the card read 2.43e-2 m at the
    reset keyframe, the CPU's f32 2.1e-3 m), velocity median within
    tests/test_window.py's 5e-2; the same resets; its only host
    synchronisations are eigh's, one a marginalisation."""
    import warnings

    from toyslam_tpu_torch.estimators import preintegration, window
    from toyslam_tpu_torch.pipelines import batch_fusion

    rng = np.random.default_rng(2)
    M, R = 12, 20
    t = (torch.arange(M * R, dtype=torch.float64) + 1) / 200.0
    from toyslam_tpu_torch.sim import sensors, trajectories

    traj = trajectories.circle(t, radius=3.0, omega=0.4)
    acc, gyro = sensors.imu_from_noise(
        traj, torch.from_numpy(rng.normal(size=(M * R, 3))),
        torch.from_numpy(rng.normal(size=(M * R, 3))))
    kf = np.arange(R - 1, M * R, R)
    valid = torch.ones((M, R), dtype=torch.bool)
    valid[6] = False
    p = traj["pos"][kf] + 0.1 * torch.from_numpy(rng.normal(size=(M, 3)))
    p[9, 0] += 4.0
    ok = torch.ones(M, dtype=torch.bool)
    log = [acc.reshape(M, R, 3), gyro.reshape(M, R, 3),
           torch.full((M, R), 0.005, dtype=torch.float64), valid,
           t[kf], p, ok]
    vel = traj["vel"][kf] + 0.05 * torch.from_numpy(rng.normal(size=(M, 3)))
    cfg = batch_fusion.BatchFusionConfig(
        window=window.WindowConfig(
            window_size=6, gn_iterations=4, use_gps=True, gps_pos_sigma=0.1,
            gps_pos_z_sigma_factor=1.0, use_gps_velocity=True,
            gps_vel_sigma=0.05, simplified_first_n=3),
        preint=preintegration.PreintegrationParams(acc_noise=0.03,
                                                   gyro_noise=0.002),
        max_position_error=2.0)

    def card(a):
        return a.to(cuda, torch.float32) if a.is_floating_point() else a.to(
            cuda)

    args = [card(a) for a in log]
    vel_c, ok_c = card(vel), card(ok)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = batch_fusion.batch_fusion(*args, meas_v=vel_c,
                                            meas_v_valid=ok_c, config=cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)
             and "debug mode" not in str(w.message)]
    ref = batch_fusion.batch_fusion(*log, meas_v=vel, meas_v_valid=ok,
                                    config=cfg)
    assert len(syncs) == M - 6
    assert torch.equal(out.reset.cpu(), ref.reset) and bool(ref.reset[9])
    dp = (out.kf_p.double().cpu() - ref.kf_p).norm(dim=1)
    dv = (out.kf_v.double().cpu() - ref.kf_v).norm(dim=1)
    assert float(dp.max()) < 5e-2 and float(dv.median()) < 5e-2


def test_convert_smoother_state_defaults_to_card(cuda):
    from toyslam_tpu_torch.estimators import window

    win = window.window_init(window.WindowConfig(window_size=4),
                             torch.float64, "cpu")
    nav = convert.nav_state(window._state_at(win.states, 0)._asdict())
    assert all(x.is_cuda and x.dtype == torch.float64 for x in nav)
    fields = {k: getattr(win, k) for k in win._fields}
    moved = convert.sliding_window(fields)
    assert moved.count.is_cuda and moved.states.p.is_cuda
    assert moved.preints.covariance.is_cuda and moved.prior_state.q.is_cuda
    assert torch.equal(moved.preints.covariance.cpu(),
                       win.preints.covariance)


def test_gnss_local_solve_no_host_sync_on_card(cuda):
    from toyslam_tpu_torch.apps import gnss_demo
    from toyslam_tpu_torch.gnss import local, pipeline as gpipe

    cfg = gpipe.EpochConfig(apply_iono_correction=False)
    store, iono, ch, ref, _, gt = gnss_demo.simulate(64, 24, 1.5, 0, 1.5,
                                                     cuda)
    ep = local.prep_epochs(store, iono, *ch, ref, config=cfg)
    assert ep.y.is_cuda and ep.y.dtype == torch.float32
    sol = _no_host_sync(lambda: local.solve_epochs_local(ep, cfg))
    again = local.solve_epochs_local(ep, cfg)
    assert all(torch.equal(a, b) for a, b in zip(sol, again))
    cpu = [c.cpu() for c in ch]
    ref64 = local.solve_epochs_local(local.prep_epochs(
        gpipe.EphemerisStore(gpipe.GpsEphemeris(*(x.cpu()
                                                  for x in store.eph))),
        iono._replace(alpha=iono.alpha.cpu(), beta=iono.beta.cpu()), *cpu,
        ref.cpu(), config=cfg, out_dtype=torch.float64), cfg)
    # the card's f32 within 2e-3 m of the host's f64 (0.26 mm at gnss-1024
    # in the smoke run), every epoch valid, the same satellites
    assert bool(sol.valid.all()) and bool(sol.vel_valid.all())
    assert float((sol.delta.double().cpu() - ref64.delta).norm(dim=1).max()) \
        < 2e-3
    assert torch.equal(sol.num_sats.cpu(), ref64.num_sats)
    assert float((sol.delta.double() + ref - gt).norm(dim=1).max()) < 10.0


def test_raim_and_urban_on_card_match_host(cuda):
    from toyslam_tpu_torch.core.geodesy import lla_to_ecef
    from toyslam_tpu_torch.gnss import pipeline as gpipe, raim
    from toyslam_tpu_torch.sim import gps, urban

    rec = lla_to_ecef(*(torch.tensor(v, dtype=torch.float64)
                        for v in (0.3896, 1.995, 50.0)))
    init = torch.cat([rec + 30.0, rec.new_zeros(1)])
    out = {}
    for dev in ("cpu", cuda):
        sim = gps.simulate_constellation(
            torch.Generator().manual_seed(3), rec.to(dev),
            gps.GpsSimConfig(n_sats=8), fault_index=-1, batch=(32,))
        valid = torch.ones((32, 8), dtype=torch.bool, device=dev)
        det = raim.raim_detect(sim["sat_pos"], sim["pseudoranges"], valid,
                               init.to(dev))
        excl = raim.fault_exclusion(sim["sat_pos"], sim["pseudoranges"],
                                    valid, init.to(dev))
        city = urban.make_city(torch.Generator().manual_seed(4), device=dev)
        drive = urban.simulate_urban_epochs(
            torch.Generator().manual_seed(5),
            torch.zeros((8, 3), dtype=torch.float64, device=dev),
            1000.0 + torch.arange(8, dtype=torch.float64, device=dev),
            gpipe.synthetic_constellation(24, toe=1000.0, device=dev), city,
            torch.tensor([0.39, 1.99, 50.0], dtype=torch.float64,
                         device=dev))
        out[str(dev)] = (det, excl, drive)
    (d0, e0, u0), (d1, e1, u1) = out["cpu"], out[str(cuda)]
    assert d1.state.is_cuda and u1["pseudoranges"].is_cuda
    # f64 on both: the same draws (a CPU generator), sums in other orders
    assert float((d1.state.cpu() - d0.state).abs().max()) < 1e-6
    assert torch.equal(d1.fault_detected.cpu(), d0.fault_detected)
    assert torch.equal(e1[0].cpu(), e0[0])
    for k in ("blocked", "multipath", "usable"):
        assert torch.equal(getattr(u1["budget"], k).cpu(),
                           getattr(u0["budget"], k))
    ok = u0["budget"].usable
    assert float((u1["pseudoranges"].cpu() - u0["pseudoranges"])[ok]
                 .abs().max()) < 1e-6


def test_convert_gnss_defaults_to_card(cuda):
    from toyslam_tpu_torch.gnss import pipeline as gpipe

    eph = gpipe.synthetic_constellation(4, device="cpu")
    moved = convert.ephemeris(eph._asdict())
    assert all(x.is_cuda for x in moved)
    assert moved.sat.dtype == torch.int32
    store = convert.ephemeris_store({"eph": eph._asdict()})
    assert store.eph.toe_sec.is_cuda
    assert gpipe.store_init().eph.sat.is_cuda


@pytest.mark.parametrize("prefetch", [1, 3])
def test_scan_stream_on_card_equals_stack(cuda, tmp_path, prefetch):
    """``runtime/loader.ScanStream`` on the card (pinned ring, copies on a
    side stream, an event the consumer waits on, ``record_stream``): every
    scan equal to the packed stack's row bit for bit, with the consumer on
    a stream of its own and spinning before each read, so that the
    producer runs ahead and reuses its pinned buffers, and each scan's
    tensors dropped before the next arrives."""
    from toyslam_tpu_torch.core import pcd_io
    from toyslam_tpu_torch.runtime import loader

    xyzi, mask, _ = spinning_lidar_scans(0, 12, 16, 1024)
    paths = []
    for k in range(len(xyzi)):
        paths.append(tmp_path / f"cloud_{k}.pcd")
        pcd_io.write_pcd(paths[-1], xyzi[k][mask[k]])
    cap = xyzi.shape[1]
    stack_x, stack_m = loader.load_scan_stack(paths, cap)
    consumer = torch.cuda.Stream(cuda)
    sums = []
    with torch.cuda.stream(consumer):
        stream = loader.ScanStream(paths, cap, device=cuda, prefetch=prefetch)
        for k, (x, m) in enumerate(stream):
            assert x.is_cuda and m.is_cuda and m.dtype == torch.bool
            torch.cuda._sleep(2_000_000)  # ~1 ms of the card before reading
            want_x = torch.from_numpy(stack_x[k]).to(cuda, non_blocking=False)
            want_m = torch.from_numpy(stack_m[k]).to(cuda)
            sums.append(((x.view(torch.int32) != want_x.view(torch.int32))
                         .sum() + (m != want_m).sum()))
            del x, m
    consumer.synchronize()
    assert len(sums) == len(paths)
    assert int(torch.stack(sums).sum()) == 0
    assert stream.wait_s >= 0.0
