"""K1-K3 of the PyTorch port against the JAX Pallas kernels.

The port's plain versions (``toyslam_tpu_torch/ops/ndt_kernels.py``) run
on the same numpy-made inputs as ``ops/ndt_pallas.ndt_terms_raw``,
``ndt_terms`` and ``ndt_repack`` in interpret mode, as
``tests/test_ndt.py:218-295`` runs them against the jnp path. Bounds are
those of that test (f32, summation order differs): score rtol 1e-5,
gradient rtol 1e-4 / atol 1e-5, Hessian rtol 1e-4 / atol 1e-4; the
repack does no arithmetic and must be bit-identical. The CUDA kernels
themselves are held against these plain versions on the card by
``test_torch_gpu.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud  # noqa: E402
from toyslam_tpu.ops import ndt_pallas  # noqa: E402
from toyslam_tpu.registration import ndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.ops import ndt_kernels  # noqa: E402
from toyslam_tpu_torch.registration import ndt as tndt  # noqa: E402

N_SRC = 1024  # the Pallas kernels take N % 1024 == 0
OFFS = ndt._OFFSETS["DIRECT7"]
RES = 2.0


def _scene(rng, n):
    """Floor + two walls + noise, f64 (as tests/test_ndt.py builds it)."""
    floor = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                      0.05 * rng.normal(size=n)], 1)
    wall1 = np.stack([rng.uniform(-20, 20, n // 2),
                      8.0 + 0.05 * rng.normal(size=n // 2),
                      rng.uniform(0, 5, n // 2)], 1)
    wall2 = np.stack([-12.0 + 0.05 * rng.normal(size=n // 2),
                      rng.uniform(-20, 20, n // 2),
                      rng.uniform(0, 5, n // 2)], 1)
    return np.concatenate([floor, wall1, wall2], 0)


@pytest.fixture(scope="module")
def case():
    """One JAX f32 map, a source cloud with masked lanes, a pose, and the
    kernel inputs of both packages built from them."""
    rng = np.random.default_rng(7)
    pts = _scene(rng, 700)
    cfg = ndt.NDTConfig(resolution=2.0, map_capacity=2048,
                        grid_capacity=1 << 14)
    m = jax.jit(ndt.build_ndt_map, static_argnums=1)(
        pointcloud.from_numpy(pts, capacity=2048, dtype=jnp.float32), cfg)
    src = (np.tile(pts, (2, 1))[:N_SRC] + 0.1).astype(np.float32)
    mask = np.arange(N_SRC) % 13 != 0
    p = np.array([0.05, -0.1, 0.08, 0.02, -0.03, 0.05], np.float32)
    d1, d2, _ = ndt.gauss_coefficients(2.0, 0.55, jnp.float32)

    # JAX side: exactly the operands compute_derivatives hands its kernels.
    src_j, mask_j, p_j = jnp.asarray(src), jnp.asarray(mask), jnp.asarray(p)
    K = len(OFFS)

    @jax.jit
    def operands(m, src_j, mask_j, p_j):
        T = ndt.se3.pose6_to_matrix(p_j)
        j_tab, h_tab = ndt._angle_tables(p_j, jnp.float32)
        params = jnp.concatenate([jnp.stack([d1, d2]), T[:3, :].reshape(-1),
                                  j_tab.reshape(-1), h_tab.reshape(-1)])
        h, nvid, ok = ndt._neighbor_hash(m, src_j, p_j, 2.0, OFFS)
        aux = ndt._aux_channels(nvid, ok, mask_j, N_SRC, K, jnp.float32)
        return params, h, nvid, ok, aux, m.hash_table[h]

    params, h, nvid, ok, aux, raw = operands(m, src_j, mask_j, p_j)
    xyz3 = src_j.T.reshape(3, N_SRC // 128, 128)

    okm = np.asarray(ok) & np.tile(mask, K)
    port = dict(
        params=torch.tensor(np.asarray(params)),
        xyz=torch.from_numpy(np.ascontiguousarray(src.T)),
        mask=torch.from_numpy(mask),
        table=torch.tensor(np.asarray(m.hash_table)),
        min_b=torch.tensor(np.asarray(m.min_b, np.int32)),
        div=torch.tensor(np.asarray(m.div, np.int32)),
        offsets=torch.tensor(OFFS, dtype=torch.int32),
        h=torch.tensor(np.asarray(h, np.int32)),
        nvid=torch.tensor(np.asarray(nvid, np.int32)),
        okm=torch.from_numpy(okm),
    )
    return dict(m=m, src=src, mask=mask, p=p, params=params, xyz3=xyz3,
                aux=aux, raw=raw, port=port, K=K, h=h, nvid=nvid, ok=ok)


def _assert_terms(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:7], want[1:7], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[7:], want[7:], rtol=1e-4, atol=1e-4)


def test_neighbor_hash_matches_jax(case):
    """The plain-torch hash that feeds K1/K2 gives the JAX slots exactly:
    the one-lane hash, and the lane hash on the NDT evaluator's operands
    at one lane (whose rows start at 0), as its gather runs it."""
    tm = convert.ndt_map({k: np.asarray(v)
                          for k, v in case["m"]._asdict().items()},
                         device="cpu")
    ev = tndt._single_lane(tm, torch.from_numpy(case["src"]),
                           torch.from_numpy(case["mask"]), 2.0, OFFS, 0, 0)
    params = case["port"]["params"]
    one = ndt_kernels.ndt_neighbor_hash_plain(
        params, ev.xyz[0], ev.mask[0], tm.min_b, tm.div, ev.cap, ev.inv_leaf,
        ev.offsets)
    lane = ndt_kernels.ndt_neighbor_hash_lanes_plain(
        params[None], ev.xyz, ev.mask, ev.map.min_b, ev.map.div, ev.cap,
        ev.inv_leaf, ev.offsets, ev.row0)
    for h, nvid, okm in (one, (t[0] for t in lane)):
        np.testing.assert_array_equal(h.numpy(), np.asarray(case["h"]))
        np.testing.assert_array_equal(nvid.numpy(), np.asarray(case["nvid"]))
        np.testing.assert_array_equal(okm.numpy(),
                                      case["port"]["okm"].numpy())


def _k1_args(q):
    """K1's operands: the hash is K1's own, from the map's grid."""
    return (q["params"], q["xyz"], q["mask"], q["table"], q["min_b"],
            q["div"], 1.0 / RES, q["offsets"])


def test_k1_plain_matches_pallas_raw(case):
    """K1's plain version (its own hash included) against the Pallas kernel
    fed by JAX's ``_neighbor_hash``."""
    want = ndt_pallas.ndt_terms_raw(case["params"].reshape(1, 83),
                                    case["xyz3"], case["aux"], case["raw"],
                                    interpret=True)
    got = ndt_kernels.ndt_terms_gathered_plain(*_k1_args(case["port"]))
    _assert_terms(got.numpy(), want)


def test_k2_plain_bit_identical_to_pallas_repack(case):
    want = ndt_pallas.ndt_repack(case["aux"], case["raw"], interpret=True)
    q = case["port"]
    got = ndt_kernels.ndt_gather_repack_plain(q["table"], q["h"], q["nvid"],
                                              q["okm"])
    want = np.asarray(want).reshape(10, -1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert 0 < want[9].sum() < want.shape[1]  # the gate is exercised


def test_k3_plain_matches_pallas_packed(case):
    stats10 = ndt_pallas.ndt_repack(case["aux"], case["raw"], interpret=True)
    want = ndt_pallas.ndt_terms(case["params"].reshape(1, 83), case["xyz3"],
                                stats10, interpret=True)
    q = case["port"]
    got = ndt_kernels.ndt_terms_packed_plain(
        q["params"], q["xyz"], torch.tensor(np.asarray(stats10)
                                            ).reshape(10, -1))
    _assert_terms(got.numpy(), want)


def test_wrappers_take_cpu_tensors_to_plain(case):
    """On CPU tensors each wrapper is its plain version and launches
    nothing; a device with no kernel raises instead of falling back."""
    q = case["port"]
    ndt_kernels.reset_launch_counts()
    stats = ndt_kernels.ndt_gather_repack(q["table"], q["h"], q["nvid"],
                                          q["okm"])
    assert torch.equal(stats, ndt_kernels.ndt_gather_repack_plain(
        q["table"], q["h"], q["nvid"], q["okm"]))
    assert torch.equal(
        ndt_kernels.ndt_terms_packed(q["params"], q["xyz"], stats),
        ndt_kernels.ndt_terms_packed_plain(q["params"], q["xyz"], stats))
    assert torch.equal(
        ndt_kernels.ndt_terms_gathered(*_k1_args(q)),
        ndt_kernels.ndt_terms_gathered_plain(*_k1_args(q)))
    # The lane wrappers without lane ids: every lane in order.
    assert torch.equal(
        ndt_kernels.ndt_terms_packed_lanes(q["params"][None], q["xyz"][None],
                                           stats[None], None)[0],
        ndt_kernels.ndt_terms_packed_plain(q["params"], q["xyz"], stats))
    assert torch.equal(
        ndt_kernels.ndt_terms_gathered_lanes(
            *(a[None] for a in _k1_args(q)[:6]), 1.0 / RES, q["offsets"],
            None)[0],
        ndt_kernels.ndt_terms_gathered_plain(*_k1_args(q)))
    assert set(ndt_kernels.LAUNCHES.values()) == {0}
    meta = {k: v.to("meta") for k, v in q.items()}
    with pytest.raises(ValueError, match="no NDT kernel"):
        ndt_kernels.ndt_terms_packed(meta["params"], meta["xyz"],
                                     stats.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        ndt_kernels.ndt_terms_packed(q["params"], meta["xyz"], stats)


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_hash(m, src, p, offs):
    """JAX's hash and the transform it uses, from one program."""
    T = ndt.se3.pose6_to_matrix(p)
    return (T,) + ndt._neighbor_hash(m, src, p, RES, offs)


def _face_points(rng, m, T, n_base=48):
    """Source points whose transforms lie on voxel faces of the map's grid
    (exactly under a translation, within an ulp under a rotation), each
    with every combination of -1, 0 and +1 ulp per axis."""
    lo = np.asarray(m.min_b, np.int64)
    hi = lo + np.asarray(m.div, np.int64)
    faces = RES * rng.integers(lo, hi, size=(n_base, 3)).astype(np.float64)
    R, t = T[:3, :3].astype(np.float64), T[:3, 3].astype(np.float64)
    base = ((faces - t) @ R).astype(np.float32)  # R^T (f - t)
    steps = np.array(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij")
                     ).reshape(3, -1).T
    pts = np.repeat(base, len(steps), 0)
    for a in range(3):
        s = np.tile(steps[:, a], n_base)
        pts[s < 0, a] = np.nextafter(pts[s < 0, a], np.float32(-np.inf))
        pts[s > 0, a] = np.nextafter(pts[s > 0, a], np.float32(np.inf))
    return pts


def _plain_hash(case, T, src, mask, offs):
    m = case["m"]
    params = torch.zeros(83)
    params[2:14] = torch.tensor(np.asarray(T)[:3].ravel())
    return ndt_kernels.ndt_neighbor_hash_plain(
        params, torch.from_numpy(np.ascontiguousarray(src.T)),
        torch.from_numpy(mask), torch.tensor(np.asarray(m.min_b, np.int32)),
        torch.tensor(np.asarray(m.div, np.int32)), m.hash_table.shape[0],
        1.0 / RES, torch.tensor(offs, dtype=torch.int32))


def _face_case(case, p):
    """Face points for pose p (1e9 padding on every 50th, masked like every
    7th from the 4th), JAX's transform of the pose."""
    T0 = np.asarray(jax.jit(ndt.se3.pose6_to_matrix)(jnp.asarray(p)))
    src = _face_points(np.random.default_rng(11), case["m"], T0)
    src[::50] = pointcloud.PAD_COORD
    mask = np.ones(len(src), bool)
    mask[::50] = False
    mask[3::7] = False
    return src, mask


@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_plain_hash_on_voxel_faces_matches_jax(case, search):
    """Source points whose transforms lie exactly on voxel faces (a pure
    translation) and one ulp either side: the plain hash, which K1 repeats
    bit for bit, gives JAX's slots and ids where the mask flag holds, and
    the same flag everywhere, padded points at 1e9 included."""
    p = np.array([0.25, -0.5, 0.125, 0.0, 0.0, 0.0], np.float32)
    src, mask = _face_case(case, p)
    offs = tuple(ndt._OFFSETS[search])
    T, h, nvid, ok = _jax_hash(case["m"], jnp.asarray(src), jnp.asarray(p),
                               offs)
    okm = np.asarray(ok) & np.tile(mask, len(offs))
    got = _plain_hash(case, T, src, mask, offs)
    np.testing.assert_array_equal(got[2].numpy(), okm)
    np.testing.assert_array_equal(got[0].numpy()[okm], np.asarray(h)[okm])
    np.testing.assert_array_equal(got[1].numpy()[okm], np.asarray(nvid)[okm])
    # The faces are crossed: the 27 variants of a base point land in more
    # than one voxel for most base points.
    vid0 = np.asarray(nvid)[:len(src)].reshape(-1, 27)
    assert (vid0.min(1) != vid0.max(1)).mean() > 0.5
    assert 0 < okm.sum() < okm.size


def _numpy_cells(T, src, contract):
    """floor(t / RES) of each point, t = ((T0 x + T1 y) + T2 z) + T3 in
    float32, rounded one operation at a time, or with XLA's CPU contraction
    fma(T2, z, fma(T0, x, T1 y)) + T3 (the FMAs exact in float64)."""
    T = T.astype(np.float32)
    x, y, z = src.T
    cells = []
    for r in range(3):
        if contract:
            f64 = np.float64
            inner = (f64(T[r, 0]) * x + (T[r, 1] * y)).astype(np.float32)
            t = (f64(T[r, 2]) * z + inner).astype(np.float32) + T[r, 3]
        else:
            t = ((T[r, 0] * x + T[r, 1] * y) + T[r, 2] * z) + T[r, 3]
        cells.append(np.floor(t * np.float32(1.0 / RES)))
    return np.stack(cells, 1).astype(np.int64)


@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_plain_hash_rounds_each_operation(case, search):
    """Under a rotation the transforms land within an ulp of the faces, so
    the rounding order picks the voxel. The plain hash (and so K1) rounds
    each operation in the order above, as eager torch does. JAX on the CPU
    contracts two FMAs and picks another voxel for a few of these points:
    they are held against a numpy reckoning of that order, and the
    contracted order must differ somewhere, or the data could not tell."""
    m = case["m"]
    p = np.array([0.3, -0.2, 0.1, 0.02, -0.03, 0.05], np.float32)
    src, mask = _face_case(case, p)
    T = np.asarray(jax.jit(ndt.se3.pose6_to_matrix)(jnp.asarray(p)))
    offs = ndt._OFFSETS[search]
    h, nvid, okm = (t.numpy() for t in _plain_hash(case, T, src, mask, offs))
    cells = _numpy_cells(T, src, contract=False)
    min_b, div = np.asarray(m.min_b, np.int64), np.asarray(m.div, np.int64)
    cap = m.hash_table.shape[0]
    for k, off in enumerate(offs):
        n = cells - min_b + np.asarray(off)
        in_b = ((n >= 0) & (n < div)).all(1)
        vid = n[:, 0] + n[:, 1] * div[0] + n[:, 2] * div[0] * div[1]
        want_okm = in_b & mask
        sl = slice(k * len(src), (k + 1) * len(src))
        np.testing.assert_array_equal(okm[sl], want_okm)
        np.testing.assert_array_equal(nvid[sl][want_okm], vid[want_okm])
        np.testing.assert_array_equal(h[sl][want_okm],
                                      vid[want_okm] & (cap - 1))
    fused = _numpy_cells(T, src, contract=True)
    assert (fused != cells).any(1)[mask].sum() > 0


TERMS_RTOL = 1e-4  # K1/K3 sums, relative to the largest of their group


def _block_sum(v, threads):
    """[28, B * threads] -> [28, B]: the warp trees of grid_sum
    (``csrc/block_sum.cuh``), lanes (l, l + 16), (l, l + 8), ..., then the
    warps added in order."""
    v = v.reshape(v.shape[0], -1, threads // 32, 32)
    for w in (16, 8, 4, 2, 1):
        v = v[..., :w] + v[..., w:2 * w]
    s = v[..., 0, 0]
    for w in range(1, threads // 32):
        s = s + v[..., w, 0]
    return s


def _kernel_order_sum(terms, gate):
    """[28, K, N] float32 per-pair terms, [K, N] open gates -> [28], added
    in the order of K1 and K3 (``csrc/ndt_kernels.cu``): group g of
    32 / LANES points goes to warp g % warps, whose lane l tests the gates
    of point l // LANES at offsets k = l % LANES, + LANES, ...; the warp
    lists its open pairs lane by lane, offsets in order, and entry j goes
    to lane j % 32, which adds it to its running sums. Then the block sums,
    and the last block's threads add the block rows b = j, j + THREADS, ...
    before one more block sum."""
    n_terms, K, N = terms.shape
    threads, lanes = ndt_kernels.THREADS, ndt_kernels.LANES
    blocks = ndt_kernels._blocks(N)
    warps = blocks * threads // 32
    per_warp = 32 // lanes
    lane_point = np.arange(32) // lanes
    lane_offsets = np.arange(K)[None, :] % lanes == (np.arange(32) % lanes)[:, None]
    count = np.zeros(blocks * threads, np.int64)
    thread, rank, ks, ps = [], [], [], []
    for g in range(-(-N // per_warp)):
        pts = g * per_warp + lane_point
        tested = np.zeros((32, K), bool)
        tested[pts < N] = gate[:, pts[pts < N]].T
        lane, k = np.nonzero(tested & lane_offsets)
        j = np.arange(len(lane))
        t = (g % warps) * 32 + j % 32
        thread.append(t)
        rank.append(count[t] + j // 32)
        ks.append(k)
        ps.append(pts[lane])
        np.add.at(count, t, 1)
    thread, rank, ks, ps = map(np.concatenate, (thread, rank, ks, ps))
    acc = np.zeros((n_terms, blocks * threads), np.float32)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        acc[:, thread[sel]] += terms[:, ks[sel], ps[sel]]
    partials = _block_sum(acc, threads)
    final = np.zeros((n_terms, threads), np.float32)
    for b0 in range(0, blocks, threads):
        b = b0 + np.arange(threads)
        sel = b < blocks
        final[:, sel] += partials[:, b[sel]]
    return _block_sum(final, threads)[:, 0]


@pytest.mark.parametrize("n_points", [1024, 16384, 65536, 131072])
def test_kernel_sum_order_within_terms_rtol(case, n_points):
    """The f32 sum in K1's and K3's order (per thread over the pairs its
    warp hands it, warp trees, warps, blocks) stays within TERMS_RTOL of the
    f64 sum of the f64 terms: the case's 1024 points, alone and repeated to
    the odometry and exact-align sizes and to where the grid-stride loop
    takes threads round again."""
    q = case["port"]
    stats = ndt_kernels.ndt_gather_repack_plain(q["table"], q["h"],
                                                q["nvid"], q["okm"])
    t32 = ndt_kernels.ndt_pair_terms_plain(q["params"], q["xyz"], stats)
    t64 = ndt_kernels.ndt_pair_terms_plain(q["params"].double(),
                                           q["xyz"].double(), stats.double())
    K, reps = case["K"], n_points // N_SRC

    def tile(a):
        return np.tile(a.reshape(-1, K, N_SRC), (1, 1, reps))

    gate = tile(stats[9].numpy() > 0.5)[0]
    got = _kernel_order_sum(tile(t32.numpy()), gate).astype(np.float64)
    want = tile(t64.numpy()).sum((1, 2))
    assert 0 < gate.mean() < 1
    for sl in (slice(0, 1), slice(1, 7), slice(7, 28)):
        rel = np.abs(got[sl] - want[sl]).max() / np.abs(want[sl]).max()
        assert rel <= TERMS_RTOL, (sl, rel)
