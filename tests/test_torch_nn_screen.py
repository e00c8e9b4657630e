"""K4's tensor-core screen and its candidate limit, emulated on the CPU.

The kernel (``csrc/nn_kernels.cu``) ranks every pair by an ``x3`` bf16
split product and rescores in exact f32 only the columns whose screen is
within ``nn_kernels.screen_limit`` of the row's screen minimum. It is
bit-identical to ``nearest_neighbor_plain`` if and only if (a) the screen
misses the plain value by at most the budget E_c of the note at the head of
the kernel source and (b) the limit then keeps every column of the plain
minimum. Here ``nn_kernels.screen_plain`` emulates the screen (bf16 casts,
exact products in f64, the sum rounded to f32 once), and every case
asserts, per pair, |screen - plain| <= E_c / 2 (the budget keeps 2x of
slack), that the rescored set holds every column that reaches the plain
minimum, also for the worst screen that the budget allows, and that the
two-pass pick equals the plain version bit for bit.
The cases are the traps of the proof: padded source rows at 1e9, sentinel
target columns at 1e9 and 1e30, a target of sentinels only, exact ties,
coordinates out to +-200 m, near-ties in |t|^2 seen from the origin,
ragged shapes, and a generated scan pair.
The kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.ops import nn_pallas  # noqa: E402
from toyslam_tpu_torch.core import pointcloud  # noqa: E402
from toyslam_tpu_torch.ops import nn_kernels  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402

PAD = pointcloud.PAD_COORD


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _scan_pair():
    """1024 source rows (the last 160 padded at 1e9) and 4096 target
    columns (the last 512 sentinels) from two generated scans."""
    xyzi, mask, _ = spinning_lidar_scans(3, 2, 16, 512)
    clouds = [pointcloud.voxel_downsample(pointcloud.PointCloud(
        torch.from_numpy(xyzi[k]), torch.from_numpy(mask[k])), 0.3, 8192,
        with_intensity=False) for k in range(2)]
    tgt = clouds[0].xyzi[clouds[0].mask, :3][:3584]
    src = clouds[1].xyzi[clouds[1].mask, :3][:864]
    src = torch.cat([src, torch.full((1024 - src.shape[0], 3), PAD)])
    mask = torch.zeros(4096, dtype=torch.bool)
    mask[:tgt.shape[0]] = True
    tgt = torch.cat([tgt, torch.zeros(4096 - tgt.shape[0], 3)])
    return src.contiguous(), tgt, mask


def _case(name):
    rng = np.random.default_rng(11)
    if name == "scan_pair_1e9":
        src, tgt, mask = _scan_pair()
        return (src, *nn_kernels.target_operands(tgt, mask, 1e9))
    if name == "scan_pair_1e30":
        src, tgt, mask = _scan_pair()
        return (src, *nn_kernels.target_operands(tgt, mask, 1e30))
    if name == "wide_200m":
        src = _f32(rng.uniform(-200, 200, (1024, 3)))
        tgt = _f32(rng.uniform(-200, 200, (4096, 3)))
        return (src, *nn_kernels.target_operands(
            tgt, torch.ones(4096, dtype=torch.bool), 1e9))
    if name == "duplicates":
        # Every target point four times over; the source is the target
        # itself, so every row ties exactly on four columns or more.
        base = _f32(rng.uniform(-30, 30, (1024, 3)))
        tgt = base.repeat(4, 1)
        return (base.clone(), *nn_kernels.target_operands(
            tgt, torch.ones(4096, dtype=torch.bool), 1e9))
    if name == "padded_rows":
        # Half the rows at PAD_COORD; their sentinel-side pick is real: the
        # valid points lie behind the 1e9 sentinel for some of them.
        src = _f32(rng.uniform(-50, 50, (1024, 3)))
        src[::2] = PAD
        src[1::4] = -PAD
        tgt = _f32(rng.uniform(-50, 50, (4096, 3)))
        mask = torch.from_numpy(rng.uniform(size=4096) < 0.8)
        return (src, *nn_kernels.target_operands(tgt, mask, 1e9))
    if name == "sphere_origin":
        # Rows near the origin against a target on a 100 m sphere: |t|^2
        # nearly ties everywhere and S is tiny, so the |tsq|-relative part
        # of the budget is the one that binds.
        src = _f32(rng.uniform(-1e-3, 1e-3, (1024, 3)))
        v = rng.normal(size=(4096, 3))
        tgt = _f32(100.0 * v / np.linalg.norm(v, axis=1, keepdims=True))
        return (src, *nn_kernels.target_operands(
            tgt, torch.ones(4096, dtype=torch.bool), 1e9))
    if name in ("all_sentinel_1e9", "all_sentinel_1e30"):
        src = _f32(rng.uniform(-50, 50, (64, 3)))
        src[::3] = PAD
        tgt = _f32(rng.uniform(-50, 50, (256, 3)))
        return (src, *nn_kernels.target_operands(
            tgt, torch.zeros(256, dtype=torch.bool),
            1e9 if name.endswith("1e9") else 1e30))
    if name == "scan_pair_one_loose":
        # One valid column with tsq under |t|^2: the general limit.
        src, tgt, mask = _scan_pair()
        tgt_t, tsq = nn_kernels.target_operands(tgt, mask, 1e9)
        tsq[7] *= 0.5
        return src, tgt_t, tsq
    if name == "random_tsq":  # tsq unrelated to |t|^2: the general limit
        src = _f32(rng.uniform(-50, 50, (1024, 3)))
        tgt_t = _f32(rng.uniform(-50, 50, (3, 4096)))
        return src, tgt_t, _f32(rng.uniform(0, 1e4, 4096))
    if name == "ragged_37x5":
        src = _f32(rng.uniform(-20, 20, (37, 3)))
        tgt = _f32(rng.uniform(-20, 20, (5, 3)))
        return (src, *nn_kernels.target_operands(
            tgt, torch.tensor([True, True, False, True, True]), 1e30))
    raise ValueError(name)


CASES = ("scan_pair_1e9", "scan_pair_1e30", "wide_200m", "duplicates",
         "padded_rows", "sphere_origin", "all_sentinel_1e9", "all_sentinel_1e30",
         "ragged_37x5", "scan_pair_one_loose", "random_tsq")
LOOSE = ("scan_pair_one_loose", "random_tsq")  # the general limit runs


@pytest.mark.parametrize("name", CASES)
def test_screen_margin_keeps_the_plain_minimum(name):
    src, tgt_t, tsq = _case(name)
    d = tsq - 2.0 * nn_kernels._dot(src, tgt_t)  # the plain value, [N, M]
    best, idx = nn_kernels.nearest_neighbor_plain(src, tgt_t, tsq)
    screen = nn_kernels.screen_plain(src, tgt_t, tsq)
    err = (screen.double() - d.double()).abs()
    bound = nn_kernels.screen_error_bound(src, tgt_t, tsq)
    assert bool((err <= bound / 2).all()), float((err / bound).max())

    t2 = (tgt_t.double() ** 2).sum(0)
    tight = bool((tsq.double() >= nn_kernels.NORM_SLACK * t2).all())
    assert tight == (name not in LOOSE)
    limit = nn_kernels.screen_limit(src, tgt_t, tsq, screen.amin(1))
    cand = screen.double() <= limit[:, None]
    assert bool(cand[d == best[:, None]].all())  # every column of the min
    pick, pidx = torch.where(cand, d, float("inf")).min(1)
    assert torch.equal(pick, best)
    assert torch.equal(pidx.to(torch.int32), idx)
    # The argument itself: any screen within E_c of the plain values, here
    # the worst one (the minimum's columns pushed up by E_c, every other
    # column pulled down by it), still keeps every column of the minimum.
    at_min = d == best[:, None]
    worst = torch.where(at_min, d.double() + bound, d.double() - bound)
    worst_limit = nn_kernels.screen_limit(src, tgt_t, tsq, worst.amin(1))
    assert bool((worst <= worst_limit[:, None])[at_min].all())
    counts = nn_kernels.screen_counts(src, tgt_t, tsq)
    assert torch.equal(counts, cand.sum(1).to(torch.int32))
    if name == "duplicates":
        assert bool((counts >= 4).all()) and bool((idx < 1024).all())
    if name.startswith("all_sentinel"):
        assert bool((idx == 0).all()) and bool((counts == 256).all())


def test_screen_candidates_are_few_on_a_scan_pair():
    """The rescoring rate of the valid rows of the scan pair: the two-pass
    rule keeps the exact f32 work to a small share of the columns."""
    src, tgt_t, tsq = _case("scan_pair_1e9")
    counts = nn_kernels.screen_counts(src, tgt_t, tsq)[:864].double()
    assert float(counts.mean()) < 0.05 * tgt_t.shape[1]


def test_screen_is_the_jax_x3_expansion():
    """With ``tsq = 0`` the emulated screen is ``-2`` times JAX's ``x3``
    ranking product (``nn_pallas._ranking_dot``, the same hi/lo split),
    which JAX sums in f32 on the CPU: within 2^-20 of 2 sum_i |s_i t_i|."""
    rng = np.random.default_rng(12)
    s = rng.uniform(-120, 120, (256, 3)).astype(np.float32)
    t_t = rng.uniform(-120, 120, (3, 512)).astype(np.float32)
    want = -2.0 * np.asarray(nn_pallas._ranking_dot(
        jnp.asarray(s), jnp.asarray(t_t), "x3"), np.float64)
    got = nn_kernels.screen_plain(_f32(s), _f32(t_t),
                                  torch.zeros(512)).double().numpy()
    scale = 2.0 * np.abs(s).astype(np.float64) @ np.abs(t_t)
    assert (np.abs(got - want) <= 2.0 ** -20 * scale).all()


def test_nearest_neighbor_counts_on_cpu():
    """``counts=True`` on CPU tensors adds the emulated rescoring counts
    and launches nothing."""
    src, tgt_t, tsq = _case("ragged_37x5")
    nn_kernels.reset_launch_counts()
    best, idx, counts = nn_kernels.nearest_neighbor(src, tgt_t, tsq,
                                                    counts=True)
    pbest, pidx = nn_kernels.nearest_neighbor_plain(src, tgt_t, tsq)
    assert torch.equal(best, pbest) and torch.equal(idx, pidx)
    assert counts.dtype == torch.int32 and counts.shape == (37,)
    assert bool((counts >= 1).all()) and bool((counts <= 5).all())
    assert nn_kernels.LAUNCHES["nearest_neighbor"] == 0
