"""K6's summation order, emulated in float32 on the CPU, against the plain
GICP sums in float64.

K6 (``csrc/gicp_kernels.cu``) adds the 27 terms of its correspondences in
a fixed order: thread t of block b takes correspondences (b * PER_THREAD +
j) * THREADS + t for j = 0 .. PER_THREAD - 1 in order into its running
sums; then ``grid_sum`` (``csrc/block_sum.cuh``): each warp adds its lanes
by halving exchanges (lanes l and l + 16, then l + 8, ...), the block adds
its warps in order, and the last block adds the blocks' rows, thread t
rows t, t + THREADS, ... in order, before one more block sum. The f32 sum
in that order, of f32 per-pair terms computed as the kernel computes
them, stays within TERMS_RTOL (chip_smoke.py's bound for K6 against its
plain version) of the largest f64 sum of each group (gradient, A_tt,
A_tr, A_rr): f32 sums of up to 32768 terms in another order. The card
test ``test_gicp_terms_one_launch_on_card`` holds the kernel itself to the
plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

from toyslam_tpu_torch.ops import gicp_kernels  # noqa: E402

TERMS_RTOL = 1e-4
GROUPS = (slice(0, 6), slice(6, 12), slice(12, 21), slice(21, 27))


def _pairs(n):
    """Generated correspondences: SPD Mahalanobis matrices, 30 % rejected,
    a pose of 0.1 rad about z and a 0.37 m shift; float32."""
    rng = np.random.default_rng(n)
    xyz = rng.uniform(-20, 20, (3, n))
    q = xyz + rng.normal(0, 0.1, (3, n))
    L = rng.normal(size=(n, 3, 3))
    M = L @ L.transpose(0, 2, 1) + np.eye(3)
    m6 = M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T
    w = (rng.uniform(size=n) > 0.3).astype(np.float64)
    c, s = np.cos(0.1), np.sin(0.1)
    params = np.array([c, -s, 0, s, c, 0, 0, 0, 1, 0.3, -0.2, 0.1])
    return [torch.tensor(a, dtype=torch.float32)
            for a in (params, xyz, q, m6, w)]


def _pair_terms(params, xyz, q, m6, w):
    """[27, N] f32 terms of every correspondence, as ``pair_terms`` in
    ``csrc/gicp_kernels.cu`` forms them."""
    P = params
    x, y, z = xyz
    ax = P[0] * x + P[1] * y + P[2] * z
    ay = P[3] * x + P[4] * y + P[5] * z
    az = P[6] * x + P[7] * y + P[8] * z
    rx, ry, rz = ax + P[9] - q[0], ay + P[10] - q[1], az + P[11] - q[2]
    m00, m01, m02, m11, m12, m22 = m6
    mrx = m00 * rx + m01 * ry + m02 * rz
    mry = m01 * rx + m11 * ry + m12 * rz
    mrz = m02 * rx + m12 * ry + m22 * rz
    b = [-(m01 * az - m02 * ay), -(-m00 * az + m02 * ax),
         -(m00 * ay - m01 * ax), -(m11 * az - m12 * ay),
         -(-m01 * az + m12 * ax), -(m01 * ay - m11 * ax),
         -(m12 * az - m22 * ay), -(-m02 * az + m22 * ax),
         -(m02 * ay - m12 * ax)]
    c = [-az * b[3] + ay * b[6], -az * b[4] + ay * b[7],
         -az * b[5] + ay * b[8], az * b[1] - ax * b[7],
         az * b[2] - ax * b[8], -ay * b[2] + ax * b[5]]
    terms = [mrx, mry, mrz, ay * mrz - az * mry, az * mrx - ax * mrz,
             ax * mry - ay * mrx, m00, m01, m02, m11, m12, m22, *b, *c]
    return torch.stack([w * t for t in terms]).numpy()


def _block_sum(v, threads):
    """[27, B, threads] -> [27, B]: warp halving exchanges, then the
    warps in order."""
    v = v.reshape(v.shape[0], v.shape[1], threads // 32, 32)
    for w in (16, 8, 4, 2, 1):
        v = v[..., :w] + v[..., w:2 * w]
    s = v[..., 0, 0]
    for k in range(1, threads // 32):
        s = s + v[..., k, 0]
    return s


def _kernel_order_sum(terms):
    """[27, N] f32 -> [27] f32 in K6's order (module docstring)."""
    T, P = gicp_kernels.THREADS, gicp_kernels.PER_THREAD
    n = terms.shape[1]
    B = gicp_kernels.blocks(n)
    padded = np.zeros((terms.shape[0], B * P * T), np.float32)
    padded[:, :n] = terms
    per = padded.reshape(-1, B, P, T)
    acc = per[:, :, 0]
    for j in range(1, P):
        acc = acc + per[:, :, j]
    partials = _block_sum(acc, T)  # [27, B]
    final = np.zeros((terms.shape[0], T), np.float32)
    for b0 in range(0, B, T):
        rows = partials[:, b0:b0 + T]
        final[:, :rows.shape[1]] += rows
    return _block_sum(final[:, None], T)[:, 0]


@pytest.mark.parametrize("n", [1, 257, 32768])
def test_k6_sum_order_within_terms_rtol(n):
    args = _pairs(n)
    terms = _pair_terms(*args)
    assert terms.dtype == np.float32 and terms.shape == (27, n)
    got = _kernel_order_sum(terms).astype(np.float64)
    want = gicp_kernels.gicp_terms_plain(*(a.double() for a in args)).numpy()
    for sl in GROUPS:
        rel = np.abs(got[sl] - want[sl]).max() / np.abs(want[sl]).max()
        assert rel <= TERMS_RTOL, (sl, rel)
