"""NDT derivative kernels K1-K3 and their plain PyTorch versions (port of
``toyslam_tpu/ops/ndt_pallas.py``).

Each wrapper takes CPU tensors to its ``*_plain`` version and launches its
hand-written CUDA kernel (``csrc/ndt_kernels.cu``, sm_90a) for CUDA
tensors, or raises; there is no fallback. The kernels are float32 only;
the plain versions are dtype-generic and compute exactly what the JAX jnp
path computes (``toyslam_tpu/registration/ndt.py:782-795, 885-998``).

The CUDA source is built by ``ops/_cuda.build`` at first use.

Layouts (offset-major, as in the JAX package):
  params [83]: d1, d2, T[:3, :] row-major, j_tab [8, 3], h_tab [15, 3];
  xyz [3, N]; table [grid_capacity, 16] hash-table rows; h, nvid [K*N]
  int32 and okm [K*N] bool from ``registration/ndt.py``'s neighbour hash;
  stats10 [10, K*N]: mean(3), icov sym(6), gate.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from toyslam_tpu_torch.ops import _cuda

N_TERMS = 28  # 1 score + 6 gradient + 21 Hessian upper triangle
N_PARAMS = 83
THREADS = 256  # kThreads in csrc/ndt_kernels.cu

# Kernel launches since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"ndt_terms_gathered": 0, "ndt_gather_repack": 0,
            "ndt_terms_packed": 0}

SOURCE = _cuda.CSRC / "ndt_kernels.cu"
_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Plain versions (any device, any float dtype)
# --------------------------------------------------------------------------


def ndt_gather_repack_plain(table, h, nvid, okm):
    """Hash-table rows -> [10, K*N] compact stats with the exactly-one-voxel,
    id-verified gate (``ndt.py:782-795``)."""
    rows = table[h.long()]
    dtype = table.dtype
    vox_valid = (rows[:, 9] > 0.5) & (rows[:, 9] < 1.5)
    vid_match = ((rows[:, 10] == (nvid & 0xFFFF).to(dtype))
                 & (rows[:, 11] == (nvid >> 16).to(dtype)))
    gate = (okm & vid_match & vox_valid).to(dtype)
    return torch.cat([rows[:, :9].T, gate[None]], 0)


def ndt_terms_packed_plain(params, xyz, stats10):
    """The 28 NDT sums from compact stats (``ndt.py:885-998``)."""
    N = xyz.shape[1]
    K = stats10.shape[1] // N
    dtype = xyz.dtype
    P = params
    d1, d2 = P[0], P[1]
    T = P[2:14].reshape(3, 4)
    j_tab = P[14:38].reshape(8, 3)
    h_tab = P[38:83].reshape(15, 3)
    sx, sy, sz = xyz[0], xyz[1], xyz[2]

    def expand(v):  # [N] -> [K*N] offset-major
        return v.repeat(K)

    tx = T[0, 0] * sx + T[0, 1] * sy + T[0, 2] * sz + T[0, 3]
    ty = T[1, 0] * sx + T[1, 1] * sy + T[1, 2] * sz + T[1, 3]
    tz = T[2, 0] * sx + T[2, 1] * sy + T[2, 2] * sz + T[2, 3]

    mx, my, mz, cxx, cxy, cxz, cyy, cyz, czz, valid = stats10
    qx = expand(tx) - mx
    qy = expand(ty) - my
    qz = expand(tz) - mz
    Cqx = cxx * qx + cxy * qy + cxz * qz
    Cqy = cxy * qx + cyy * qy + cyz * qz
    Cqz = cxz * qx + cyz * qy + czz * qz
    qCq = qx * Cqx + qy * Cqy + qz * Cqz

    e = torch.exp(-0.5 * d2 * qCq)
    e_x_cov_x = d2 * e
    # NaN/invalid guard (``ndt_omp_impl.hpp:506-507``)
    gate = ((e_x_cov_x <= 1.0) & (e_x_cov_x >= 0.0)
            & torch.isfinite(e_x_cov_x) & (valid > 0.5)).to(dtype)
    factor = d1 * d2 * e * gate

    xjf = [expand(j_tab[k, 0] * sx + j_tab[k, 1] * sy + j_tab[k, 2] * sz)
           for k in range(8)]
    u = (Cqx, Cqy, Cqz,
         Cqy * xjf[0] + Cqz * xjf[1],
         Cqx * xjf[2] + Cqy * xjf[3] + Cqz * xjf[4],
         Cqx * xjf[5] + Cqy * xjf[6] + Cqz * xjf[7])

    terms = [-d1 * e * gate]
    terms += [factor * ui for ui in u]

    C = [[cxx, cxy, cxz], [cxy, cyy, cyz], [cxz, cyz, czz]]
    CJ = [[C[r][1] * xjf[0] + C[r][2] * xjf[1],
           C[r][0] * xjf[2] + C[r][1] * xjf[3] + C[r][2] * xjf[4],
           C[r][0] * xjf[5] + C[r][1] * xjf[6] + C[r][2] * xjf[7]]
          for r in range(3)]

    def col_dot(a, v):
        if a == 0:
            return xjf[0] * v[1] + xjf[1] * v[2]
        if a == 1:
            return xjf[2] * v[0] + xjf[3] * v[1] + xjf[4] * v[2]
        return xjf[5] * v[0] + xjf[6] * v[1] + xjf[7] * v[2]

    xhf = [expand(h_tab[k, 0] * sx + h_tab[k, 1] * sy + h_tab[k, 2] * sz)
           for k in range(15)]
    Hv = {
        (0, 0): Cqy * xhf[0] + Cqz * xhf[1],
        (0, 1): Cqy * xhf[2] + Cqz * xhf[3],
        (0, 2): Cqy * xhf[4] + Cqz * xhf[5],
        (1, 1): Cqx * xhf[6] + Cqy * xhf[7] + Cqz * xhf[8],
        (1, 2): Cqx * xhf[9] + Cqy * xhf[10] + Cqz * xhf[11],
        (2, 2): Cqx * xhf[12] + Cqy * xhf[13] + Cqz * xhf[14],
    }
    for i in range(6):
        for j in range(i, 6):
            contrib = -d2 * factor * u[i] * u[j]
            if i < 3 and j < 3:
                contrib = contrib + factor * C[i][j]
            elif i < 3 <= j:
                contrib = contrib + factor * CJ[i][j - 3]
            else:
                a_, b_ = i - 3, j - 3
                contrib = contrib + factor * (
                    col_dot(a_, [CJ[0][b_], CJ[1][b_], CJ[2][b_]])
                    + Hv[(a_, b_)])
            terms.append(contrib)
    return torch.stack(terms).sum(1)


def ndt_terms_gathered_plain(params, xyz, table, h, nvid, okm):
    """The 28 NDT sums straight from the hash table (gather + gate +
    terms)."""
    return ndt_terms_packed_plain(
        params, xyz, ndt_gather_repack_plain(table, h, nvid, okm))


# --------------------------------------------------------------------------
# Build and launch
# --------------------------------------------------------------------------


def build() -> Path:
    """Compile ``csrc/ndt_kernels.cu`` unless its library exists; returns
    the library path (nvcc's report beside it as ``.log``)."""
    return _cuda.build(SOURCE)[0]


def _library():
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        _lib = _cuda.load(SOURCE, {
            "ndt_terms_gathered": [p, p, p, p, p, p, p, i64, i64, p],
            "ndt_gather_repack": [p, p, p, p, p, i64, p],
            "ndt_terms_packed": [p, p, p, p, i64, i64, p],
        })
    return _lib


def _on_cpu(*tensors) -> bool:
    return _cuda.on_cpu("NDT", *tensors)


def _check_pairs(table, h, nvid, okm):
    kn = h.shape[0]
    _cuda.check("table", table, torch.float32, (table.shape[0], 16))
    if table.data_ptr() % 16:
        raise ValueError("table: rows must be 16-byte aligned")
    _cuda.check("h", h, torch.int32, (kn,))
    _cuda.check("nvid", nvid, torch.int32, (kn,))
    _cuda.check("okm", okm, torch.bool, (kn,))
    if kn >= 2**31:
        raise ValueError(f"{kn} pairs exceed the kernels' int32 indexing")
    return kn


def _check_points(params, xyz, kn):
    n = xyz.shape[1]
    _cuda.check("params", params, torch.float32, (N_PARAMS,))
    _cuda.check("xyz", xyz, torch.float32, (3, n))
    if n == 0 or kn % n:
        raise ValueError(f"{kn} pairs are not K x {n} points")
    return n


def ndt_gather_repack(table, h, nvid, okm):
    """K2: ``table [cap, 16]`` rows at ``h`` -> ``stats10 [10, K*N]``."""
    if _on_cpu(table, h, nvid, okm):
        return ndt_gather_repack_plain(table, h, nvid, okm)
    kn = _check_pairs(table, h, nvid, okm)
    out = torch.empty((10, kn), dtype=torch.float32, device=table.device)
    if kn == 0:
        return out
    _cuda.launch(_library().ndt_gather_repack, table, h, nvid, okm, out, kn)
    LAUNCHES["ndt_gather_repack"] += 1
    return out


def ndt_terms_packed(params, xyz, stats10):
    """K3: the 28 NDT sums from ``stats10 [10, K*N]``."""
    if _on_cpu(params, xyz, stats10):
        return ndt_terms_packed_plain(params, xyz, stats10)
    kn = stats10.shape[1]
    _cuda.check("stats10", stats10, torch.float32, (10, kn))
    n = _check_points(params, xyz, kn)
    blocks = -(-kn // THREADS)
    partials = torch.empty((blocks, N_TERMS), dtype=torch.float32,
                           device=xyz.device)
    _cuda.launch(_library().ndt_terms_packed, params, xyz, stats10, partials,
                 n, kn)
    LAUNCHES["ndt_terms_packed"] += 1
    return partials.sum(0)  # fixed-order reduction over blocks


def ndt_terms_gathered(params, xyz, table, h, nvid, okm):
    """K1: the 28 NDT sums straight from the hash table."""
    if _on_cpu(params, xyz, table, h, nvid, okm):
        return ndt_terms_gathered_plain(params, xyz, table, h, nvid, okm)
    kn = _check_pairs(table, h, nvid, okm)
    n = _check_points(params, xyz, kn)
    blocks = -(-kn // THREADS)
    partials = torch.empty((blocks, N_TERMS), dtype=torch.float32,
                           device=xyz.device)
    _cuda.launch(_library().ndt_terms_gathered, params, xyz, table, h, nvid,
                 okm, partials, n, kn)
    LAUNCHES["ndt_terms_gathered"] += 1
    return partials.sum(0)  # fixed-order reduction over blocks
