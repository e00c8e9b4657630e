"""NDT derivative kernels K1-K3 and their plain PyTorch versions (port of
``toyslam_tpu/ops/ndt_pallas.py``), with the DIRECT neighbour hash.

Each wrapper takes CPU tensors to its ``*_plain`` version and launches its
hand-written CUDA kernel (``csrc/ndt_kernels.cu``, sm_90a) for CUDA
tensors, or raises; there is no fallback. The kernels are float32 only;
the plain versions are dtype-generic and compute exactly what the JAX jnp
path computes (``toyslam_tpu/registration/ndt.py:660-704, 782-795,
885-998``).

The CUDA source is built by ``ops/_cuda.build`` at first use.

Layouts (offset-major, as in the JAX package):
  params [83]: d1, d2, T[:3, :] row-major, j_tab [8, 3], h_tab [15, 3];
  xyz [3, N]; mask [N] bool; table [grid_capacity, 16] hash-table rows;
  min_b, div [3] int32, the map's grid; offsets [K, 3] int32 (DIRECT1/7/27);
  h, nvid [K*N] int32 and okm [K*N] bool from the neighbour hash;
  stats10 [10, K*N]: mean(3), icov sym(6), gate.

The fleet's lane axis (``*_lanes``, what JAX's ``vmap`` of a
``pallas_call`` gives its grid): B lanes' inputs stacked lane-major (xyz
[B, 3, N], mask [B, N], table [B, cap, 16], min_b and div [B, 3], stats10
[B, 10, K*N]), params [L, 83] and ``lane_ids`` [L] int32: row y of the
output [L, 28] is lane ``lane_ids[y]`` evaluated at params row y, or lane
y when ``lane_ids`` is None (every lane in order, L = B). One launch
evaluates the L lanes still running; lanes not named cost nothing.
K1 and K3 run one kernel body for both: the single-lane wrappers launch
it with L = 1, and lane b of a batched launch is bit-identical to the
single-lane launch on lane b's inputs. A lane launch counts once under
the kernel's own ``LAUNCHES`` key, whatever L; ``LANE_ROWS`` counts the
lanes those launches evaluated.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from toyslam_tpu_torch.ops import _cuda

N_TERMS = 28  # 1 score + 6 gradient + 21 Hessian upper triangle
N_PARAMS = 83
THREADS = 128  # kThreads in csrc/ndt_kernels.cu
MAX_OFFSETS = 27  # kMaxK in csrc/ndt_kernels.cu (DIRECT27)
# K1 and K3 run a grid-stride loop over at most one wave of blocks (132
# SMs, 4 blocks of 128 threads each), so the last block adds few block rows.
MAX_BLOCKS = 4 * 132
# Lanes that test one point's gates in K1 and K3 (kLanes in
# csrc/ndt_kernels.cu): a warp takes 16 points at a time.
LANES = 2

# Kernel launches since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"ndt_terms_gathered": 0, "ndt_gather_repack": 0,
            "ndt_terms_packed": 0}
# Lanes evaluated by the lane launches of K1 and K3 since the last reset.
LANE_ROWS = {"ndt_terms_gathered": 0, "ndt_terms_packed": 0}

SOURCE = _cuda.CSRC / "ndt_kernels.cu"
_lib = None


def reset_launch_counts():
    for counts in (LAUNCHES, LANE_ROWS):
        for k in counts:
            counts[k] = 0


# --------------------------------------------------------------------------
# Plain versions (any device, any float dtype)
# --------------------------------------------------------------------------


def ndt_neighbor_hash_plain(params, xyz, mask, min_b, div, cap, inv_leaf,
                            offsets):
    """Hash slot ``h``, expected voxel id ``nvid`` and in-bounds & source-mask
    flag ``okm`` of every (DIRECT offset, point) pair, [K*N] offset-major,
    at the pose in ``params`` (``toyslam_tpu/registration/ndt.py:660-704``).

    Each operation rounds on its own (eager torch) in the order of the JAX
    source, and K1 repeats that bit for bit (XLA on the CPU contracts two
    FMAs and can pick the next voxel for a point within an ulp of a face).
    Where ``okm`` is false, ``h`` and ``nvid`` may differ between devices
    (a padded point at 1e9 overflows int32), and nothing reads them.
    """
    K, N = offsets.shape[0], xyz.shape[1]
    T = params[2:14]
    sx, sy, sz = xyz
    inv = torch.tensor(inv_leaf, dtype=xyz.dtype)
    nijk = []
    for a in range(3):
        t = T[4 * a] * sx + T[4 * a + 1] * sy + T[4 * a + 2] * sz + T[4 * a + 3]
        cell = torch.floor(t * inv).to(torch.int32) - min_b[a]
        nijk.append((cell + offsets[:, a, None]).reshape(K * N))
    in_b = ((nijk[0] >= 0) & (nijk[0] < div[0]) & (nijk[1] >= 0)
            & (nijk[1] < div[1]) & (nijk[2] >= 0) & (nijk[2] < div[2]))
    nvid = nijk[0] + nijk[1] * div[0] + nijk[2] * (div[0] * div[1])
    ok = in_b & (nvid >= 0)
    h = torch.where(ok, nvid & (cap - 1), 0)
    return h, nvid, (ok.view(K, N) & mask).reshape(K * N)


def ndt_neighbor_hash_lanes_plain(params, xyz, mask, min_b, div, cap,
                                  inv_leaf, offsets, row0):
    """``ndt_neighbor_hash_plain`` of L lanes at once: params [L, 83], xyz
    [L, 3, N], mask [L, N], min_b and div [L, 3] -> h, nvid, okm [L, K*N],
    with each lane's ``h`` offset by its ``row0`` [L, 1] (the lane's first
    row in a stacked [B * cap, 16] table). The same operations, broadcast
    over the lanes, so each lane is bit-identical to the single-lane hash
    plus its offset."""
    L, K, N = xyz.shape[0], offsets.shape[0], xyz.shape[2]
    T = params[:, 2:14]
    sx, sy, sz = xyz.unbind(1)
    inv = torch.tensor(inv_leaf, dtype=xyz.dtype)
    nijk = []
    for a in range(3):
        t = (T[:, 4 * a, None] * sx + T[:, 4 * a + 1, None] * sy
             + T[:, 4 * a + 2, None] * sz + T[:, 4 * a + 3, None])
        cell = torch.floor(t * inv).to(torch.int32) - min_b[:, a, None]
        nijk.append((cell[:, None, :] + offsets[None, :, a, None])
                    .reshape(L, K * N))
    d0, d1, d2 = (div[:, a, None] for a in range(3))
    in_b = ((nijk[0] >= 0) & (nijk[0] < d0) & (nijk[1] >= 0)
            & (nijk[1] < d1) & (nijk[2] >= 0) & (nijk[2] < d2))
    nvid = nijk[0] + nijk[1] * d0 + nijk[2] * (d0 * d1)
    ok = in_b & (nvid >= 0)
    # torch.where(ok, slot, 0) + row0 in one operation.
    h = torch.addcmul(row0, nvid & (cap - 1), ok)
    return h, nvid, (ok.view(L, K, N) & mask[:, None, :]).reshape(L, K * N)


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


def ndt_pair_terms_plain(params, xyz, stats10):
    """The 28 NDT terms of every pair, [28, K*N] (``ndt.py:885-998``)."""
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
    return torch.stack(terms)


def ndt_terms_packed_plain(params, xyz, stats10):
    """The 28 NDT sums from compact stats."""
    return ndt_pair_terms_plain(params, xyz, stats10).sum(1)


def ndt_terms_gathered_plain(params, xyz, mask, table, min_b, div, inv_leaf,
                             offsets):
    """The 28 NDT sums straight from the hash table (hash + gather + gate +
    terms)."""
    hashed = ndt_neighbor_hash_plain(params, xyz, mask, min_b, div,
                                     table.shape[0], inv_leaf, offsets)
    return ndt_terms_packed_plain(params, xyz,
                                  ndt_gather_repack_plain(table, *hashed))


def lane_list(xyz, lane_ids):
    """The lanes a lane call names, a grid row each: ``lane_ids``, or every
    lane of ``xyz [B, 3, N]`` in order when it is None."""
    return range(xyz.shape[0]) if lane_ids is None else lane_ids.tolist()


def ndt_terms_packed_lanes_plain(params, xyz, stats10, lane_ids):
    """K3's plain version over lanes: row y is ``ndt_terms_packed_plain``
    of lane ``lane_ids[y]`` at params row y, [L, 28]."""
    return torch.stack([ndt_terms_packed_plain(params[y], xyz[b], stats10[b])
                        for y, b in enumerate(lane_list(xyz, lane_ids))])


def ndt_terms_gathered_lanes_plain(params, xyz, mask, table, min_b, div,
                                   inv_leaf, offsets, lane_ids):
    """K1's plain version over lanes: row y is ``ndt_terms_gathered_plain``
    of lane ``lane_ids[y]`` at params row y, [L, 28]."""
    return torch.stack([
        ndt_terms_gathered_plain(params[y], xyz[b], mask[b], table[b],
                                 min_b[b], div[b], inv_leaf, offsets)
        for y, b in enumerate(lane_list(xyz, lane_ids))])


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
        p, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        _lib = _cuda.load(SOURCE, {
            "ndt_terms_gathered": [p, p, p, p, p, p, p, p, p, p, p, i64,
                                   i64, f32, i64, i64, i64, p],
            "ndt_gather_repack": [p, p, p, p, p, i64, p],
            "ndt_terms_packed": [p, p, p, p, p, p, p, i64, i64, i64, i64,
                                 p],
        })
    return _lib


def _on_cpu(*tensors) -> bool:
    return _cuda.on_cpu("NDT", *tensors)


def _check_table(table):
    _cuda.check("table", table, torch.float32, (table.shape[0], 16))
    if table.data_ptr() % 16:
        raise ValueError("table: rows must be 16-byte aligned")


def _check_pairs(table, h, nvid, okm):
    kn = h.shape[0]
    _check_table(table)
    _cuda.check("h", h, torch.int32, (kn,))
    _cuda.check("nvid", nvid, torch.int32, (kn,))
    _cuda.check("okm", okm, torch.bool, (kn,))
    if kn >= 2**31:
        raise ValueError(f"{kn} pairs exceed the kernels' int32 indexing")
    return kn


def _check_points(params, xyz):
    n = xyz.shape[1]
    _cuda.check("params", params, torch.float32, (N_PARAMS,))
    _cuda.check("xyz", xyz, torch.float32, (3, n))
    if n == 0 or n * 8 >= 2**31:
        raise ValueError(f"{n} points: the kernels take 1 to 2**28 - 1")
    return n


def _check_hash(mask, min_b, div, cap, offsets, n):
    """The hash's operands; returns K."""
    K = offsets.shape[0]
    _cuda.check("mask", mask, torch.bool, (n,))
    _cuda.check("min_b", min_b, torch.int32, (3,))
    _cuda.check("div", div, torch.int32, (3,))
    _cuda.check("offsets", offsets, torch.int32, (K, 3))
    if not 1 <= K <= MAX_OFFSETS:
        raise ValueError(f"{K} offsets: the kernels take 1 to {MAX_OFFSETS}")
    if cap < 1 or cap & (cap - 1) or cap > 2**31:
        raise ValueError(f"table capacity {cap} is not a power of two")
    if K * n >= 2**31:
        raise ValueError(f"{K * n} pairs exceed the kernels' int32 indexing")
    return K


def _blocks(n):
    return min(-(-n * LANES // THREADS), MAX_BLOCKS)


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


def _check_lanes(params, xyz, lane_ids):
    """The lane operands: params [L, 83] and lane ids [L] in [0, B), or no
    ids and L = B; returns L. The ids are not read back from the card (no
    host sync): the caller names lanes that exist."""
    L = xyz.shape[0] if lane_ids is None else lane_ids.shape[0]
    _cuda.check("params", params, torch.float32, (L, N_PARAMS))
    if lane_ids is not None:
        _cuda.check("lane_ids", lane_ids, torch.int32, (L,))
    if not 1 <= L <= 65535:  # gridDim.y
        raise ValueError(f"{L} lanes: the kernels take 1 to 65535")
    return L


def _terms_packed(params, xyz, stats10, lane_ids, L):
    """K3 over L grid rows (lane_ids None: grid row y is lane y)."""
    B, n = xyz.shape[0], xyz.shape[2]
    _cuda.check("xyz", xyz, torch.float32, (B, 3, n))
    if n == 0 or n * 8 >= 2**31:
        raise ValueError(f"{n} points: the kernels take 1 to 2**28 - 1")
    kn = stats10.shape[2]
    _cuda.check("stats10", stats10, torch.float32, (B, 10, kn))
    if kn % n or kn >= 2**31 or kn // n > MAX_OFFSETS:
        raise ValueError(f"{kn} pairs are not K <= {MAX_OFFSETS} x {n} "
                         f"points under 2**31")
    blocks = _blocks(n)
    out, partials, counter = _cuda.grid_sum_buffers(
        xyz.device, N_TERMS, N_TERMS, blocks, L)
    _cuda.launch(_library().ndt_terms_packed, params, xyz, stats10, lane_ids,
                 partials, out, counter, n, kn // n, blocks, L)
    LAUNCHES["ndt_terms_packed"] += 1
    return out


def _terms_gathered(params, xyz, mask, table, min_b, div, inv_leaf, offsets,
                    lane_ids, L):
    """K1 over L grid rows (lane_ids None: grid row y is lane y)."""
    B, n = xyz.shape[0], xyz.shape[2]
    _cuda.check("xyz", xyz, torch.float32, (B, 3, n))
    if n == 0 or n * 8 >= 2**31:
        raise ValueError(f"{n} points: the kernels take 1 to 2**28 - 1")
    cap = table.shape[1]
    _cuda.check("table", table, torch.float32, (B, cap, 16))
    if table.data_ptr() % 16:
        raise ValueError("table: rows must be 16-byte aligned")
    _cuda.check("mask", mask, torch.bool, (B, n))
    _cuda.check("min_b", min_b, torch.int32, (B, 3))
    _cuda.check("div", div, torch.int32, (B, 3))
    K = _check_hash(mask[0], min_b[0], div[0], cap, offsets, n)
    blocks = _blocks(n)
    out, partials, counter = _cuda.grid_sum_buffers(
        xyz.device, N_TERMS, N_TERMS, blocks, L)
    _cuda.launch(_library().ndt_terms_gathered, params, xyz, mask, table,
                 min_b, div, offsets, lane_ids, partials, out, counter, n, K,
                 inv_leaf, cap - 1, blocks, L)
    LAUNCHES["ndt_terms_gathered"] += 1
    return out


def ndt_terms_packed(params, xyz, stats10):
    """K3: the 28 NDT sums from ``stats10 [10, K*N]``, in one launch."""
    if _on_cpu(params, xyz, stats10):
        return ndt_terms_packed_plain(params, xyz, stats10)
    _cuda.check("params", params, torch.float32, (N_PARAMS,))
    return _terms_packed(params, xyz[None], stats10[None], None, 1)[0]


def ndt_terms_gathered(params, xyz, mask, table, min_b, div, inv_leaf,
                       offsets):
    """K1: the 28 NDT sums straight from the hash table, the neighbour hash
    included (``inv_leaf``: 1 / the map's resolution, taken as float32), in
    one launch."""
    if _on_cpu(params, xyz, mask, table, min_b, div, offsets):
        return ndt_terms_gathered_plain(params, xyz, mask, table, min_b, div,
                                        inv_leaf, offsets)
    _cuda.check("params", params, torch.float32, (N_PARAMS,))
    return _terms_gathered(params, xyz[None], mask[None], table[None],
                           min_b[None], div[None], inv_leaf, offsets, None,
                           1)[0]


def _ids(lane_ids):
    """The lane ids as the tensors ``_on_cpu`` reads: none without ids."""
    return () if lane_ids is None else (lane_ids,)


def ndt_terms_packed_lanes(params, xyz, stats10, lane_ids):
    """K3 over lanes: ``[L, 28]``, row y the sums of lane ``lane_ids[y]``
    (stats10 [B, 10, K*N], xyz [B, 3, N]; lane y without ids) at params
    row y, in one launch."""
    if _on_cpu(params, xyz, stats10, *_ids(lane_ids)):
        return ndt_terms_packed_lanes_plain(params, xyz, stats10, lane_ids)
    L = _check_lanes(params, xyz, lane_ids)
    out = _terms_packed(params, xyz, stats10, lane_ids, L)
    LANE_ROWS["ndt_terms_packed"] += L
    return out


def ndt_terms_gathered_lanes(params, xyz, mask, table, min_b, div, inv_leaf,
                             offsets, lane_ids):
    """K1 over lanes: ``[L, 28]``, row y the sums of lane ``lane_ids[y]``
    (xyz [B, 3, N], mask [B, N], table [B, cap, 16], min_b and div [B, 3];
    lane y without ids) at params row y, in one launch."""
    if _on_cpu(params, xyz, mask, table, min_b, div, offsets,
               *_ids(lane_ids)):
        return ndt_terms_gathered_lanes_plain(params, xyz, mask, table, min_b,
                                              div, inv_leaf, offsets,
                                              lane_ids)
    L = _check_lanes(params, xyz, lane_ids)
    out = _terms_gathered(params, xyz, mask, table, min_b, div, inv_leaf,
                          offsets, lane_ids, L)
    LANE_ROWS["ndt_terms_gathered"] += L
    return out
