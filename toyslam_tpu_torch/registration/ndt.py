"""Normal Distributions Transform registration (port of
``toyslam_tpu/registration/ndt.py``).

Re-implements ``pclomp::NormalDistributionsTransform`` (reference
``ndt_omp/include/pclomp/ndt_omp_impl.hpp``) as the JAX package does:

- ``build_ndt_map``: the voxel-Gaussian map from one stable sort plus
  segment sums, a 5-sweep Jacobi eigensolver for the eigenvalue
  inflation, the adjugate inverse, and a ``[grid_capacity, 16]`` hash table
  addressed by ``vid & (grid_capacity - 1)`` whose rows carry the voxel-id
  halves for aliasing verification.
- ``compute_derivatives``: the DIRECT7/1/27 neighbour hash, the stats
  gather and the 28 score/gradient/Hessian sums in the kernels of
  ``ops/ndt_kernels.py`` (CUDA on the card, plain torch on CPU): one K1
  launch an exact evaluation; the frozen line search hashes in plain torch
  for K2 and sums with K3.
- ``ndt_align``: Newton steps with the More-Thuente line search.
- The fleet's lane axis (JAX's ``vmap``): ``build_ndt_map_lanes`` builds
  B maps in one pass, and ``ndt_align_lanes`` runs B aligns in lockstep,
  each lane's host logic its own generator (``_align_steps``) and each
  round one K1 or K3 launch and one host sync for all running lanes. Each
  lane is bit-identical to the same source aligned alone.

One evaluator (``_LaneEvaluator``) and one host loop (``_align_lanes``)
serve every NDT align: ``ndt_align`` is ``ndt_align_lanes`` at one lane,
``compute_derivatives`` and ``gather_neighborhood`` evaluate one lane, and
``parallel/batch.sharded_align`` drives an evaluator of the same protocol
over point shards. A round that names every lane in order passes the
kernels no lane ids, so one lane costs what it would alone.

The host loop is a design choice, not a fallback. JAX runs the Newton and
line-search control flow inside ``lax.while_loop``; here it is a Python
loop. The 6x6 SVD solve and the More-Thuente scalar logic run on the host
in the source dtype (numpy scalars, torch CPU for the SVD), and every
round of derivative evaluations brings its sums back in one device-to-host
copy, which is the loop's only synchronisation point
(``NDTResult.host_syncs`` counts them). Voxel gathers for the frozen line
search stay on the device.

Deliberate differences from the reference are the JAX package's: KDTREE
search dropped, Hessian on every evaluation, the float-path ``h_ang`` sign
bug fixed.

The coarse search helpers: ``lookup_neighbors`` (binary search over the
sorted voxel ids), ``nearest_k_search`` and ``radius_search`` (one full
f32 ``[Q, V]`` centroid-distance product, ``torch.matmul`` with TF32 off as
JAX's ``HIGHEST``, and ``torch.topk``), ``fitness_score`` (PCL's
``getFitnessScore`` through K4, ``ops/nn_kernels.nearest_neighbor``) and
``sample_display_cloud``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.core.pointcloud import (PointCloud, div_mul_lanes,
                                              voxel_grid_lanes)
from toyslam_tpu_torch.ops import ndt_kernels, nn_kernels
from toyslam_tpu_torch.ops.eigh3 import eigh3_soa
from toyslam_tpu_torch.ops.segment import (INT_MAX, run_bookkeeping_lanes,
                                           seg_broadcast_lanes,
                                           seg_reduce_lanes, sort_lanes)
from toyslam_tpu_torch.utils.profiling import span, spanned


class NDTConfig(NamedTuple):
    """Knobs mirroring the reference ctor defaults (``ndt_omp_impl.hpp:47-76``)
    and the JAX package's; its TPU dispatch knobs are gone (the port
    dispatches on the tensors' device)."""

    resolution: float = 1.0
    step_size: float = 0.1
    outlier_ratio: float = 0.55
    transformation_epsilon: float = 0.1
    max_iterations: int = 35
    min_points_per_voxel: int = 6
    search_method: str = "DIRECT7"  # DIRECT7 | DIRECT1 | DIRECT27
    max_step_iterations: int = 10
    min_covar_eigvalue_mult: float = 0.01
    # Hash-table rows, a power of two: slot = vid & (grid_capacity - 1).
    grid_capacity: int = 1 << 16
    # Voxel slots kept in the map (valid voxels first, excess dropped).
    map_capacity: int = 16384
    # Reuse the voxel neighbourhood gathered at the first trial point for
    # all More-Thuente trials of a Newton iteration.
    frozen_linesearch: bool = False
    # With frozen_linesearch: regather only for the first N Newton
    # iterations, then keep the last neighbourhood (1 << 30 = always).
    regather_iterations: int = 1 << 30


class NDTMap(NamedTuple):
    """Voxel-Gaussian map with a hash-addressed ``[grid_capacity, 16]`` row
    table: mean(3), icov sym(6), valid flag, voxel-id 16-bit halves, pad."""

    unique_ids: torch.Tensor  # [V] int32, sorted, INT_MAX padded
    valid: torch.Tensor  # [V] bool
    min_b: torch.Tensor  # [3] int32
    div: torch.Tensor  # [3] int32
    div_mul: torch.Tensor  # [3] int32
    hash_table: torch.Tensor  # [grid_capacity, 16]
    vid_of_slot: torch.Tensor  # [V] int32
    mean3: torch.Tensor  # [3, V]
    icov6: torch.Tensor  # [6, V] xx, xy, xz, yy, yz, zz
    table: torch.Tensor  # [V, 16] packed rows


class NDTResult(NamedTuple):
    transform: torch.Tensor  # [4, 4] (host)
    converged: bool
    iterations: int
    trans_probability: torch.Tensor  # scalar (host)
    pose6: torch.Tensor  # [6] (host)
    # Derivative evaluations (1 init + every line-search trial) and stats
    # gathers, counted as the JAX package counts them.
    evaluations: int = 0
    gathers: int = 0
    # Device-to-host copies the align waited on (one per evaluation).
    host_syncs: int = 0


class NeighborhoodStats(NamedTuple):
    """Per-(offset, point) voxel stats ``packed [10, K*N]``, offset-major:
    rows 0-2 mean, 3-8 icov sym, 9 the validity gate as 0/1."""

    packed: torch.Tensor

    @property
    def valid(self):
        return self.packed[9] > 0.5


def gauss_coefficients(resolution, outlier_ratio):
    """Gaussian mixture constants d1, d2, d3 (eq. 6.8 [Magnusson 2009];
    ``ndt_omp_impl.hpp:86-93``) as Python floats."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / resolution**3
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2, d3


def build_ndt_map(target: PointCloud, config: NDTConfig) -> NDTMap:
    """Build the searchable voxel-Gaussian map
    (``voxel_grid_covariance_omp_impl.hpp:48-370``).

    Covariances are two-pass and centred in voxel-corner coordinates, as in
    the JAX package: pass 1 sums corner-relative coordinates per voxel,
    pass 2 sums exactly mean-centred products. It is the one-row form of
    ``build_ndt_map_lanes``.
    """
    lanes = build_ndt_map_lanes(
        PointCloud(target.xyzi[None], target.mask[None]), config)
    return NDTMap(*(f[0] for f in lanes))


@spanned("ndt.build_map")
def build_ndt_map_lanes(targets: PointCloud, config: NDTConfig) -> NDTMap:
    """``build_ndt_map`` of B targets at once (``xyzi [B, N, 4]``, ``mask
    [B, N]``): an NDTMap whose fields have a leading B, each lane in its
    own grid and bit-identical to ``build_ndt_map`` of it alone. One
    lane-major sort, one segment sum a pass, one eigensolve and one hash
    scatter (into ``[B, grid_capacity, 16]``) serve every lane."""
    dtype = targets.xyzi.dtype
    dev = targets.xyzi.device
    cap = config.grid_capacity
    if cap & (cap - 1):
        raise ValueError(f"grid_capacity {cap} is not a power of two")
    B, n = targets.mask.shape
    if B * cap >= 2**31:
        raise ValueError(f"{B} lanes of {cap} hash rows exceed int32 slots")
    V = config.map_capacity
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = zero + 1.0
    res_t = zero + config.resolution

    px, py, pz, _ = targets.xyzi.unbind(-1)
    _, min_b, div, vid = voxel_grid_lanes(px, py, pz, targets.mask,
                                          config.resolution)
    div_mul = div_mul_lanes(div)

    sorted_vid, order = sort_lanes(vid)
    sx, sy, sz = (c.reshape(-1)[order] for c in (px, py, pz))
    first, pos, n_unique = run_bookkeeping_lanes(sorted_vid)
    # Points of voxels beyond the slot capacity drop out of the map.
    in_map = (sorted_vid != INT_MAX) & (pos < V)

    d0 = div[:, 0:1].clamp(min=1)
    d1_ = div[:, 1:2].clamp(min=1)
    d01 = (div[:, 0:1] * div[:, 1:2]).clamp(min=1)
    mb = [min_b[:, a:a + 1] for a in range(3)]

    def corner(ids):
        return (ids % d0, (ids // d0) % d1_, ids // d01)

    pid = torch.where(sorted_vid == INT_MAX, 0, sorted_vid)
    pi_, pj_, pk_ = corner(pid)
    cx = torch.where(in_map, sx - (pi_ + mb[0]) * res_t, zero)
    cy = torch.where(in_map, sy - (pj_ + mb[1]) * res_t, zero)
    cz = torch.where(in_map, sz - (pk_ + mb[2]) * res_t, zero)

    acc1, starts = seg_reduce_lanes(
        sorted_vid, torch.stack([in_map.to(dtype), cx, cy, cz], -1),
        first, pos, V)
    d_seg = acc1[..., 1:] / acc1[..., :1].clamp(min=1.0)
    d_pt = seg_broadcast_lanes(d_seg, pos)
    ex = torch.where(in_map, cx - d_pt[..., 0], zero)
    ey = torch.where(in_map, cy - d_pt[..., 1], zero)
    ez = torch.where(in_map, cz - d_pt[..., 2], zero)
    acc2, _ = seg_reduce_lanes(
        sorted_vid,
        torch.stack([ex * ex, ex * ey, ex * ez, ey * ey, ey * ez, ez * ez],
                    -1),
        first, pos, V)

    occupied = torch.arange(V, device=dev) < n_unique[:, None]
    unique_ids = torch.where(
        occupied, sorted_vid.reshape(-1)[starts.clamp(max=B * n - 1)],
        INT_MAX)
    cnt = torch.where(occupied, acc1[..., 0], zero)
    cnt_safe = cnt.clamp(min=1.0)
    d_slot = acc1[..., 1:] / cnt_safe[..., None]
    si, sj, sk = corner(torch.where(unique_ids == INT_MAX, 0, unique_ids))
    mean_x = (si + mb[0]).to(dtype) * res_t + d_slot[..., 0]
    mean_y = (sj + mb[1]).to(dtype) * res_t + d_slot[..., 1]
    mean_z = (sk + mb[2]).to(dtype) * res_t + d_slot[..., 2]
    corr = (cnt_safe - 1.0) / (cnt_safe * cnt_safe)
    v00, v01, v02, v11, v12, v22 = (acc2 * corr[..., None]).unbind(-1)

    (l0, l1, l2), vec = eigh3_soa(v00, v01, v02, v11, v12, v22)
    # Roundoff-scale negative eigenvalues clamp to zero; genuinely
    # indefinite covariances are rejected.
    tol = 1e-5 * l2.clamp(min=0.0)
    eig_ok = (l0 >= -tol) & (l1 >= -tol) & (l2 > 0)
    l0 = l0.clamp(min=0.0)
    l1 = l1.clamp(min=0.0)

    # Eq. 6.11 inflation: eigenvalues below mult * lambda_max are raised.
    min_ev = config.min_covar_eigvalue_mult * l2
    needs = l0 < min_ev
    li0 = torch.maximum(l0, min_ev)
    li1 = torch.maximum(l1, min_ev)

    def recompose(i, j):
        return (li0 * vec[i * 3 + 0] * vec[j * 3 + 0]
                + li1 * vec[i * 3 + 1] * vec[j * 3 + 1]
                + l2 * vec[i * 3 + 2] * vec[j * 3 + 2])

    v00 = torch.where(needs, recompose(0, 0), v00)
    v01 = torch.where(needs, recompose(0, 1), v01)
    v02 = torch.where(needs, recompose(0, 2), v02)
    v11 = torch.where(needs, recompose(1, 1), v11)
    v12 = torch.where(needs, recompose(1, 2), v12)
    v22 = torch.where(needs, recompose(2, 2), v22)

    # Closed-form symmetric 3x3 inverse (adjugate / det).
    A = v11 * v22 - v12 * v12
    B_ = -(v01 * v22 - v12 * v02)
    C = v01 * v12 - v11 * v02
    det = v00 * A + v01 * B_ + v02 * C
    inv_det = torch.where(det != 0, 1.0 / torch.where(det == 0, one, det),
                          zero)
    icov = [A * inv_det, B_ * inv_det, C * inv_det,
            (v00 * v22 - v02 * v02) * inv_det,
            -(v00 * v12 - v01 * v02) * inv_det,
            (v00 * v11 - v01 * v01) * inv_det]
    icov_ok = torch.stack([torch.isfinite(c) for c in icov]).all(0) & (
        det.abs() > 0)

    valid = ((cnt >= config.min_points_per_voxel) & (unique_ids != INT_MAX)
             & eig_ok & icov_ok)
    vw = valid.to(dtype)
    icov6 = torch.stack([c * vw for c in icov], 1)
    mean3 = torch.stack([mean_x, mean_y, mean_z], 1)
    vid_lo = torch.where(valid, unique_ids & 0xFFFF, -1).to(dtype)
    vid_hi = torch.where(valid, unique_ids >> 16, -1).to(dtype)
    table = torch.cat([mean3, icov6, vw[:, None], vid_lo[:, None],
                       vid_hi[:, None],
                       torch.zeros((B, 4, V), dtype=dtype, device=dev)],
                      1).transpose(1, 2)

    # Hash-addressed rows: add-form scatter of every valid row to slot
    # vid & (cap - 1) of its lane's table. Two aliased voxels add their
    # rows; the valid flag of the sum is 2 and the gather's
    # exactly-one-voxel gate drops both, so the order of a collided sum
    # never reaches a result.
    ok_row = valid & (unique_ids != INT_MAX)
    lane_row0 = torch.arange(B, device=dev)[:, None] * cap
    h_safe = torch.where(ok_row, unique_ids & (cap - 1), 0).long() + lane_row0
    hash_table = torch.zeros((B * cap, 16), dtype=dtype,
                             device=dev).index_add_(
        0, h_safe.reshape(-1),
        torch.where(ok_row[..., None], table, zero).reshape(B * V, 16))

    return NDTMap(
        unique_ids=unique_ids,
        valid=valid,
        min_b=min_b,
        div=div,
        div_mul=div_mul,
        hash_table=hash_table.view(B, cap, 16),
        vid_of_slot=torch.where(valid, unique_ids, INT_MAX),
        mean3=mean3,
        icov6=icov6,
        table=table.contiguous(),
    )


_OFFSETS = {
    "DIRECT1": [(0, 0, 0)],
    "DIRECT7": [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1)],
    "DIRECT27": [
        (i, j, k) for i in (0, 1, -1) for j in (0, 1, -1) for k in (0, 1, -1)
    ],
}


def lookup_neighbors(ndt_map: NDTMap, query_xyz, resolution, offsets):
    """Neighbour voxel slots of each query point, ``(slot [N, K] int32,
    found [N, K] bool)`` (``getNeighborhoodAtPoint{,7,1}``,
    ``voxel_grid_covariance_omp_impl.hpp:372-442``): a debug and parity
    API; the align reads rows from ``hash_table``."""
    ijk = torch.floor(query_xyz * (1.0 / resolution)).to(torch.int32) \
        - ndt_map.min_b
    off = torch.tensor(offsets, dtype=torch.int32, device=query_xyz.device)
    nijk = ijk[:, None, :] + off[None, :, :]  # [N, K, 3]
    in_bounds = ((nijk >= 0) & (nijk < ndt_map.div)).all(-1)
    nvid = (nijk * ndt_map.div_mul).sum(-1, dtype=torch.int32)
    ok = in_bounds & (nvid >= 0)
    slot = torch.searchsorted(ndt_map.unique_ids, nvid).clamp(
        max=ndt_map.unique_ids.shape[0] - 1)
    found = ok & (ndt_map.vid_of_slot[slot] == nvid)
    return slot.to(torch.int32), found


def _centroid_sqdist(ndt_map: NDTMap, query_xyz):
    """[Q, V] squared distances from the queries to the voxel means,
    ``|q|^2 + |c|^2 - 2 q.c`` clamped at 0; invalid slots get the dtype's
    largest value so that they rank last."""
    mu = ndt_map.mean3  # [3, V]
    qn = (query_xyz * query_xyz).sum(-1, keepdim=True)
    cn = (mu * mu).sum(0)
    d2 = (qn + cn[None, :] - 2.0 * (query_xyz @ mu)).clamp(min=0.0)
    return torch.where(ndt_map.valid[None, :], d2, torch.finfo(d2.dtype).max)


def nearest_k_search(ndt_map: NDTMap, query_xyz, k: int):
    """The k nearest valid voxels by centroid distance
    (``VoxelGridCovariance::nearestKSearch``): ``(idx [Q, k] int32 slots,
    sqdist [Q, k], found [Q, k])``; found is False only where the map holds
    fewer than k valid voxels. Ties rank in ``torch.topk``'s order."""
    neg, idx = torch.topk(-_centroid_sqdist(ndt_map, query_xyz), k)
    found = ndt_map.valid[idx]
    return idx.to(torch.int32), torch.where(found, -neg, 0.0), found


def radius_search(ndt_map: NDTMap, query_xyz, radius, max_nn: int):
    """Valid voxels with centroid within ``radius``, nearest first
    (``VoxelGridCovariance::radiusSearch``), at a fixed shape: ``(idx,
    sqdist, found)`` of the up to ``max_nn`` nearest, each ``[Q, max_nn]``,
    and the total in-radius count ``[Q]`` int32, so that a caller sees
    truncation."""
    d2 = _centroid_sqdist(ndt_map, query_xyz)
    # radius^2 rounded in the distances' dtype, as JAX squares it there
    # (a host scalar: no device copy).
    within = d2 <= (torch.tensor(radius, dtype=d2.dtype) ** 2).item()
    count = within.sum(-1).to(torch.int32)
    neg, idx = torch.topk(-d2, max_nn)
    found = torch.take_along_dim(within, idx, dim=-1)
    return (idx.to(torch.int32), torch.where(found, -neg, 0.0), found, count)


def _angle_tables(p):
    """Angular derivative tables j [8, 3] and h [15, 3] on the host, in p's
    dtype (eqs. 6.19/6.21 [Magnusson 2009]; ``ndt_omp_impl.hpp:287-395``,
    with the float-path h_ang d1 sign fixed)."""
    dt = p.dtype.type
    small = dt(10e-5)

    def cs(a):
        if np.abs(a) < small:
            return dt(1.0), dt(0.0)
        return np.cos(a), np.sin(a)

    cx, sx = cs(p[3])
    cy, sy = cs(p[4])
    cz, sz = cs(p[5])
    z = dt(0.0)
    j = np.array([
        [-sx * sz + cx * sy * cz, -sx * cz - cx * sy * sz, -cx * cy],
        [cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy],
        [-sy * cz, sy * sz, cy],
        [sx * cy * cz, -sx * cy * sz, sx * sy],
        [-cx * cy * cz, cx * cy * sz, -cx * sy],
        [-cy * sz, -cy * cz, z],
        [cx * cz - sx * sy * sz, -cx * sz - sx * sy * cz, z],
        [sx * cz + cx * sy * sz, cx * sy * cz - sx * sz, z],
    ], dtype=p.dtype)
    h = np.array([
        [-cx * sz - sx * sy * cz, -cx * cz + sx * sy * sz, sx * cy],
        [-sx * sz + cx * sy * cz, -cx * sy * sz - sx * cz, -cx * cy],
        [cx * cy * cz, -cx * cy * sz, cx * sy],
        [sx * cy * cz, -sx * cy * sz, sx * sy],
        [-sx * cz - cx * sy * sz, sx * sz - cx * sy * cz, z],
        [cx * cz - sx * sy * sz, -sx * sy * cz - cx * sz, z],
        [-cy * cz, cy * sz, -sy],
        [-sx * sy * cz, sx * sy * sz, sx * cy],
        [cx * sy * cz, -cx * sy * sz, -cx * cy],
        [sy * sz, sy * cz, z],
        [-sx * cy * sz, -sx * cy * cz, z],
        [cx * cy * sz, cx * cy * cz, z],
        [-cy * cz, cy * sz, z],
        [-cx * sz - sx * sy * cz, -cx * cz + sx * sy * sz, z],
        [-sx * sz + cx * sy * cz, -cx * sy * sz - sx * cz, z],
    ], dtype=p.dtype)
    return j, h


def _pose_matrix(p):
    """Host 4x4 of a host pose6 (numpy in, numpy out)."""
    return se3.pose6_to_matrix(torch.from_numpy(p)).numpy()


def _unpack(sums):
    """[28] host sums -> (score, grad [6], hess [6, 6])."""
    rows, cols = np.triu_indices(6)
    hess = np.zeros((6, 6), sums.dtype)
    hess[rows, cols] = sums[7:]
    hess[cols, rows] = sums[7:]
    return sums[0], sums[1:7], hess


class _LaneEvaluator:
    """The device side of B aligns in lockstep (B = 1 for one align): the
    lane map, the sources [B, 3, N], the lanes' frozen neighbourhoods
    [B, 10, K*N], one batched gather and one batched evaluation a round.
    A round that names every lane in order needs no lane ids: the kernels
    then take grid row y as lane y, and the gather writes ``stats`` whole.
    ``host_syncs`` counts the rounds' device-to-host copies."""

    def __init__(self, ndt_map, src_xyz, src_mask, resolution, offsets,
                 d1, d2):
        self.map = ndt_map
        self.dev = src_xyz.device
        self.dtype = src_xyz.dtype
        self.np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        self.B, self.N = src_mask.shape
        self.xyz = src_xyz[..., :3].transpose(1, 2).contiguous()  # [B, 3, N]
        self.mask = src_mask.contiguous()
        self.K = len(offsets)
        self.cap = ndt_map.hash_table.shape[1]
        # One non-blocking upload (no wait on the map's build): the offsets
        # [K, 3] and each lane's first row in the [B * cap, 16] table.
        consts = torch.tensor(np.concatenate(
            [np.ravel(offsets), np.arange(self.B) * self.cap]),
            dtype=torch.int32).to(self.dev, non_blocking=True)
        self.offsets = consts[:3 * self.K].view(self.K, 3)
        self.row0 = consts[3 * self.K:, None]
        self.inv_leaf = 1.0 / resolution
        self.d12 = np.array([d1, d2], self.np_dtype)
        self.stats = None  # [B, 10, K*N], a lane's row set by its gathers
        self.n_src = None
        self.host_syncs = 0

    def params(self, poses):
        """Host poses -> the [L, 83] device parameters (a non-blocking
        copy: no host sync)."""
        host = np.stack([np.concatenate(
            [self.d12, _pose_matrix(p)[:3, :].ravel(), j.ravel(), h.ravel()])
            for p, (j, h) in ((p, _angle_tables(p)) for p in poses)])
        return torch.from_numpy(host).to(self.dev, non_blocking=True)

    def lane_ids(self, lanes):
        """The device ids of ``lanes`` (sorted, distinct), or None when they
        are every lane."""
        if len(lanes) == self.B:
            return None
        return torch.tensor(lanes, dtype=torch.int32).to(self.dev,
                                                         non_blocking=True)

    @spanned("ndt.gather")
    def gather(self, lanes, poses, params=None):
        """The frozen neighbourhoods of ``lanes`` at their host poses (or at
        their ``params`` already on the device): the plain neighbour hash
        over the lanes at once, one K2 launch over the lanes' pairs in the
        [B*cap, 16] table, and the lanes' rows of ``stats``."""
        m = self.map
        if params is None:
            params = self.params(poses)
        ids = self.lane_ids(lanes)
        if ids is None:  # whole tensors (views), each lane's first row
            idx, row0 = slice(None), self.row0
        else:
            idx, row0 = ids.long(), ids[:, None] * self.cap
        h, nvid, okm = ndt_kernels.ndt_neighbor_hash_lanes_plain(
            params, self.xyz[idx], self.mask[idx], m.min_b[idx], m.div[idx],
            self.cap, self.inv_leaf, self.offsets, row0)
        packed = ndt_kernels.ndt_gather_repack(
            m.hash_table.view(self.B * self.cap, 16), h.reshape(-1),
            nvid.reshape(-1), okm.reshape(-1))
        packed = packed.view(10, len(lanes), -1).transpose(0, 1)
        if ids is None:
            self.stats = packed.contiguous()  # a view at one lane
            return
        if self.stats is None:
            self.stats = torch.zeros((self.B,) + packed.shape[1:],
                                     dtype=self.dtype, device=self.dev)
        self.stats[idx] = packed

    def sums(self, params, lanes, frozen):
        """The [L, 28] device sums of ``lanes`` at ``params``: one K3 launch
        against their frozen neighbourhoods, or one K1 launch."""
        m = self.map
        ids = self.lane_ids(lanes)
        if frozen:
            return ndt_kernels.ndt_terms_packed_lanes(params, self.xyz,
                                                      self.stats, ids)
        return ndt_kernels.ndt_terms_gathered_lanes(
            params, self.xyz, self.mask, m.hash_table, m.min_b, m.div,
            self.inv_leaf, self.offsets, ids)

    @spanned("ndt.derivs")
    def derivs(self, requests):
        """Host (score, grad, hess) of every request ``(lane, pose, frozen)``
        in one device-to-host copy: one K1 launch over the fresh ones and
        one K3 launch over the frozen ones (the first round also carries
        each lane's source point count)."""
        sums, order = [], []
        for frozen in (False, True):
            group = [r for r in requests if r[2] == frozen]
            if group:
                lanes = [r[0] for r in group]
                sums.append(self.sums(self.params([r[1] for r in group]),
                                      lanes, frozen))
                order += lanes
        flat = (sums[0] if len(sums) == 1 else torch.cat(sums)).reshape(-1)
        if self.n_src is None:
            counts = self.mask.sum(1, dtype=flat.dtype)
            host = _to_host(torch.cat([flat, counts]))
            flat, self.n_src = host[:-self.B], np.maximum(host[-self.B:], 1)
        else:
            flat = _to_host(flat)
        self.host_syncs += 1
        rows = flat.reshape(len(order), ndt_kernels.N_TERMS)
        return dict(zip(order, (_unpack(r) for r in rows)))


def _to_host(t):
    """A round's device-to-host copy (its host sync), as numpy."""
    with span("ndt.sync"):
        return t.cpu().numpy()


def _single_lane(ndt_map, src_xyz, src_mask, resolution, offsets, d1, d2):
    """The evaluator of one source ``[N, 3+]`` against one map."""
    return _LaneEvaluator(NDTMap(*(f[None] for f in ndt_map)), src_xyz[None],
                          src_mask[None], resolution, offsets, d1, d2)


def gather_neighborhood(ndt_map, src_xyz, src_mask, p, resolution,
                        offsets) -> NeighborhoodStats:
    """Voxel stats of every (DIRECT offset, source point) at pose6 ``p``."""
    ev = _single_lane(ndt_map, src_xyz, src_mask, resolution, offsets, 0, 0)
    ev.gather([0], [np.asarray(p, ev.np_dtype)])
    return NeighborhoodStats(ev.stats[0])


def compute_derivatives(ndt_map, src_xyz, src_mask, p, d1, d2, resolution,
                        offsets, stats: NeighborhoodStats | None = None, *,
                        compute_hessian: bool = True):
    """Score, gradient [6] and Hessian [6, 6] of the NDT objective at pose6
    ``p`` (``computeDerivatives``, ``ndt_omp_impl.hpp:178-285``), as host
    tensors. ``stats`` evaluates against a frozen neighbourhood. With
    ``compute_hessian=False`` the Hessian is None; the same 28 sums are
    computed either way."""
    ev = _single_lane(ndt_map, src_xyz, src_mask, resolution, offsets, d1, d2)
    if stats is not None:
        ev.stats = stats.packed[None]
    sums = ev.sums(ev.params([np.asarray(p, ev.np_dtype)]), [0],
                   stats is not None)[0].cpu().numpy()
    out = _unpack(sums) if compute_hessian else (sums[0], sums[1:7], None)
    return tuple(None if a is None else torch.from_numpy(np.asarray(a))
                 for a in out)


# ----------------------------------------------------------------------------
# More-Thuente line search (More & Thuente 1994; ``ndt_omp_impl.hpp:647-932``)
# as host scalar logic in the source dtype.
# ----------------------------------------------------------------------------


def _safe(x):
    return x if x != 0 else np.finfo(type(x)).tiny


def _cubic_min(a_lo, f_lo, g_lo, a_hi, f_hi, g_hi):
    dt = type(a_lo)
    z = dt(3.0) * (f_hi - f_lo) / _safe(a_hi - a_lo) - g_hi - g_lo
    w = np.sqrt(np.maximum(z * z - g_hi * g_lo, dt(0.0)))
    return a_lo + (a_hi - a_lo) * (w - g_lo - z) / _safe(
        g_hi - g_lo + dt(2.0) * w)


def _trial_value_selection(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """Four-case trial value selection (``trialValueSelectionMT``,
    ``ndt_omp_impl.hpp:689-769``)."""
    dt = type(a_l)
    if f_t > f_l:
        a_c = _cubic_min(a_l, f_l, g_l, a_t, f_t, g_t)
        a_q = a_l - dt(0.5) * (a_l - a_t) * g_l / _safe(
            g_l - (f_l - f_t) / _safe(a_l - a_t))
        if np.abs(a_c - a_l) < np.abs(a_q - a_l):
            return a_c
        return dt(0.5) * (a_q + a_c)
    a_s = a_l - (a_l - a_t) / _safe(g_l - g_t) * g_l
    if g_t * g_l < 0:
        a_c = _cubic_min(a_l, f_l, g_l, a_t, f_t, g_t)
        return a_c if np.abs(a_c - a_t) >= np.abs(a_s - a_t) else a_s
    if np.abs(g_t) <= np.abs(g_l):
        a_c = _cubic_min(a_l, f_l, g_l, a_t, f_t, g_t)
        a_n = a_c if np.abs(a_c - a_t) < np.abs(a_s - a_t) else a_s
        bound = a_t + dt(0.66) * (a_u - a_t)
        return np.minimum(bound, a_n) if a_t > a_l else np.maximum(bound, a_n)
    return _cubic_min(a_u, f_u, g_u, a_t, f_t, g_t)


def _update_interval(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """Interval update (``updateIntervalMT``, ``ndt_omp_impl.hpp:648-686``):
    new endpoints + converged flag."""
    if f_t > f_l:
        return a_l, f_l, g_l, a_t, f_t, g_t, False
    if g_t * (a_l - a_t) > 0:
        return a_t, f_t, g_t, a_u, f_u, g_u, False
    if g_t * (a_l - a_t) < 0:
        return a_t, f_t, g_t, a_l, f_l, g_l, False
    return a_l, f_l, g_l, a_u, f_u, g_u, True


def _align_steps(p0, config: NDTConfig):
    """The host logic of one align as a generator, in the source dtype of
    the host pose ``p0``: it yields ``("gather", p)`` (a fresh
    neighbourhood at pose p for the frozen line search; nothing is sent
    back) and ``("eval", p, frozen)`` (the derivatives at p, from the last
    gathered neighbourhood if ``frozen``, else fresh through K1; the caller
    sends back host ``(score, grad, hess)``), and returns ``(p, iterations,
    failed, score, evaluations, gathers)``. ``_align_lanes`` drives one a
    lane in lockstep."""
    dt = p0.dtype.type
    step_max = dt(config.step_size)
    step_min = dt(config.transformation_epsilon / 2.0)
    eps = dt(config.transformation_epsilon)
    mu = dt(1.0e-4)
    nu = dt(0.9)
    frozen = config.frozen_linesearch

    def clip_step(a):
        return np.minimum(np.maximum(a, step_min), step_max)

    def line_search(p, step_dir, step_init, score, grad, hess, gathered):
        """Returns (a_t, p_new, score, grad, hess, evaluations)."""
        phi_0 = -score
        d_phi_0 = -np.dot(grad, step_dir)
        if d_phi_0 > 0:  # not a descent direction: reverse
            step_dir = -step_dir
            d_phi_0 = -d_phi_0
        zero_dir = d_phi_0 == 0

        a_t = clip_step(step_init)
        if frozen and not gathered:
            # One gather at the first trial point; further trials reuse it.
            yield ("gather", p + step_dir * a_t)
        # The first trial is evaluated (and counted) even on a zero
        # direction, as in the JAX program.
        score_t, grad_t, hess_t = yield ("eval", p + step_dir * a_t, frozen)
        phi_t = -score_t
        d_phi_t = -np.dot(grad_t, step_dir)
        psi_t = phi_t - phi_0 - mu * d_phi_0 * a_t
        d_psi_t = d_phi_t - mu * d_phi_0

        a_l = a_u = f_l = f_u = dt(0.0)
        g_l = g_u = (dt(1.0) - mu) * d_phi_0
        open_ = True
        interval_converged = False
        it = 0
        while (not interval_converged and it < config.max_step_iterations
               and not (psi_t <= 0 and d_phi_t <= -nu * d_phi_0)
               and not zero_dir):
            f_sel, g_sel = (psi_t, d_psi_t) if open_ else (phi_t, d_phi_t)
            a_t = clip_step(_trial_value_selection(
                a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_sel, g_sel))
            score_t, grad_t, hess_t = yield ("eval", p + step_dir * a_t,
                                             frozen)
            phi_t = -score_t
            d_phi_t = -np.dot(grad_t, step_dir)
            psi_t = phi_t - phi_0 - mu * d_phi_0 * a_t
            d_psi_t = d_phi_t - mu * d_phi_0
            if open_ and psi_t <= 0 and d_psi_t >= 0:
                # psi -> phi endpoint conversion on close (``:894-905``)
                open_ = False
                f_l = f_l + phi_0 - mu * d_phi_0 * a_l
                g_l = g_l + mu * d_phi_0
                f_u = f_u + phi_0 - mu * d_phi_0 * a_u
                g_u = g_u + mu * d_phi_0
            f_upd, g_upd = (psi_t, d_psi_t) if open_ else (phi_t, d_phi_t)
            a_l, f_l, g_l, a_u, f_u, g_u, interval_converged = (
                _update_interval(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_upd,
                                 g_upd))
            it += 1
        if zero_dir:
            return dt(0.0), p + step_dir * dt(0.0), score, grad, hess, 1 + it
        return a_t, p + step_dir * a_t, score_t, grad_t, hess_t, 1 + it

    turbo = frozen and config.regather_iterations < (1 << 29)
    if turbo:
        yield ("gather", p0)
    score, grad, hess = yield ("eval", p0, turbo)
    p = p0
    it = 0
    converged = failed = False
    evals = gathers = 1  # the init evaluation and its gather

    def newton_step(mode):
        """One Newton iteration; mode: "exact" (fresh gathers inside the
        line search), "gather" (regather at the predicted first trial
        point) or "frozen" (keep the last neighbourhood)."""
        nonlocal p, score, grad, hess, it, converged, failed, evals, gathers
        if np.isfinite(hess).all() and np.isfinite(grad).all():
            delta_p = se3.svd_solve(torch.from_numpy(hess),
                                    torch.from_numpy(-grad)).numpy()
        else:  # the SVD of a non-finite matrix is NaN (JAX) or raises (torch)
            delta_p = np.full(6, np.nan, p0.dtype)
        norm = np.linalg.norm(delta_p)
        degenerate = norm == 0 or not np.isfinite(norm)
        step_dir = delta_p / (dt(1.0) if degenerate else norm)
        if mode == "gather":
            d_phi_0 = -np.dot(grad, step_dir)
            dir_eff = -step_dir if d_phi_0 > 0 else step_dir
            yield ("gather", p + dir_eff * clip_step(norm))
        a_t, p_new, score_n, grad_n, hess_n, n_ev = yield from line_search(
            p, step_dir, norm, score, grad, hess, mode != "exact")
        if not degenerate:
            p, score, grad, hess = p_new, score_n, grad_n, hess_n
        # Reference check order (``ndt_omp_impl.hpp:158-162``): the eps test
        # is skipped on iteration 0.
        converged = bool(degenerate or it > config.max_iterations
                         or (it >= 1 and np.abs(a_t) < eps))
        failed = failed or not np.isfinite(norm)
        evals += n_ev
        gathers += {"exact": n_ev, "gather": 1, "frozen": 0}[mode]
        it += 1

    if turbo:
        while not converged and it < config.regather_iterations:
            yield from newton_step("gather")
        while not converged:
            yield from newton_step("frozen")
    else:
        while not converged:
            yield from newton_step("exact")
    return p, it, failed, score, evals, gathers


def _guess_pose6(guess, dtype):
    """Host pose6 of a 4x4 guess (identity when None), in ``dtype``."""
    if guess is None:
        guess = torch.eye(4, dtype=dtype)
    return se3.matrix_to_pose6(
        torch.as_tensor(guess).detach().to("cpu", dtype)).numpy()


def ndt_align(ndt_map: NDTMap, source: PointCloud, guess=None,
              config: NDTConfig = NDTConfig()) -> NDTResult:
    """Align ``source`` to the map: Newton on the 6-dof Euler chart with
    More-Thuente step control (``computeTransformation``,
    ``ndt_omp_impl.hpp:80-171``; ``computeStepLengthMT``, ``:772-932``).

    Control flow, iteration and evaluation counts follow the JAX package's
    ``ndt_align`` exactly, including its three neighbourhood modes: exact
    (fresh gather per evaluation), frozen line search (one gather per
    Newton iteration) and turbo (regather for ``regather_iterations``
    iterations, then keep the last neighbourhood). It is
    ``ndt_align_lanes`` at one lane, over views of the map and source.
    """
    return _lane0(ndt_align_lanes(
        NDTMap(*(f[None] for f in ndt_map)),
        PointCloud(source.xyzi[None], source.mask[None]),
        None if guess is None else [guess], config))


def _lane0(r: NDTResult) -> NDTResult:
    """Lane 0 of a lane result as one align's: python bool and ints, a
    [4, 4] transform, a 0-d ``trans_probability``."""
    return NDTResult(r.transform[0], bool(r.converged[0]),
                     int(r.iterations[0]), r.trans_probability[0],
                     r.pose6[0], *(int(f[0]) for f in r[5:]))


@spanned("ndt.align")
def ndt_align_lanes(ndt_map: NDTMap, sources: PointCloud, guesses=None,
                    config: NDTConfig = NDTConfig()) -> NDTResult:
    """Align B sources (``xyzi [B, N, 4]``, ``mask [B, N]``) to the lanes
    of a lane map (``build_ndt_map_lanes``) from ``guesses [B, 4, 4]``
    (identity when None), in lockstep (``_align_lanes``): each lane runs
    its own host logic, and each round brings every running lane one
    evaluation in one K1 or K3 launch over those lanes, after one batched
    plain hash and one K2 launch for the lanes that regather, with one
    device-to-host copy of their sums: one host sync a round for all lanes.
    Finished lanes drop out of the launches.

    Returns an NDTResult with a leading B (tensors on the host): each lane's
    pose, iterations, evaluations and gathers equal its source aligned
    alone, bit for bit (as JAX's ``vmap`` masks finished lanes);
    ``host_syncs`` is the rounds, the same for every lane."""
    d1, d2, _ = gauss_coefficients(config.resolution, config.outlier_ratio)
    ev = _LaneEvaluator(ndt_map, sources.xyzi, sources.mask,
                        config.resolution, _OFFSETS[config.search_method],
                        d1, d2)
    if guesses is None:
        guesses = [None] * ev.B
    return _align_lanes(ev, guesses, config)


def _align_lanes(ev, guesses, config: NDTConfig) -> NDTResult:
    """The lockstep loop over an evaluator of ``_LaneEvaluator``'s protocol
    (``dtype``, ``gather(lanes, poses)``, ``derivs(requests)``, ``n_src``
    [B], ``host_syncs``; ``parallel/batch.sharded_align`` passes one over
    point shards): one ``_align_steps`` generator a guess, and each round
    one gather of the lanes that regather, then one evaluation of every
    running lane. Returns the lanes' NDTResult (leading B)."""
    steps = [_align_steps(_guess_pose6(g, ev.dtype), config) for g in guesses]
    B = len(steps)
    pending, done = {}, {}

    def advance(b, reply):
        try:
            pending[b] = steps[b].send(reply)
        except StopIteration as stop:
            pending.pop(b, None)
            done[b] = stop.value

    for b in range(B):
        advance(b, None)
    while pending:
        regather = sorted(b for b, r in pending.items() if r[0] == "gather")
        if regather:
            ev.gather(regather, [pending[b][1] for b in regather])
            for b in regather:
                advance(b, None)
        live = sorted(pending)
        replies = ev.derivs([(b, pending[b][1], pending[b][2])
                             for b in live])
        for b in live:
            advance(b, replies[b])

    out = [done[b] for b in range(B)]
    pose6 = [torch.from_numpy(o[0]) for o in out]

    def ints(i):
        return torch.tensor([o[i] for o in out], dtype=torch.int32)

    return NDTResult(
        transform=torch.stack([se3.pose6_to_matrix(p) for p in pose6]),
        converged=torch.tensor([not o[2] for o in out]),
        iterations=ints(1),
        trans_probability=torch.stack([
            torch.from_numpy(np.asarray(o[3] / ev.n_src[b]))
            for b, o in enumerate(out)]),
        pose6=torch.stack(pose6),
        evaluations=ints(4),
        gathers=ints(5),
        host_syncs=torch.full((B,), ev.host_syncs, dtype=torch.int32),
    )


def fitness_score(source: PointCloud, target: PointCloud, transform,
                  max_range: float = math.inf):
    """Mean squared nearest-neighbour distance of the transformed source
    points in the target (``pcl::Registration::getFitnessScore``), over the
    valid source points within ``max_range``; a 0-d tensor on the clouds'
    device. The nearest neighbour is K4's: ``partial + |s|^2`` is the
    squared distance, clamped at 0, and invalid target points carry the
    1e30 ``|t|^2`` sentinel."""
    xyz = source.xyzi[:, :3]
    T = torch.as_tensor(transform).to(xyz.device, xyz.dtype,
                                      non_blocking=True)
    src = (xyz @ T[:3, :3].T + T[:3, 3]).contiguous()
    tgt_t, tsq = nn_kernels.target_operands(target.xyzi[:, :3], target.mask,
                                            1.0e30)
    part, _ = nn_kernels.nearest_neighbor(src, tgt_t, tsq)
    dists = (part + (src * src).sum(1)).clamp(min=0.0)
    use = source.mask & (dists <= max_range * max_range)
    cnt = use.sum().to(xyz.dtype).clamp(min=1.0)
    return torch.where(use, dists, 0.0).sum() / cnt


def display_cloud_from_normals(ndt_map: NDTMap, z):
    """Points ``mean + L z`` of each voxel Gaussian (L the closed-form
    Cholesky factor of the covariance, the inverse of ``icov``) from
    standard normals ``z [V, P, 3]``: ``(xyz [V*P, 3], mask [V*P])``."""
    V, P = z.shape[:2]
    xx, xy, xz, yy, yz, zz = ndt_map.icov6
    A = yy * zz - yz * yz
    B = -(xy * zz - yz * xz)
    C = xy * yz - yy * xz
    det = xx * A + xy * B + xz * C
    safe = torch.where(det.abs() > 1e-20, det, torch.ones_like(det))
    c00, c01, c02 = A / safe, B / safe, C / safe
    c11 = (xx * zz - xz * xz) / safe
    c12 = -(xx * yz - xy * xz) / safe
    c22 = (xx * yy - xy * xy) / safe
    l00 = c00.clamp(min=1e-12).sqrt()
    l10 = c01 / l00
    l20 = c02 / l00
    l11 = (c11 - l10 * l10).clamp(min=1e-12).sqrt()
    l21 = (c12 - l20 * l10) / l11
    l22 = (c22 - l20 * l20 - l21 * l21).clamp(min=1e-12).sqrt()
    sx = l00[:, None] * z[..., 0]
    sy = l10[:, None] * z[..., 0] + l11[:, None] * z[..., 1]
    sz = (l20[:, None] * z[..., 0] + l21[:, None] * z[..., 1]
          + l22[:, None] * z[..., 2])
    pts = ndt_map.mean3.T[:, None, :] + torch.stack([sx, sy, sz], -1)
    mask = ndt_map.valid[:, None].expand(V, P)
    return pts.reshape(-1, 3), mask.reshape(-1)


def sample_display_cloud(ndt_map: NDTMap, generator: torch.Generator,
                         points_per_voxel: int = 100):
    """Gaussian samples around each voxel mean for visualisation
    (``VoxelGridCovariance::getDisplayCloud``,
    ``voxel_grid_covariance_omp_impl.hpp:446-483``): ``(xyz [V*P, 3],
    mask [V*P])``. ``generator`` lives on the map's device."""
    z = torch.randn((ndt_map.valid.shape[0], points_per_voxel, 3),
                    generator=generator, dtype=ndt_map.mean3.dtype,
                    device=ndt_map.mean3.device)
    return display_cloud_from_normals(ndt_map, z)
