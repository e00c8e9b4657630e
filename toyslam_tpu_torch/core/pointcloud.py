"""Fixed-capacity padded point clouds and the voxel downsample (port of
``toyslam_tpu/core/pointcloud.py``).

A cloud is ``xyzi [N, 4]`` plus a ``mask [N]``; invalid lanes carry the
``PAD_COORD`` sentinel so they fall outside every voxel query. Shapes stay
static so that no operation waits on the device for a count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.ops.segment import (INT_MAX, run_bookkeeping_lanes,
                                           seg_reduce_lanes, sort_lanes)

# Sentinel coordinate for padded/invalid points: far outside any map.
PAD_COORD = 1.0e9


class PointCloud(NamedTuple):
    """Padded point cloud: ``xyzi [N, 4]`` + ``mask [N]``."""

    xyzi: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyzi.shape[0]


def from_numpy(points: np.ndarray, capacity: int | None = None,
               dtype=torch.float32, device="cuda") -> PointCloud:
    """Build a padded PointCloud from a [n, 3] or [n, 4] numpy array;
    non-finite points become masked sentinels. The cloud lies on the card
    unless ``device`` names another; without a card the default raises."""
    points = np.asarray(points)
    n = points.shape[0]
    if capacity is None:
        capacity = n
    if points.shape[1] == 3:
        points = np.concatenate([points, np.zeros((n, 1), points.dtype)], 1)
    finite = np.isfinite(points[:, :3]).all(axis=1)
    xyzi = np.full((capacity, 4), PAD_COORD, dtype=np.float64)
    xyzi[:, 3] = 0.0
    k = min(n, capacity)
    xyzi[:k] = points[:k]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:k] = finite[:k]
    xyzi[:k][~finite[:k], :3] = PAD_COORD
    return PointCloud(torch.as_tensor(xyzi, dtype=dtype, device=device),
                      torch.as_tensor(mask, device=device))


def pad_to(cloud: PointCloud, capacity: int) -> PointCloud:
    """Truncate or pad (with masked sentinel lanes) to ``capacity``."""
    n = cloud.capacity
    if n >= capacity:
        return PointCloud(cloud.xyzi[:capacity], cloud.mask[:capacity])
    pad = torch.full((capacity - n, 4), PAD_COORD, dtype=cloud.xyzi.dtype,
                     device=cloud.xyzi.device)
    pad[:, 3] = 0.0
    return PointCloud(
        torch.cat([cloud.xyzi, pad], 0),
        torch.cat([cloud.mask, torch.zeros(capacity - n, dtype=torch.bool,
                                           device=cloud.mask.device)], 0))


def shrink_to(cloud: PointCloud, capacity: int) -> PointCloud:
    """The first ``capacity`` lanes: a downsampled cloud has its valid
    points first, so it can drop its padding (valid points past
    ``capacity`` are lost)."""
    return PointCloud(cloud.xyzi[:capacity], cloud.mask[:capacity])


def transform(cloud: PointCloud, T) -> PointCloud:
    """A rigid transform ``T [4, 4]`` of the valid points; padded lanes
    keep their sentinel, intensity is carried."""
    moved = se3.transform_points(T, cloud.xyzi)
    return PointCloud(torch.where(cloud.mask[:, None], moved, cloud.xyzi),
                      cloud.mask)


def _full(value, like):
    """A 0-d tensor of ``value`` on ``like``'s device, filled there: a
    ``torch.tensor`` of a Python number would be a host-to-device copy
    that waits on the device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _min_max(x, y, z, mask):
    """Per-row bounds of the valid points of [B, N] coordinates: [B, 3]."""
    big = _full(PAD_COORD, x)
    mins = torch.stack([torch.where(mask, c, big).amin(-1) for c in (x, y, z)],
                       -1)
    maxs = torch.stack([torch.where(mask, c, -big).amax(-1)
                        for c in (x, y, z)], -1)
    return mins, maxs


def _voxel_ids(x, y, z, mask, inv_leaf, min_b, div):
    """Linear voxel id per point (``i + j*dx + k*dx*dy``, int32 like the
    reference) of [B, N] coordinates in each row's grid (min_b, div [B,
    3]); invalid points get INT_MAX."""
    ix = torch.floor(x * inv_leaf).to(torch.int32) - min_b[:, 0:1]
    iy = torch.floor(y * inv_leaf).to(torch.int32) - min_b[:, 1:2]
    iz = torch.floor(z * inv_leaf).to(torch.int32) - min_b[:, 2:3]
    vid = ix + iy * div[:, 0:1] + iz * (div[:, 0:1] * div[:, 1:2])
    return torch.where(mask, vid, torch.full_like(vid, INT_MAX))


def voxel_grid_lanes(x, y, z, mask, leaf_size: float):
    """Bounding voxel grid of each row's valid points, coordinates and mask
    [B, N]: ``(inv_leaf, min_b, div, vid)`` with int32 ``min_b``/``div``
    [B, 3] and per-point ids [B, N]."""
    inv_leaf = _full(1.0 / leaf_size, x)
    mn, mx = _min_max(x, y, z, mask)
    min_b = torch.floor(mn * inv_leaf).to(torch.int32)
    max_b = torch.floor(mx * inv_leaf).to(torch.int32)
    div = max_b - min_b + 1
    return inv_leaf, min_b, div, _voxel_ids(x, y, z, mask, inv_leaf, min_b,
                                            div)


def div_mul_lanes(div):
    """The linear id's strides ``[1, dx, dx*dy]`` of grids ``div [B, 3]``."""
    return torch.stack([torch.ones_like(div[:, 0]), div[:, 0],
                        div[:, 0] * div[:, 1]], -1)


def voxel_ids(cloud: PointCloud, leaf_size: float):
    """Per-point linear voxel id over the cloud's bounding grid (VoxelGrid's
    ``i + j*dx + k*dx*dy``, ``voxel_grid_covariance_omp_impl.hpp:86-103``):
    ``(vid [N], min_b [3], div_mul [3])``, int32, with ``div_mul = [1, dx,
    dx*dy]``; invalid points get INT_MAX. The one-cloud form of
    ``voxel_grid_lanes``."""
    x, y, z, _ = cloud.xyzi.unbind(-1)
    _, min_b, div, vid = voxel_grid_lanes(x[None], y[None], z[None],
                                          cloud.mask[None], leaf_size)
    return vid[0], min_b[0], div_mul_lanes(div)[0]


def unique_voxel_slots(vid, out_capacity: int | None = None):
    """Sorted distinct voxel ids and each point's slot among them, for ids
    ``vid [N]`` int32 (INT_MAX: no voxel): ``(unique_ids [V] padded with
    INT_MAX, slot [N], n_unique)``, int32, with ``V = out_capacity or N``.
    Points of voxels beyond the capacity get ``slot == V``; invalid points
    share the last slot before them. No host synchronisation."""
    n = vid.shape[0]
    V = n if out_capacity is None else out_capacity
    sorted_vid, order = sort_lanes(vid[None])
    first, pos, n_unique = run_bookkeeping_lanes(sorted_vid)
    sorted_vid, order, first, pos = sorted_vid[0], order[0], first[0], pos[0]
    # Each kept voxel's first point writes its id; the rest write to a
    # dump slot V that is cut off.
    dest = torch.where(first & (pos < V), pos, V)
    unique_ids = torch.full((V + 1,), INT_MAX, dtype=torch.int32,
                            device=vid.device).scatter_(0, dest, sorted_vid)
    slot = torch.empty_like(vid).scatter_(0, order,
                                          pos.clamp(0, V).to(torch.int32))
    return unique_ids[:V], slot, n_unique[0].to(torch.int32)


def voxel_downsample_lanes(xyzi, mask, leaf_size: float,
                           capacity: int | None = None,
                           with_intensity: bool = True) -> PointCloud:
    """``voxel_downsample`` of B clouds at once, ``xyzi [B, N, 4]`` and
    ``mask [B, N]`` -> a PointCloud of ``[B, capacity, 4]`` / ``[B,
    capacity]``: each row in its own grid, one sort and one segment sum for
    all rows, each row bit-identical to ``voxel_downsample`` of it alone."""
    B, N = mask.shape
    V = N if capacity is None else capacity
    dtype = xyzi.dtype
    x, y, z, inten = xyzi.unbind(-1)
    _, _, _, vid = voxel_grid_lanes(x, y, z, mask, leaf_size)
    sorted_vid, order = sort_lanes(vid)
    in_grid = sorted_vid != INT_MAX
    zero = torch.zeros((), dtype=dtype, device=vid.device)
    chans = [x, y, z] + ([inten] if with_intensity else [])
    vals = torch.stack(
        [in_grid.to(dtype)]
        + [torch.where(in_grid, c.reshape(-1)[order], zero) for c in chans],
        -1)
    first, pos, n_unique = run_bookkeeping_lanes(sorted_vid)
    acc, _ = seg_reduce_lanes(sorted_vid, vals, first, pos, V)  # [B, V, C]
    valid = torch.arange(V, device=vid.device) < n_unique[:, None]
    centroid = acc[..., 1:] / torch.clamp(acc[..., :1], min=1.0)
    if not with_intensity:
        centroid = torch.cat([centroid, torch.zeros_like(centroid[..., :1])],
                             -1)
    out = torch.where(valid[..., None], centroid, zero + PAD_COORD)
    out[..., 3] = torch.where(valid, centroid[..., 3], zero)
    return PointCloud(out, valid)


def voxel_downsample(cloud: PointCloud, leaf_size: float,
                     capacity: int | None = None,
                     with_intensity: bool = True) -> PointCloud:
    """Centroid voxel downsample (pcl::VoxelGrid equivalent).

    Valid lanes come first, one per occupied voxel in ascending voxel-id
    order, each the mean of its points; voxels beyond ``capacity`` (default:
    the input capacity) are dropped. ``with_intensity=False`` emits
    intensity 0 and skips that channel's sums. It is the one-row form of
    ``voxel_downsample_lanes``.
    """
    out = voxel_downsample_lanes(cloud.xyzi[None], cloud.mask[None],
                                 leaf_size, capacity, with_intensity)
    return PointCloud(out.xyzi[0], out.mask[0])
