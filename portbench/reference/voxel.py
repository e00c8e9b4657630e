"""Plain voxel-grid downsample (``pcl::VoxelGrid``) for the reference.

A point's voxel is ``floor(p * (1 / leaf))`` computed in the precision the
cloud is stored in (PCL multiplies the float point by the float inverse
leaf), over the bounding grid of the valid points; the linear id is
``i + j dx + k dx dy`` and voxels come out in ascending id, each the mean
of its points computed in ``dtype``.
"""

from __future__ import annotations

import torch


def voxel_ids(xyz: torch.Tensor, leaf: float):
    """Linear voxel ids (int64) of points ``xyz [n, 3]`` over their
    bounding grid."""
    inv = torch.tensor(1.0 / leaf, dtype=xyz.dtype, device=xyz.device)
    ijk = torch.floor(xyz * inv).to(torch.int64)
    lo = ijk.amin(0)
    div = ijk.amax(0) - lo + 1
    rel = ijk - lo
    return rel[:, 0] + rel[:, 1] * div[0] + rel[:, 2] * div[0] * div[1]


def downsample(xyzi: torch.Tensor, mask: torch.Tensor, leaf: float,
               dtype=torch.float64) -> torch.Tensor:
    """Centroids ``[V, 4]`` (x, y, z, intensity) in ``dtype`` of the valid
    points of ``xyzi [n, 4]``, in ascending voxel id; the ids are taken in
    ``xyzi``'s own precision."""
    pts = xyzi[mask]
    vid = voxel_ids(pts[:, :3], leaf)
    uniq, inv = torch.unique(vid, sorted=True, return_inverse=True)
    acc = torch.zeros((len(uniq), 4), dtype=dtype, device=pts.device)
    acc.index_add_(0, inv, pts.to(dtype))
    cnt = torch.zeros(len(uniq), dtype=dtype, device=pts.device)
    cnt.index_add_(0, inv, torch.ones(len(inv), dtype=dtype,
                                      device=pts.device))
    return acc / cnt[:, None]


def transform(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """``R p + t`` of points ``[n, 3]`` by ``T [4, 4]``, as elementwise
    products (no matrix product, whose precision a setting could change)."""
    R, t = T[:3, :3], T[:3, 3]
    return (xyz[:, 0:1] * R[:, 0] + xyz[:, 1:2] * R[:, 1]
            + xyz[:, 2:3] * R[:, 2] + t)


def merge(map_xyzi: torch.Tensor, scan_xyzi: torch.Tensor, pose: torch.Tensor,
          leaf: float) -> torch.Tensor:
    """The mapping node's refilter (``ndt_rosbag_mapping_node.cpp:146-161``):
    the scan's points moved into the world by ``pose``, appended to the map,
    and the whole downsampled again at ``leaf``."""
    world = torch.cat([transform(scan_xyzi[:, :3], pose), scan_xyzi[:, 3:]],
                      1)
    both = torch.cat([map_xyzi, world], 0)
    return downsample(both, torch.ones(len(both), dtype=torch.bool,
                                       device=both.device), leaf,
                      both.dtype)
