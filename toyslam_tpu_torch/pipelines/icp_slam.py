"""Toy incremental ICP mapping (port of ``toyslam_tpu/pipelines/icp_slam.py``).

The ``ICP/icpslam.py`` story: each frame is ICP-aligned to the
accumulated map from the last pose, chained into the trajectory and merged
into a bounded map cloud re-voxelized at ``map_leaf``. JAX's ``lax.scan``
is a host loop over frames. Each align goes through K4
(``registration/icp.icp_align``) and keeps the last pose when it has not
converged; the merge is the odometry's (``pipelines/odometry``), whose
pose copy to the device does not wait, so a frame's host syncs are its
ICP iterations'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.pointcloud import (PointCloud, pad_to,
                                               voxel_downsample)
from toyslam_tpu_torch.pipelines.odometry import _merge_into_map
from toyslam_tpu_torch.registration import icp


class IcpSlamConfig(NamedTuple):
    icp: icp.ICPConfig = icp.ICPConfig()
    map_capacity: int = 16384
    map_leaf: float = 0.2  # bounded-map refilter


class IcpSlamOutput(NamedTuple):
    poses: torch.Tensor  # [S, 4, 4] (host)
    errors: torch.Tensor  # [S] final ICP mean matched distance (host)
    map_xyzi: torch.Tensor  # [M, 4]
    map_mask: torch.Tensor  # [M]
    # ICP iterations a frame (0 for frame 0), each one host sync.
    iterations: torch.Tensor  # [S] int32


def icp_slam(scans_xyzi, scans_mask,
             config: IcpSlamConfig = IcpSlamConfig()) -> IcpSlamOutput:
    """Incremental ICP mapping over a scan stack ``[S, N, 4]`` / ``[S, N]``;
    frame 0 seeds the map at the identity."""
    dtype = scans_xyzi.dtype
    pose = torch.eye(4, dtype=dtype)
    map_cloud = pad_to(voxel_downsample(
        PointCloud(scans_xyzi[0], scans_mask[0]), config.map_leaf),
        config.map_capacity)
    poses, errors, iters = [pose], [torch.zeros((), dtype=dtype)], [0]
    for i in range(1, scans_xyzi.shape[0]):
        cur = PointCloud(scans_xyzi[i], scans_mask[i])
        res = icp.icp_align(cur, map_cloud, guess=pose, config=config.icp)
        if res.converged:
            pose = res.transform
        map_cloud = _merge_into_map(map_cloud, cur, pose, config)
        poses.append(pose)
        errors.append(res.error)
        iters.append(res.iterations)
    return IcpSlamOutput(torch.stack(poses), torch.stack(errors),
                         map_cloud.xyzi, map_cloud.mask,
                         torch.tensor(iters, dtype=torch.int32))
