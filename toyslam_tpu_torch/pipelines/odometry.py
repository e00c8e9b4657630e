"""Scan-to-scan NDT odometry (port of ``toyslam_tpu/pipelines/odometry.py``).

The loop of the reference's ``ndt_rosbag_mapping_node.cpp:27-144``: per
scan, a 0.3 m voxel downsample, an NDT map of the previous downsampled
scan, an align warm-started from the previous relative transform, and the
pose chain ``pose = pose @ T`` with an identity fallback when an align
does not converge. JAX's ``lax.scan`` is a Python loop; scans, clouds and
maps stay on the scans' device, poses on the host.

Not ported yet: coarse-to-fine (``coarse_leaf > 0`` raises) and the
mapping pipelines; their config fields stay.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.pointcloud import PointCloud, voxel_downsample
from toyslam_tpu_torch.registration import ndt


class OdometryConfig(NamedTuple):
    """The JAX package's shipped default: eps 1e-3, frozen line search with
    4 regathers, 0.3 m scan leaf, warm start."""

    ndt: ndt.NDTConfig = ndt.NDTConfig(
        resolution=1.0,
        step_size=0.1,
        transformation_epsilon=0.001,
        max_iterations=64,
        map_capacity=8192,
        grid_capacity=1 << 15,
        frozen_linesearch=True,
        regather_iterations=4,
    )
    scan_leaf: float = 0.3
    map_leaf: float = 0.5
    warm_start: bool = True
    work_capacity: int = 16384
    coarse_leaf: float = 0.0
    coarse_capacity: int = 6144
    fine_regather: int = 0
    keep_intensity: bool = False


class OdometryOutput(NamedTuple):
    poses: torch.Tensor  # [S, 4, 4] world-from-scan (host)
    pairwise: torch.Tensor  # [S, 4, 4] T(scan_{i-1} <- scan_i)
    converged: torch.Tensor  # [S] bool
    iterations: torch.Tensor  # [S] int32
    trans_probability: torch.Tensor  # [S]
    evaluations: torch.Tensor  # [S] int32
    gathers: torch.Tensor  # [S] int32
    host_syncs: torch.Tensor  # [S] int32


class OdometryState(NamedTuple):
    """Carry for online (scan-at-a-time) odometry."""

    prev_ds: PointCloud
    pose: torch.Tensor  # [4, 4] host
    prev_T: torch.Tensor  # [4, 4] host


def _downsample(xyzi, mask, cfg: OdometryConfig) -> PointCloud:
    return voxel_downsample(PointCloud(xyzi, mask), cfg.scan_leaf,
                            cfg.work_capacity,
                            with_intensity=cfg.keep_intensity)


def odometry_step(state: OdometryState, xyzi, mask,
                  config: OdometryConfig = OdometryConfig()):
    """Process one scan; returns (new_state, NDTResult of its align)."""
    if config.coarse_leaf > 0:
        raise NotImplementedError("coarse-to-fine odometry is not ported")
    cur_ds = _downsample(xyzi, mask, config)
    m = ndt.build_ndt_map(state.prev_ds, config.ndt)
    eye = torch.eye(4, dtype=xyzi.dtype)
    guess = state.prev_T if config.warm_start else eye
    res = ndt.ndt_align(m, cur_ds, guess, config.ndt)
    T = res.transform if res.converged else eye
    return OdometryState(cur_ds, state.pose @ T, T), res


def odometry_init(first_xyzi, first_mask,
                  config: OdometryConfig = OdometryConfig()) -> OdometryState:
    eye = torch.eye(4, dtype=first_xyzi.dtype)
    return OdometryState(_downsample(first_xyzi, first_mask, config), eye,
                         eye)


def ndt_odometry(scans_xyzi, scans_mask,
                 config: OdometryConfig = OdometryConfig(),
                 initial_pose=None) -> OdometryOutput:
    """Run NDT odometry over a scan stack ``[S, N, 4]`` / ``[S, N]``.

    Scan 0 seeds the target; ``poses[0] = initial_pose`` (identity).
    """
    dtype = scans_xyzi.dtype
    eye = torch.eye(4, dtype=dtype)
    pose0 = eye if initial_pose is None else torch.as_tensor(
        initial_pose).to("cpu", dtype)
    state = odometry_init(scans_xyzi[0], scans_mask[0], config)._replace(
        pose=pose0)
    poses, pairwise = [pose0], [eye]
    conv, iters, probs = [True], [0], [torch.zeros((), dtype=dtype)]
    evals, gathers, syncs = [0], [0], [0]
    for i in range(1, scans_xyzi.shape[0]):
        state, res = odometry_step(state, scans_xyzi[i], scans_mask[i],
                                   config)
        poses.append(state.pose)
        pairwise.append(state.prev_T)
        conv.append(res.converged)
        iters.append(res.iterations)
        probs.append(res.trans_probability)
        evals.append(res.evaluations)
        gathers.append(res.gathers)
        syncs.append(res.host_syncs)

    def ints(v):
        return torch.tensor(v, dtype=torch.int32)

    return OdometryOutput(torch.stack(poses), torch.stack(pairwise),
                          torch.tensor(conv), ints(iters), torch.stack(probs),
                          ints(evals), ints(gathers), ints(syncs))
