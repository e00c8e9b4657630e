"""Scan-to-scan NDT odometry and bounded global-map mapping (port of
``toyslam_tpu/pipelines/odometry.py``).

- ``ndt_odometry``: the loop of the reference's
  ``ndt_rosbag_mapping_node.cpp:27-144``: per scan, a 0.3 m voxel
  downsample, an NDT map of the previous downsampled scan, an align
  warm-started from the previous relative transform (optionally a coarse
  align first), and the pose chain ``pose = pose @ T`` with an identity
  fallback when an align does not converge.
- ``ndt_mapping``: odometry plus a fixed-capacity global map that each
  scan is merged into and re-voxelized at ``map_leaf``
  (``ndt_rosbag_mapping_node.cpp:146-161`` made memory-static).

JAX's ``lax.scan`` is a Python loop over ``odometry_step`` /
``mapping_step``; scans, clouds and maps stay on the scans' device, poses
on the host. Both steps return JAX's tuple ``(pose, T, converged,
iterations, trans_probability, evaluations, gathers)`` with the port's
host-sync count as an eighth element.

The steps are written over lanes: ``ndt_odometry_lanes`` runs B
independent sequences at once (JAX's ``vmap`` of ``odometry_step``), per
scan one lane-batched downsample, one lane-batched map build and one
lockstep align (``ndt.ndt_align_lanes``), coarse-to-fine a second one.
``ndt_odometry`` and ``odometry_step`` are its one-lane case; a lane's
outputs do not depend on the other lanes, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.pointcloud import (PointCloud, pad_to,
                                               voxel_downsample,
                                               voxel_downsample_lanes)
from toyslam_tpu_torch.registration import ndt
from toyslam_tpu_torch.utils.profiling import span, spanned


class OdometryConfig(NamedTuple):
    """The JAX package's shipped default (eps 1e-3, frozen line search with
    4 regathers, 0.3 m scan leaf, warm start, no coarse stage) with one
    departure: ``grid_capacity`` is ``NDTConfig``'s own 1 << 16, not the
    JAX package's 1 << 15, which it halved for the TPU's scatter cost.
    At 1 << 15 two map voxels that share a hash slot both drop out of the
    map; on the drifting 64-scan golden sequence of ``chip_smoke.py`` that
    moves aligns 1e-4 to 6e-4 m from the f64 golden NDT (pclomp, which
    has no such table) and the trajectory past BASELINE's 1e-3 m ATE,
    while at 1 << 16 an exact f64 align equals the golden one to 1e-14.
    ``convert.odometry_config`` of a JAX config keeps its value."""

    ndt: ndt.NDTConfig = ndt.NDTConfig(
        resolution=1.0,
        step_size=0.1,
        transformation_epsilon=0.001,
        max_iterations=64,
        map_capacity=8192,
        grid_capacity=1 << 16,
        frozen_linesearch=True,
        regather_iterations=4,
    )
    scan_leaf: float = 0.3
    map_leaf: float = 0.5
    warm_start: bool = True
    work_capacity: int = 16384
    # Coarse-to-fine: a first align of the working cloud downsampled at
    # ``coarse_leaf`` (> 0 turns it on) against the same map; the fine
    # align starts from its pose when it converged and regathers at most
    # ``fine_regather`` times.
    coarse_leaf: float = 0.0
    coarse_capacity: int = 6144
    fine_regather: int = 0
    # NDT never reads intensity; the mapping pipelines force it on, as the
    # global map averages it.
    keep_intensity: bool = False


class OdometryOutput(NamedTuple):
    poses: torch.Tensor  # [S, 4, 4] world-from-scan (host)
    pairwise: torch.Tensor  # [S, 4, 4] T(scan_{i-1} <- scan_i)
    converged: torch.Tensor  # [S] bool
    iterations: torch.Tensor  # [S] int32
    trans_probability: torch.Tensor  # [S]
    evaluations: torch.Tensor  # [S] int32, coarse + fine
    gathers: torch.Tensor  # [S] int32, coarse + fine
    host_syncs: torch.Tensor  # [S] int32


class OdometryState(NamedTuple):
    """Carry for online (scan-at-a-time) odometry."""

    prev_ds: PointCloud
    pose: torch.Tensor  # [4, 4] host
    prev_T: torch.Tensor  # [4, 4] host


class MappingOutput(NamedTuple):
    odometry: OdometryOutput
    map_xyzi: torch.Tensor  # [M, 4] accumulated global map (voxel filtered)
    map_mask: torch.Tensor  # [M]


class MappingState(NamedTuple):
    """Carry for online mapping: odometry plus the bounded global map. Its
    fields and their names are JAX's, so that a checkpoint of either
    package loads in the other (``utils/checkpoint``)."""

    odometry: OdometryState
    map_cloud: PointCloud


def _for_mapping(config: OdometryConfig) -> OdometryConfig:
    """The global map averages intensity like the reference's VoxelGrid,
    whatever the odometry default."""
    return config._replace(keep_intensity=True)


def _downsample(xyzi, mask, cfg: OdometryConfig) -> PointCloud:
    return voxel_downsample(PointCloud(xyzi, mask), cfg.scan_leaf,
                            cfg.work_capacity,
                            with_intensity=cfg.keep_intensity)


@spanned("odometry.downsample")
def _downsample_lanes(xyzi, mask, cfg: OdometryConfig) -> PointCloud:
    return voxel_downsample_lanes(xyzi, mask, cfg.scan_leaf,
                                  cfg.work_capacity,
                                  with_intensity=cfg.keep_intensity)


def odometry_init_lanes(first_xyzi, first_mask,
                        config: OdometryConfig = OdometryConfig()
                        ) -> OdometryState:
    """``odometry_init`` of B lanes, ``[B, N, 4]`` / ``[B, N]``: a state
    whose fields have a leading B."""
    eye = torch.eye(4, dtype=first_xyzi.dtype).expand(
        first_xyzi.shape[0], 4, 4)
    return OdometryState(_downsample_lanes(first_xyzi, first_mask, config),
                         eye.clone(), eye.clone())


def odometry_step_lanes(state: OdometryState, xyzi, mask,
                        config: OdometryConfig = OdometryConfig()):
    """``odometry_step`` of B lanes (``[B, N, 4]`` / ``[B, N]``, a state
    from ``odometry_init_lanes``): the tuple's entries gain a leading B.
    The lanes never interact: each equals the same call on it alone, bit
    for bit."""
    B = mask.shape[0]
    cur_ds = _downsample_lanes(xyzi, mask, config)
    m = ndt.build_ndt_map_lanes(state.prev_ds, config.ndt)
    eye = torch.eye(4, dtype=xyzi.dtype)
    guess = state.prev_T if config.warm_start else eye.expand(B, 4, 4)
    n_ev = n_ga = syncs = 0
    fine_cfg = config.ndt
    if config.coarse_leaf > 0:
        # Same map, fewer source points: a downsample of the working cloud.
        with span("odometry.downsample"):
            coarse = voxel_downsample_lanes(
                cur_ds.xyzi, cur_ds.mask, config.coarse_leaf,
                config.coarse_capacity, with_intensity=config.keep_intensity)
        res_c = ndt.ndt_align_lanes(m, coarse, guess, config.ndt)
        guess = torch.where(res_c.converged[:, None, None], res_c.transform,
                            guess)
        n_ev, n_ga, syncs = res_c.evaluations, res_c.gathers, res_c.host_syncs
        fine_cfg = fine_cfg._replace(regather_iterations=min(
            config.fine_regather, config.ndt.regather_iterations))
    res = ndt.ndt_align_lanes(m, cur_ds, guess, fine_cfg)
    T = torch.where(res.converged[:, None, None], res.transform, eye)
    pose = torch.stack([state.pose[b] @ T[b] for b in range(B)])
    out = (pose, T, res.converged, res.iterations, res.trans_probability,
           n_ev + res.evaluations, n_ga + res.gathers,
           syncs + res.host_syncs)
    return OdometryState(cur_ds, pose, T), out


def ndt_odometry_lanes(scans_xyzi, scans_mask,
                       config: OdometryConfig = OdometryConfig(),
                       initial_poses=None) -> OdometryOutput:
    """``ndt_odometry`` of B independent sequences ``[B, S, N, 4]`` / ``[B,
    S, N]`` in lockstep: an OdometryOutput whose fields have a leading B;
    ``poses[:, 0] = initial_poses`` ``[B, 4, 4]`` (identity)."""
    dtype = scans_xyzi.dtype
    B, S = scans_mask.shape[:2]
    eye = torch.eye(4, dtype=dtype).expand(B, 1, 4, 4)
    state = odometry_init_lanes(scans_xyzi[:, 0], scans_mask[:, 0], config)
    if initial_poses is not None:
        state = state._replace(pose=torch.as_tensor(initial_poses).to(
            "cpu", dtype).reshape(B, 4, 4))
    pose0 = state.pose[:, None]
    outs = []
    for i in range(1, S):
        state, out = odometry_step_lanes(state, scans_xyzi[:, i],
                                         scans_mask[:, i], config)
        outs.append(out)
    if not outs:
        zi = torch.zeros((B, 1), dtype=torch.int32)
        return OdometryOutput(pose0.clone(), eye.clone(),
                              torch.ones((B, 1), dtype=torch.bool), zi,
                              torch.zeros((B, 1), dtype=dtype), zi, zi, zi)
    poses, pairwise, conv, iters, probs, evals, gathers, syncs = (
        torch.stack(c, 1) for c in zip(*outs))

    def first(col, value):
        return torch.cat([torch.full((B, 1), value, dtype=col.dtype), col], 1)

    return OdometryOutput(
        torch.cat([pose0, poses], 1), torch.cat([eye, pairwise], 1),
        first(conv, True), first(iters, 0), first(probs, 0), first(evals, 0),
        first(gathers, 0), first(syncs, 0))


def odometry_init(first_xyzi, first_mask,
                  config: OdometryConfig = OdometryConfig()) -> OdometryState:
    state = odometry_init_lanes(first_xyzi[None], first_mask[None], config)
    return _lane(state, 0)


def _lane(state: OdometryState, b: int) -> OdometryState:
    ds = state.prev_ds
    return OdometryState(PointCloud(ds.xyzi[b], ds.mask[b]), state.pose[b],
                         state.prev_T[b])


def odometry_step(state: OdometryState, xyzi, mask,
                  config: OdometryConfig = OdometryConfig()):
    """Process one scan (``odometry_step_lanes`` of one lane); returns
    ``(new_state, (pose, pairwise_T, converged, iterations,
    trans_probability, evaluations, gathers, host_syncs))``, JAX's tuple
    plus the host syncs of the aligns."""
    ds = state.prev_ds
    lanes = OdometryState(PointCloud(ds.xyzi[None], ds.mask[None]),
                          state.pose[None], state.prev_T[None])
    new, out = odometry_step_lanes(lanes, xyzi[None], mask[None], config)
    pose, T, conv, iters, prob, evals, gathers, syncs = (o[0] for o in out)
    return _lane(new, 0), (pose, T, bool(conv), int(iters), prob,
                           int(evals), int(gathers), int(syncs))


def _stack(pose0, outs) -> OdometryOutput:
    """The per-scan step outputs as an OdometryOutput; scan 0 is the seed
    (its pose ``pose0``, identity pairwise, converged, zero counts)."""
    dtype = pose0.dtype
    cols = list(zip(*outs)) or [()] * 8
    poses, pairwise, conv, iters, probs, evals, gathers, syncs = cols

    def ints(v):
        return torch.tensor([0, *v], dtype=torch.int32)

    return OdometryOutput(
        torch.stack([pose0, *poses]),
        torch.stack([torch.eye(4, dtype=dtype), *pairwise]),
        torch.tensor([True, *conv]), ints(iters),
        torch.stack([torch.zeros((), dtype=dtype), *probs]),
        ints(evals), ints(gathers), ints(syncs))


def ndt_odometry(scans_xyzi, scans_mask,
                 config: OdometryConfig = OdometryConfig(),
                 initial_pose=None) -> OdometryOutput:
    """Run NDT odometry over a scan stack ``[S, N, 4]`` / ``[S, N]``
    (``ndt_odometry_lanes`` of one lane).

    Scan 0 seeds the target; ``poses[0] = initial_pose`` (identity).
    """
    out = ndt_odometry_lanes(
        scans_xyzi[None], scans_mask[None], config,
        None if initial_pose is None else torch.as_tensor(initial_pose)[None])
    return OdometryOutput(*(f[0] for f in out))


@spanned("mapping.merge")
def _merge_into_map(map_cloud: PointCloud, cur_ds: PointCloud, pose,
                    config: OdometryConfig) -> PointCloud:
    """Transform the downsampled scan into the world frame, merge it into
    the fixed-capacity map and re-apply the map voxel filter; the capacity
    is the map's own. Voxels beyond it drop in ascending voxel-id order.

    The host pose goes to the cloud's device in a non-blocking copy (no
    host sync). The rotation is applied as rounded elementwise products
    and sums (exact f32 whatever the TF32 setting), pad rows keep their
    sentinel."""
    xyz = cur_ds.xyzi[:, :3]
    P = pose.to(xyz.device, xyz.dtype, non_blocking=True)
    R, t = P[:3, :3], P[:3, 3]
    world = (xyz[:, 0:1] * R[:, 0] + xyz[:, 1:2] * R[:, 1]
             + xyz[:, 2:3] * R[:, 2] + t)
    world = torch.where(cur_ds.mask[:, None], world, xyz)
    merged = PointCloud(
        torch.cat([map_cloud.xyzi,
                   torch.cat([world, cur_ds.xyzi[:, 3:4]], 1)], 0),
        torch.cat([map_cloud.mask, cur_ds.mask], 0))
    return voxel_downsample(merged, config.map_leaf, map_cloud.capacity)


@spanned("mapping.init")
def mapping_init(first_xyzi, first_mask, map_capacity: int,
                 config: OdometryConfig = OdometryConfig()) -> MappingState:
    config = _for_mapping(config)
    odo = odometry_init(first_xyzi, first_mask, config)
    map0 = pad_to(voxel_downsample(odo.prev_ds, config.map_leaf),
                  map_capacity)
    return MappingState(odometry=odo, map_cloud=map0)


@spanned("mapping.step")
def mapping_step(state: MappingState, xyzi, mask,
                 config: OdometryConfig = OdometryConfig()):
    """One scan of online mapping; chained steps equal ``ndt_mapping`` bit
    for bit. Returns ``(new_state, out)`` with ``odometry_step``'s tuple."""
    config = _for_mapping(config)
    odo, out = odometry_step(state.odometry, xyzi, mask, config)
    new_map = _merge_into_map(state.map_cloud, odo.prev_ds, odo.pose, config)
    return MappingState(odometry=odo, map_cloud=new_map), out


def ndt_mapping(scans_xyzi, scans_mask, map_capacity: int,
                config: OdometryConfig = OdometryConfig()) -> MappingOutput:
    """Odometry plus bounded global-map accumulation over a scan stack
    ``[S, N, 4]`` / ``[S, N]``; the map holds ``map_capacity`` voxels of
    ``map_leaf`` and starts from scan 0 at the identity."""
    state = mapping_init(scans_xyzi[0], scans_mask[0], map_capacity, config)
    outs = []
    for i in range(1, scans_xyzi.shape[0]):
        state, out = mapping_step(state, scans_xyzi[i], scans_mask[i],
                                  config)
        outs.append(out)
    odo = _stack(torch.eye(4, dtype=scans_xyzi.dtype), outs)
    return MappingOutput(odo, state.map_cloud.xyzi, state.map_cloud.mask)
