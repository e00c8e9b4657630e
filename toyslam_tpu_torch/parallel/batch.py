"""Batch layer over independent lanes on the card (port of
``toyslam_tpu/parallel/batch.py``, one device).

JAX batches with ``vmap`` and shards with ``shard_map`` over a device
mesh. Here a batch is a lane axis written out: ``vmap_align`` builds B
maps at once and aligns B pairs in lockstep (``ndt.ndt_align_lanes``: one
K1 launch and one host sync a round for all running lanes), and
``_chunked_lanes`` runs a lane function over sequential chunks of lanes.
``make_mesh`` lists the visible CUDA devices, the port's counterpart of a
1-D mesh, and ``sharded_odometry`` / ``sharded_fusion`` split the lanes
over them, each device running its lanes in chunks; with one card that is
the chunked fleet. ``sharded_align``, ``initialize_multihost`` (across
cards) and ``sharded_batch_fusion`` (it needs the smoother) are not ported
yet.
"""

from __future__ import annotations

import torch

from toyslam_tpu_torch.core.pointcloud import PointCloud
from toyslam_tpu_torch.pipelines import fusion as fus
from toyslam_tpu_torch.pipelines import odometry as odo
from toyslam_tpu_torch.registration import ndt


def vmap_align(targets_xyzi, targets_mask, sources_xyzi, sources_mask,
               config: ndt.NDTConfig = ndt.NDTConfig()) -> ndt.NDTResult:
    """Align B independent pairs from the identity: targets and sources
    ``[B, N, 4]`` + ``[B, N]``. Returns an NDTResult with a leading B."""
    m = ndt.build_ndt_map_lanes(PointCloud(targets_xyzi, targets_mask),
                                config)
    return ndt.ndt_align_lanes(m, PointCloud(sources_xyzi, sources_mask),
                               None, config)


def make_mesh(n_devices: int | None = None, device: str = "cuda"
              ) -> list[torch.device]:
    """The devices lanes are split over: the visible CUDA devices (the
    first ``n_devices``), or ``[cpu]`` for ``device="cpu"``."""
    if device == "cpu":
        devs = [torch.device("cpu")]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices asked, {len(devs)} seen")
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError("no CUDA device for the mesh")
    return devs


def _chunked_lanes(lanes_fn, chunk: int):
    """A lane function (inputs and outputs with a leading lane axis) run
    over sequential chunks: floor(B / chunk) chunks of ``chunk`` lanes and
    one narrower remainder, never a wider lockstep group. Lanes never
    interact, so each lane's result does not depend on the chunk."""

    def run(*args):
        B = args[0].shape[0]
        return fus.cat_lanes([lanes_fn(*(a[i:i + chunk] for a in args))
                              for i in range(0, B, chunk)])

    return run


def _sharded(mesh, lanes_fn, *args):
    """The lanes split evenly over the mesh's devices in order, each
    device's share on it; the outputs joined on the first device."""
    B = args[0].shape[0]
    if B % len(mesh):
        raise ValueError(f"{B} lanes do not split over {len(mesh)} devices")
    per = B // len(mesh)
    return fus.cat_lanes([
        lanes_fn(*(a[i * per:(i + 1) * per].to(dev) for a in args))
        for i, dev in enumerate(mesh)])


def sharded_odometry(mesh, scans_xyzi, scans_mask,
                     config: odo.OdometryConfig = odo.OdometryConfig(),
                     chunk: int | None = None) -> odo.OdometryOutput:
    """B independent odometry sequences (``[B, S, N, 4]`` / ``[B, S, N]``)
    split over the mesh, each device running its lanes in sequential
    chunks of ``chunk`` (default ``fusion.FLEET_CHUNK``)."""
    lanes = _chunked_lanes(
        lambda x, m: odo.ndt_odometry_lanes(x, m, config),
        chunk or fus.FLEET_CHUNK)
    return _sharded(mesh, lanes, scans_xyzi, scans_mask)


def sharded_fusion(mesh, scans_xyzi, scans_mask, imu_acc, imu_gyro, imu_dt,
                   config: fus.FusionConfig | None = None,
                   chunk: int | None = None) -> fus.FusionOutput:
    """The fused NDT + ESKF pipeline over B independent sequences, all
    inputs with a leading B, split over the mesh as ``sharded_odometry``
    (BASELINE config 5: 64-way batched odometry + ESKF fusion)."""
    cfg = config or fus.FusionConfig()
    lanes = _chunked_lanes(
        lambda *a: fus.ndt_eskf_fusion_lanes(*a, config=cfg),
        chunk or fus.FLEET_CHUNK)
    return _sharded(mesh, lanes, scans_xyzi, scans_mask, imu_acc, imu_gyro,
                    imu_dt)
