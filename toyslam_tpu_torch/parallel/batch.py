"""Batch layer over independent lanes, point shards and processes (port
of ``toyslam_tpu/parallel/batch.py``).

JAX batches with ``vmap`` and shards with ``shard_map`` over a device
mesh. Here a batch is a lane axis written out: ``vmap_align`` builds B
maps at once and aligns B pairs in lockstep (``ndt.ndt_align_lanes``: one
K1 launch and one host sync a round for all running lanes), and
``_chunked_lanes`` runs a lane function over sequential chunks of lanes.
A mesh is a list of devices, the port's counterpart of a 1-D mesh:
``make_mesh`` lists the visible CUDA devices, or n CPU entries (JAX's
forced host device count), and a mesh may repeat a device (``[cuda:0] *
4`` on one card), whose shares then run one after another.
``sharded_odometry``, ``sharded_fusion`` and ``sharded_batch_fusion``
split the lanes over the mesh, each device running its lanes in chunks.
``sharded_align`` splits one align's source points over the mesh (the
map copied to each device) and adds the shards' derivative sums on the
host at every evaluation, in mesh order, in place of JAX's ``psum``.

Across processes: ``initialize_multihost`` joins a ``torch.distributed``
process group (JAX's ``jax.distributed.initialize``). Under a group of
more than one process, ``sharded_align`` all-reduces its host row of 28
sums and the point count once an evaluation over a Gloo group, the only
traffic between processes (each process passes its own points, and the
cloud is their concatenation in rank order); the lane functions take
each process's local lanes and return them without gathering, as JAX's
``make_array_from_process_local_data`` and its sharded outputs do.
"""

from __future__ import annotations

import datetime
from functools import reduce

import numpy as np
import torch

from toyslam_tpu_torch.core.pointcloud import PointCloud
from toyslam_tpu_torch.pipelines import batch_fusion as bf
from toyslam_tpu_torch.pipelines import fusion as fus
from toyslam_tpu_torch.pipelines import odometry as odo
from toyslam_tpu_torch.registration import ndt
from toyslam_tpu_torch.utils.profiling import span


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
    """The devices lanes and points are split over: the visible CUDA
    devices (the first ``n_devices``), or ``n_devices`` CPU entries (one
    by default) for ``device="cpu"``."""
    if device == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
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


def sharded_batch_fusion(mesh, imu_acc, imu_gyro, imu_dt, imu_valid, meas_t,
                         meas_p, meas_p_valid, config=None,
                         chunk: int | None = None) -> bf.BatchFusionOutput:
    """B independent streaming-smoother logs (one UWB/GPS + IMU log a
    vehicle), all inputs with a leading B, split over the mesh as
    ``sharded_odometry``: each device runs its lanes in sequential chunks
    of ``chunk`` (default ``fusion.FLEET_CHUNK``) lanes in lockstep
    (``batch_fusion.batch_fusion_lanes``). Returns a BatchFusionOutput
    with a leading B, its window too."""
    cfg = config or bf.BatchFusionConfig()
    lanes = _chunked_lanes(
        lambda *a: bf.batch_fusion_lanes(*a, config=cfg),
        chunk or fus.FLEET_CHUNK)
    return _sharded(mesh, lanes, imu_acc, imu_gyro, imu_dt, imu_valid,
                    meas_t, meas_p, meas_p_valid)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout: float | None = None):
    """Join a run of several processes: ``torch.distributed.
    init_process_group`` over ``tcp://<coordinator_address>`` (host:port of
    rank 0) with the world size and this process's rank, Gloo unless
    ``backend`` names another; without an address, torch's ``env://``
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). ``timeout`` (seconds)
    bounds the rendezvous and every collective: a peer that fails or hangs
    makes them raise. A second call is a no-op."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend or "gloo",
        init_method=("env://" if coordinator_address is None
                     else f"tcp://{coordinator_address}"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


_GLOO = {}


def _process_group():
    """The Gloo group ``sharded_align`` reduces over, or None in one
    process: the default group when it is Gloo's, else a Gloo group over
    the same ranks (NCCL neither reduces host tensors nor takes two ranks
    on one card), made once, by every rank together."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if "group" not in _GLOO:
        _GLOO["group"] = dist.new_group(backend="gloo")
    return _GLOO["group"]


class _ShardedEvaluator:
    """One align's device side over point shards, with the lane evaluator's
    protocol at one lane: each shard an ``ndt._LaneEvaluator`` of one lane
    on its device, against the map's copy there (one a device). The
    parameters go up once a device. An evaluation launches every shard's
    K1, or K3 against its frozen neighbourhood (gathered by its own K2),
    before it copies each shard's row of 28 sums to the host (one copy a
    shard, each counted in ``host_syncs``; the first also carries the
    shard's point count); the rows are added in mesh order and, under a
    process group, all-reduced once."""

    def __init__(self, mesh, ndt_map, source: PointCloud, config, group):
        n = len(mesh)
        N = source.mask.shape[0]
        if N % n:
            raise ValueError(f"source capacity {N} does not split into "
                             f"{n} equal shards")
        per = N // n
        d1, d2, _ = ndt.gauss_coefficients(config.resolution,
                                           config.outlier_ratio)
        maps = {}
        self.shards = []
        for i, dev in enumerate(mesh):
            dev = torch.device(dev)
            if dev not in maps:
                maps[dev] = ndt.NDTMap(*(x.to(dev)[None] for x in ndt_map))
            cut = slice(i * per, (i + 1) * per)
            self.shards.append(ndt._LaneEvaluator(
                maps[dev], source.xyzi[None, cut, :3].to(dev),
                source.mask[None, cut].to(dev), config.resolution,
                ndt._OFFSETS[config.search_method], d1, d2))
        self.dtype = source.xyzi.dtype
        self.group = group
        self.n_src = None
        self.host_syncs = 0

    def params(self, poses):
        """The [1, 83] parameters at the host pose, on each shard's device
        (one upload a device)."""
        up = {}
        for ev in self.shards:
            if ev.dev not in up:
                up[ev.dev] = ev.params(poses)
        return [up[ev.dev] for ev in self.shards]

    def gather(self, lanes, poses):
        for ev, params in zip(self.shards, self.params(poses)):
            ev.gather(lanes, poses, params)

    def derivs(self, requests):
        """Host (score, grad, hess) of the one request ``(0, pose,
        frozen)``, summed over the shards (and the processes)."""
        ((lane, pose, frozen),) = requests
        sums = [ev.sums(params, [lane], frozen).reshape(-1)
                for ev, params in zip(self.shards, self.params([pose]))]
        if self.n_src is None:
            sums = [torch.cat([s, ev.mask.sum(dtype=s.dtype)[None]])
                    for s, ev in zip(sums, self.shards)]
        rows = [s.cpu().numpy() for s in sums]
        self.host_syncs += len(rows)
        total = reduce(np.add, rows)
        if self.group is not None:
            import torch.distributed as dist

            t = torch.from_numpy(np.array(total))
            dist.all_reduce(t, group=self.group)
            total = t.numpy()
        if self.n_src is None:
            total, self.n_src = total[:-1], np.maximum(total[-1:], 1)
        return {lane: ndt._unpack(total)}


def sharded_align(mesh, ndt_map: ndt.NDTMap, source: PointCloud,
                  guess=None, config: ndt.NDTConfig = ndt.NDTConfig()
                  ) -> ndt.NDTResult:
    """Point-sharded NDT align: ``source``'s capacity split into
    ``len(mesh)`` equal contiguous shards (anything else raises), one a
    mesh entry, the map copied to each device; every evaluation runs each
    shard's kernels and adds their sums (``_ShardedEvaluator``), and the
    Newton / More-Thuente loop is ``ndt_align``'s (``ndt._align_lanes`` at
    one lane). Under a process group ``source`` is this process's points
    and the sums are all-reduced across processes; every process returns
    the same result. The result's ``host_syncs`` counts the shards'
    copies."""
    ev = _ShardedEvaluator(mesh, ndt_map, source, config, _process_group())
    with span("ndt.align"):
        return ndt._lane0(ndt._align_lanes(ev, [guess], config))
