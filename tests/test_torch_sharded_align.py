"""The port's point-sharded align (``parallel/batch.sharded_align``) and
its process group (``initialize_multihost``) against the JAX package, on
the CPU.

- ``sharded_align`` over ``make_mesh(8, "cpu")`` on
  ``tests/test_fusion.py``'s inputs (a 3000-point ground and wall at 4096
  capacity, shifted 0.3 m, resolution 2 m), in exact and frozen mode:
  equal iterations and evaluations, and the transform within 1e-5 (the
  JAX test's own bound for the shard sums' rounding) of JAX's
  ``sharded_align`` on its 8-device mesh (observed 7.5e-7 in both modes)
  and of the port's unsharded ``ndt_align`` (observed 1.8e-7);
  the shards' host copies are 8 an evaluation; on one mesh entry it is
  ``ndt_align`` bit for bit; a capacity that does not split raises.
- Two processes (this file as ``__main__``) joined by
  ``initialize_multihost`` over Gloo on localhost, each with a timeout:
  a second call is a no-op, an all-reduce sums, the align split between
  them (each its half of the points on a one-entry mesh) equals the
  one-process ``sharded_align`` over two entries bit for bit (two ranks
  add their rows in either order to the same sum), and
  ``sharded_odometry`` on each process's own lanes returns them, finite.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

TRANSFORM_TOL = 1e-5
WORKER_TIMEOUT_S = 120


def _pair(rng):
    """``tests/test_fusion.py::test_point_sharded_align_matches_single_
    device``'s clouds: [3000, 4] f32 points and the shifted source."""
    base = np.concatenate([
        rng.uniform(-20, 20, (1500, 2)),
        0.05 * rng.normal(size=(1500, 1)),
        np.zeros((1500, 1)),
    ], axis=1).astype(np.float32)
    wall = base.copy()
    wall[:, 2] = wall[:, 0] * 0.2 + 3.0
    pts = np.concatenate([base, wall])
    return pts, pts + np.array([0.3, -0.2, 0.05, 0.0], np.float32)


def _config(ndt, frozen):
    return ndt.NDTConfig(resolution=2.0, map_capacity=2048,
                         grid_capacity=1 << 14, frozen_linesearch=frozen)


def _port_inputs(frozen):
    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.registration import ndt

    tgt, src = _pair(np.random.default_rng(42))
    cfg = _config(ndt, frozen)
    m = ndt.build_ndt_map(pointcloud.from_numpy(tgt, 4096, device="cpu"),
                          cfg)
    return m, pointcloud.from_numpy(src, 4096, device="cpu"), cfg


@pytest.fixture(scope="module")
def jax_results():
    import jax

    from toyslam_tpu.core.pointcloud import from_numpy
    from toyslam_tpu.parallel import batch as jbatch
    from toyslam_tpu.registration import ndt as jndt

    tgt, src = _pair(np.random.default_rng(42))
    mesh = jbatch.make_mesh(8)
    assert len(mesh.devices.ravel()) == 8

    def both(target, source):
        out = []
        for frozen in (False, True):
            cfg = _config(jndt, frozen)
            m = jndt.build_ndt_map(target, cfg)
            out.append(jbatch.sharded_align(mesh, m, source, config=cfg))
        return out

    res = jax.jit(both)(from_numpy(tgt, 4096), from_numpy(src, 4096))
    return {frozen: r for frozen, r in zip((False, True), res)}


@pytest.mark.parametrize("frozen", [False, True], ids=["exact", "frozen"])
def test_sharded_align_matches_jax_and_unsharded(jax_results, frozen):
    from toyslam_tpu_torch.parallel import batch
    from toyslam_tpu_torch.registration import ndt

    m, source, cfg = _port_inputs(frozen)
    out = batch.sharded_align(batch.make_mesh(8, "cpu"), m, source,
                              config=cfg)
    ref = ndt.ndt_align(m, source, None, cfg)
    want = jax_results[frozen]
    assert out.converged and ref.converged
    assert out.iterations == ref.iterations == int(want.iterations)
    assert out.evaluations == ref.evaluations == int(want.evaluations)
    assert out.host_syncs == 8 * out.evaluations
    np.testing.assert_allclose(out.transform.numpy(),
                               np.asarray(want.transform), rtol=0,
                               atol=TRANSFORM_TOL)
    np.testing.assert_allclose(out.transform.numpy(), ref.transform.numpy(),
                               rtol=0, atol=TRANSFORM_TOL)


@pytest.mark.parametrize("frozen", [False, True], ids=["exact", "frozen"])
def test_sharded_align_on_one_entry_is_ndt_align(frozen):
    """One mesh entry: the one NDT evaluator at one lane under the one
    align loop, so ``ndt_align`` bit for bit, counters included (one
    shard, one copy an evaluation)."""
    from toyslam_tpu_torch.parallel import batch
    from toyslam_tpu_torch.registration import ndt

    m, source, cfg = _port_inputs(frozen)
    out = batch.sharded_align(batch.make_mesh(1, "cpu"), m, source,
                              config=cfg)
    ref = ndt.ndt_align(m, source, None, cfg)
    for name in ("transform", "pose6", "trans_probability"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert out[1:3] + out[5:] == ref[1:3] + ref[5:]
    assert out.host_syncs == out.evaluations


def test_sharded_align_rejects_uneven_shards():
    from toyslam_tpu_torch.parallel import batch

    m, source, cfg = _port_inputs(False)
    with pytest.raises(ValueError, match="equal shards"):
        batch.sharded_align(batch.make_mesh(3, "cpu"), m, source,
                            config=cfg)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_align_and_lanes():
    addr = f"localhost:{_free_port()}"
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, __file__, addr, str(rank)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: align and lanes OK" in out, out


def _worker(addr, rank):
    """One process of the two-process test: Gloo over ``addr``."""
    import torch.distributed as dist

    from toyslam_tpu_torch.parallel import batch
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import ndt

    torch.set_num_threads(1)
    m, source, cfg = _port_inputs(False)
    # The one-process reference, before the group exists.
    ref = batch.sharded_align(batch.make_mesh(2, "cpu"), m, source,
                              config=cfg)
    batch.initialize_multihost(addr, 2, rank, timeout=60)
    batch.initialize_multihost(addr, 2, rank, timeout=60)  # a no-op
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    t = torch.full((2,), float(rank + 1))
    dist.all_reduce(t)
    assert t.tolist() == [3.0, 3.0], t

    half = source.mask.shape[0] // 2
    mine = type(source)(source.xyzi[rank * half:(rank + 1) * half],
                        source.mask[rank * half:(rank + 1) * half])
    out = batch.sharded_align(batch.make_mesh(1, "cpu"), m, mine,
                              config=cfg)
    assert out.iterations == ref.iterations, (out.iterations,
                                              ref.iterations)
    assert out.evaluations == ref.evaluations
    assert torch.equal(out.transform, ref.transform), (out.transform,
                                                        ref.transform)
    assert float(out.trans_probability) == float(ref.trans_probability)

    # Process-local lanes: two small sequences a process, returned as they
    # are, not gathered.
    gen = np.random.default_rng(rank)
    pts = np.concatenate([gen.uniform(-10, 10, (2, 3, 256, 2)),
                          0.05 * gen.normal(size=(2, 3, 256, 1)),
                          np.zeros((2, 3, 256, 1))], -1).astype(np.float32)
    ocfg = odometry.OdometryConfig(
        ndt=ndt.NDTConfig(resolution=1.0, max_iterations=5), scan_leaf=0.5,
        work_capacity=256)
    lanes = batch.sharded_odometry(
        batch.make_mesh(device="cpu"), torch.from_numpy(pts),
        torch.ones((2, 3, 256), dtype=torch.bool), ocfg)
    assert lanes.poses.shape[:2] == (2, 3), lanes.poses.shape
    assert bool(torch.isfinite(lanes.poses).all())
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: align and lanes OK")


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
