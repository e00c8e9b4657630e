"""The port's fleet (``pipelines/fusion.fleet_fusion``, ``parallel/batch``)
against the JAX package's, on the CPU, in f64.

- ``fleet_fusion`` at ``tests/test_fusion.py:10-42``'s scene and
  ``_small_cfg(R=10)``, B = 4, S = 2, N = 400: per-lane odometry poses
  equal to JAX's ``fleet_fusion``, iterations and evaluations equal to
  JAX's ``vmap(ndt_odometry)``, fused p, v and q within 2e-16 (observed
  5.3e-17); chunk 2 equal to chunk 4 bit for bit,
  and each lane's odometry equal to the single-lane ``ndt_odometry`` bit
  for bit;
- ``_chunked_lanes``: B = 3 at chunk 2 (a full chunk and a remainder of
  one) equals the wide run bit for bit;
- ``fleet_fusion`` rejects a width that the chunk does not divide;
- ``vmap_align`` against JAX's ``batch.vmap_align`` on three pairs:
  iterations and evaluations equal, poses within 6e-15 (observed 2.7e-15);
- ``sharded_odometry`` / ``sharded_fusion`` over ``make_mesh(device=
  "cpu")`` equal the chunked fleet bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.parallel import batch as jbatch  # noqa: E402
from toyslam_tpu.pipelines import fusion as jfusion  # noqa: E402
from toyslam_tpu.pipelines import odometry as jodo  # noqa: E402
from toyslam_tpu.registration import ndt as jndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.parallel import batch as tbatch  # noqa: E402
from toyslam_tpu_torch.pipelines import fusion as tfusion  # noqa: E402
from toyslam_tpu_torch.pipelines import odometry as todo  # noqa: E402

FUSED_TOL = 2e-16
VMAP_ALIGN_TOL = 6e-15
B, S, N, R = 4, 2, 400, 10


def _fusion_inputs(rng):
    """``tests/test_fusion.py``'s static scene and stationary IMU, f64."""
    base = np.concatenate([
        np.stack([rng.uniform(-8, 8, N // 2), rng.uniform(-8, 8, N // 2),
                  0.05 * rng.normal(size=N // 2)], 1),
        np.stack([rng.uniform(-8, 8, N - N // 2),
                  np.full(N - N // 2, 4.0)
                  + 0.05 * rng.normal(size=N - N // 2),
                  rng.uniform(0, 3, N - N // 2)], 1)], 0)
    xyzi = np.full((S, N, 4), 1e9)
    for i in range(S):
        xyzi[i, :, :3] = base + 0.01 * rng.normal(size=base.shape)
        xyzi[i, :, 3] = 0
    T = S * R
    acc = np.tile([0, 0, 9.81], (T, 1)) + 0.01 * rng.normal(size=(T, 3))
    gyro = 0.001 * rng.normal(size=(T, 3))
    return xyzi, np.ones((S, N), bool), acc, gyro, np.full((T,), 0.01)


JCFG = jfusion.FusionConfig(
    odometry=jodo.OdometryConfig(
        ndt=jndt.NDTConfig(resolution=1.0, max_iterations=10,
                           map_capacity=2048, grid_capacity=1 << 14),
        scan_leaf=0.5, work_capacity=1024),
    imu_per_scan=R)
CFG = convert.fusion_config(JCFG._asdict())


@pytest.fixture(scope="module")
def fleet_inputs():
    rng = np.random.default_rng(42)
    parts = [_fusion_inputs(rng) for _ in range(B)]
    return [np.stack([p[i] for p in parts]) for i in range(5)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_equal(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def port_fleet(fleet_inputs):
    return tfusion.fleet_fusion(*_torch(fleet_inputs), CFG, chunk=2)


def test_fleet_fusion_matches_jax_f64(fleet_inputs, port_fleet):
    got = port_fleet
    args = [jnp.asarray(a) for a in fleet_inputs]
    want = jax.jit(lambda *a: jfusion.fleet_fusion(*a, config=JCFG,
                                                   chunk=2))(*args)
    odo_j = jax.jit(jax.vmap(lambda x, m: jodo.ndt_odometry(
        x, m, JCFG.odometry)))(args[0], args[1])
    assert got.poses.shape == (B, S, 4, 4)
    assert got.fused_p.shape == (B, S * R, 3)
    assert got.converged.all() and np.asarray(want.converged).all()
    np.testing.assert_array_equal(got.poses.numpy(), np.asarray(want.poses))
    for name in ("iterations", "evaluations", "gathers"):
        assert getattr(got.odometry, name).tolist() == np.asarray(
            getattr(odo_j, name)).tolist(), name
    for g, w in ((got.fused_p, want.fused_p), (got.fused_v, want.fused_v),
                 (got.fused_q, want.fused_q)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FUSED_TOL)


def test_fleet_fusion_chunks_and_single_lanes_agree(fleet_inputs,
                                                    port_fleet):
    """Chunk 2 equals chunk 4 (one lockstep group) bit for bit, and each
    lane's odometry equals ``ndt_odometry`` alone (the host syncs aside:
    a lane in lockstep counts the rounds)."""
    wide = tfusion.fleet_fusion(*_torch(fleet_inputs), CFG, chunk=B)
    _assert_equal(wide, port_fleet)
    scans, masks = _torch(fleet_inputs[:2])
    for b in range(B):
        one = todo.ndt_odometry(scans[b], masks[b], CFG.odometry)
        for name, g, w in zip(one._fields, port_fleet.odometry, one):
            if name != "host_syncs":
                assert torch.equal(g[b], w), (b, name)
        assert (port_fleet.odometry.host_syncs[b] >= one.host_syncs).all()


def test_chunked_lanes_remainder_equals_wide(fleet_inputs):
    scans, masks = (t[:3] for t in _torch(fleet_inputs[:2]))

    def lanes(x, m):
        return todo.ndt_odometry_lanes(x, m, CFG.odometry)

    wide = lanes(scans, masks)
    mixed = tbatch._chunked_lanes(lanes, 2)(scans, masks)
    for name, w, c in zip(wide._fields, wide, mixed):
        if name != "host_syncs":  # the rounds of each lockstep group
            assert torch.equal(w, c), name


def test_fleet_fusion_rejects_indivisible_chunk(fleet_inputs):
    args = [t[:3] for t in _torch(fleet_inputs)]
    with pytest.raises(ValueError, match="divisible"):
        tfusion.fleet_fusion(*args, CFG, chunk=2)


def test_sharded_wrappers_equal_chunked_fleet(fleet_inputs, port_fleet):
    mesh = tbatch.make_mesh(device="cpu")
    assert mesh == [torch.device("cpu")]
    fused = tbatch.sharded_fusion(mesh, *_torch(fleet_inputs), CFG, chunk=2)
    _assert_equal(fused, port_fleet)
    odo = tbatch.sharded_odometry(mesh, *_torch(fleet_inputs[:2]),
                                  CFG.odometry, chunk=2)
    _assert_equal(odo, port_fleet.odometry)


def test_vmap_align_matches_jax(fleet_inputs):
    """Three pairs: scan 0 as the target, scan 1 moved by a different
    offset a lane as the source."""
    xyzi, mask = fleet_inputs[0][:3], fleet_inputs[1][:3]
    shift = np.array([[0.05, 0.0, 0.0], [0.2, -0.1, 0.0], [-0.3, 0.15, 0.05]])
    src = xyzi[:, 1].copy()
    src[..., :3] += shift[:, None, :]
    cfg = jndt.NDTConfig(resolution=1.0, map_capacity=2048,
                         grid_capacity=1 << 14, transformation_epsilon=1e-3)
    want = jax.jit(lambda *a: jbatch.vmap_align(*a, config=cfg))(
        jnp.asarray(xyzi[:, 0]), jnp.asarray(mask[:, 0]), jnp.asarray(src),
        jnp.asarray(mask[:, 1]))
    got = tbatch.vmap_align(
        torch.from_numpy(xyzi[:, 0]), torch.from_numpy(mask[:, 0]),
        torch.from_numpy(src), torch.from_numpy(mask[:, 1]),
        convert.ndt_config(cfg._asdict()))
    assert got.converged.all() and np.asarray(want.converged).all()
    for name in ("iterations", "evaluations", "gathers"):
        assert getattr(got, name).tolist() == np.asarray(
            getattr(want, name)).tolist(), name
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(want.pose6),
                               rtol=0, atol=VMAP_ALIGN_TOL)
    assert len(set(got.iterations.tolist())) >= 2
