"""The slice end to end: NDT odometry of the PyTorch port against the JAX
package, and the port importing without JAX.

Four generated 16 x 512-ray scans go through both ``ndt_odometry``s under
the shipped ``OdometryConfig`` (frozen line search, 4 regathers, eps 1e-3)
with the working capacity cut to 4096 for the small scans. Bounds: f64
poses within 1e-8 m (observed ~1e-14) with equal per-scan iterations,
evaluations and gathers; f32 within 5e-4 m (observed ~2e-4: f32 map sums
and host Newton steps round differently from JAX's). The same f64 bounds
hold ``odometry_step``'s tuple against JAX's and the coarse-to-fine
odometry (a 0.9 m coarse align first, the fine one regathering 0 or 2
times).
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.pipelines import odometry as jodo  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.pipelines import odometry as todo  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402

CFG = jodo.OdometryConfig(work_capacity=4096)


def _port(scans, dtype):
    xyzi, mask = scans
    return torch.from_numpy(xyzi.astype(dtype)), torch.from_numpy(mask)


def _cfg(**kw):
    return convert.odometry_config(CFG._replace(**kw)._asdict())


def _assert_poses(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, :3, :], want[:, :3, :], atol=tol)


def _assert_counts(got, want):
    for f in ("iterations", "evaluations", "gathers"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.fixture(scope="module")
def scans():
    xyzi, mask, _ = spinning_lidar_scans(2, 4, 16, 512)
    return xyzi, mask


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-8),
                                       (np.float32, 5e-4)])
def test_ndt_odometry_matches_jax(scans, dtype, tol):
    xyzi, mask = scans
    want = jax.jit(lambda s, m: jodo.ndt_odometry(s, m, CFG))(
        jnp.asarray(xyzi, dtype), jnp.asarray(mask))
    got = todo.ndt_odometry(torch.from_numpy(xyzi.astype(dtype)),
                            torch.from_numpy(mask),
                            convert.odometry_config(CFG._asdict()))
    assert got.converged.all() and np.asarray(want.converged).all()
    np.testing.assert_allclose(got.poses.numpy()[:, :3, 3],
                               np.asarray(want.poses)[:, :3, 3], atol=tol)
    np.testing.assert_allclose(got.poses.numpy()[:, :3, :3],
                               np.asarray(want.poses)[:, :3, :3], atol=tol)
    if dtype == np.float64:
        for f in ("iterations", "evaluations", "gathers"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.host_syncs.numpy(),
                                  got.evaluations.numpy())


def test_online_steps_match_batch_and_rerun_is_bit_identical(scans):
    xyzi, mask = (torch.from_numpy(a) for a in scans)
    cfg = convert.odometry_config(CFG._asdict())
    batch = todo.ndt_odometry(xyzi, mask, cfg)
    state = todo.odometry_init(xyzi[0], mask[0], cfg)
    for i in range(1, xyzi.shape[0]):
        state, out = todo.odometry_step(state, xyzi[i], mask[i], cfg)
        assert torch.equal(state.pose, batch.poses[i])
        assert out[3] == int(batch.iterations[i])
    again = todo.ndt_odometry(xyzi, mask, cfg)
    assert torch.equal(again.poses, batch.poses)


def test_odometry_step_returns_jax_tuple(scans):
    """(pose, T, converged, iterations, trans_probability, evaluations,
    gathers) equal JAX's, f64; the port adds its host syncs, one an
    evaluation."""
    xyzi, mask = scans
    jx, jm = jnp.asarray(xyzi, np.float64), jnp.asarray(mask)
    jstate = jax.jit(jodo.odometry_init, static_argnums=2)(jx[0], jm[0], CFG)
    _, want = jax.jit(jodo.odometry_step, static_argnums=3)(
        jstate, jx[1], jm[1], CFG)
    txyzi, tmask = _port(scans, np.float64)
    cfg = _cfg()
    state = todo.odometry_init(txyzi[0], tmask[0], cfg)
    new_state, got = todo.odometry_step(state, txyzi[1], tmask[1], cfg)
    assert len(want) == 7 and len(got) == 8
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-8)
    assert got[2] == bool(want[2]) and got[3] == int(want[3])
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-8)
    assert (got[5], got[6]) == (int(want[5]), int(want[6]))
    assert got[7] == got[5]
    assert torch.equal(new_state.pose, got[0])
    assert torch.equal(new_state.prev_T, got[1])


@pytest.mark.parametrize("fine_regather", [0, 2])
def test_coarse_to_fine_matches_jax(scans, fine_regather):
    """Coarse 0.9 m stage (``tests/test_ndt.py``'s value) then the fine
    align, f64; evaluations and gathers are the two stages' sums."""
    xyzi, mask = scans
    jcfg = CFG._replace(coarse_leaf=0.9, fine_regather=fine_regather)
    want = jax.jit(lambda s, m: jodo.ndt_odometry(s, m, jcfg))(
        jnp.asarray(xyzi, np.float64), jnp.asarray(mask))
    got = todo.ndt_odometry(*_port(scans, np.float64),
                            convert.odometry_config(jcfg._asdict()))
    assert got.converged.all() and np.asarray(want.converged).all()
    _assert_poses(got.poses, want.poses, 1e-8)
    _assert_counts(got, want)
    plain = todo.ndt_odometry(*_port(scans, np.float64), _cfg())
    assert (got.evaluations[1:] > plain.evaluations[1:]).all()


def test_odometry_step_with_coarse_stage_sums_both_aligns(scans):
    xyzi, mask = _port(scans, np.float64)
    cfg = _cfg(coarse_leaf=0.9)
    state = todo.odometry_init(xyzi[0], mask[0], cfg)
    seen = []
    real = todo.ndt.ndt_align_lanes  # the step's aligns, one lane

    def recording(*args):
        res = real(*args)
        seen.append(todo.ndt.NDTResult(*(f[0] for f in res)))
        return res

    todo.ndt.ndt_align_lanes = recording
    try:
        _, out = todo.odometry_step(state, xyzi[1], mask[1], cfg)
    finally:
        todo.ndt.ndt_align_lanes = real
    coarse, fine = seen
    assert coarse.converged and fine.converged
    assert fine.evaluations == out[5] - coarse.evaluations
    assert out[6] == coarse.gathers + fine.gathers
    assert out[7] == coarse.host_syncs + fine.host_syncs


def test_port_imports_without_jax():
    """Every module of the port imports (the apps among them, without
    running), and an NDT, an ICP and a GICP align, the mapping app with its
    checkpoints, ``icp_slam``, ``ndt_eskf_fusion``, the fleet
    (``fleet_fusion``), ``parallel/batch.vmap_align``, ``loam_odometry``,
    ``batch_fusion`` (with a marginalisation), GNSS's ``prep_epochs`` and
    ``solve_epochs_local``, one ``fault_exclusion`` and one
    ``simulate_urban_epochs`` run, and the host library built and loaded
    with an lz4 bag written and read back (C and Python readers) and its
    scans packed from PCDs, with JAX made unimportable."""
    code = """
import sys
sys.modules["jax"] = None
import importlib, pkgutil
import toyslam_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import numpy as np, torch
from toyslam_tpu_torch.core import pointcloud
from toyslam_tpu_torch.registration import ndt
pts = np.random.default_rng(0).uniform(-5, 5, (2000, 3))
pts[:, 2] *= 0.1
cloud = pointcloud.from_numpy(pts, device="cpu")
r = ndt.ndt_align(ndt.build_ndt_map(cloud, ndt.NDTConfig(resolution=2.0)),
                  cloud)
assert r.converged
from toyslam_tpu_torch.registration import gicp, icp
small = pointcloud.from_numpy(pts[:500], capacity=512, device="cpu")
assert icp.icp_align(small, small).converged
assert gicp.gicp_align(small, small).converged
import tempfile
from pathlib import Path
from toyslam_tpu_torch.apps import mapping_demo
from toyslam_tpu_torch.core import pcd_io
from toyslam_tpu_torch.utils import checkpoint
with tempfile.TemporaryDirectory() as d:
    for k in range(3):
        pcd_io.write_pcd(f"{d}/cloud_{k}.pcd", pts + [0.2 * k, 0.0, 0.0])
    args = [d, f"{d}/out", "--device", "cpu", "--capacity", "2048",
            "--map-capacity", "2048", "--stream", "--checkpoint-every", "1"]
    assert mapping_demo.main(args) == 0
    assert (Path(d) / "out" / "mapping_state.npz").exists()
from toyslam_tpu_torch.pipelines import fusion, icp_slam
scans = torch.from_numpy(np.stack([np.c_[pts + [0.1 * k, 0.0, 0.0],
                                         np.zeros(len(pts))]
                                   for k in range(3)]))
smask = torch.ones(scans.shape[:2], dtype=torch.bool)
slam = icp_slam.icp_slam(scans[:, :500], smask[:, :500],
                         icp_slam.IcpSlamConfig(map_capacity=1024))
assert slam.iterations[1:].min() > 0 and int(slam.map_mask.sum()) > 0
imu = torch.zeros((60, 3), dtype=torch.float64)
acc = imu + torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64)
cfg = fusion.FusionConfig(odometry=fusion.odo.OdometryConfig(
    scan_leaf=0.5, work_capacity=2048))
fused = fusion.ndt_eskf_fusion(scans, smask, acc, imu,
                               torch.full((60,), 0.01, dtype=torch.float64),
                               cfg)
assert fused.converged.all() and fused.fused_p.shape == (60, 3)
assert torch.isfinite(fused.fused_p).all()
from toyslam_tpu_torch.parallel import batch
fleet = fusion.fleet_fusion(scans[None].expand(2, -1, -1, -1), smask[None].expand(2, -1, -1),
                            acc[None].expand(2, -1, -1), imu[None].expand(2, -1, -1),
                            torch.full((2, 60), 0.01, dtype=torch.float64), cfg, chunk=1)
assert torch.equal(fleet.poses[1], fused.poses)
pair = batch.vmap_align(scans[:2, :500], smask[:2, :500], scans[1:, :500],
                        smask[1:, :500], ndt.NDTConfig(resolution=2.0))
assert pair.converged.all()
assert batch.make_mesh(device="cpu") == [torch.device("cpu")]
from toyslam_tpu_torch.pipelines import batch_fusion, loam
from toyslam_tpu_torch.sim import loam_world
lscans, _ = loam_world.drive(2, 0, n_per_ring=90, n_rings=8)
lx, lm = loam_world.pack(lscans)
lo = loam.loam_odometry(torch.from_numpy(lx), torch.from_numpy(lm),
                        loam.LoamConfig(n_rings=8, vertical_fov_deg=(-25, 5)))
assert torch.isfinite(lo.positions).all() and int(lo.n_keyframes) >= 1
bf = batch_fusion.batch_fusion(
    acc[:12].reshape(3, 4, 3), imu[:12].reshape(3, 4, 3),
    torch.full((3, 4), 0.01, dtype=torch.float64),
    torch.ones((3, 4), dtype=torch.bool),
    torch.arange(3, dtype=torch.float64) * 0.04,
    torch.zeros((3, 3), dtype=torch.float64), torch.ones(3, dtype=torch.bool),
    config=batch_fusion.BatchFusionConfig(
        window=batch_fusion.window.WindowConfig(window_size=2,
                                                gn_iterations=1)))
assert torch.isfinite(bf.kf_p).all() and bool(bf.win.prior_valid)
from toyslam_tpu_torch.apps import gnss_demo
from toyslam_tpu_torch.gnss import local, pipeline as gpipe, raim
from toyslam_tpu_torch.sim import gps, urban
cpu = torch.device("cpu")
store, iono, ch, ref, _, gt = gnss_demo.simulate(6, 24, 1.5, 0, 1.5, cpu)
gcfg = gpipe.EpochConfig(apply_iono_correction=False)
gsol = local.solve_epochs_local(local.prep_epochs(store, iono, *ch, ref,
                                                  config=gcfg), gcfg)
assert gsol.valid.all()
assert (gsol.delta.double() + ref - gt).norm(dim=1).max() < 10
sim = gps.simulate_constellation(torch.Generator().manual_seed(0), ref,
                                 gps.GpsSimConfig(n_sats=8), fault_index=2)
excl, _, _ = raim.fault_exclusion(sim["sat_pos"], sim["pseudoranges"],
                                  torch.ones(8, dtype=torch.bool),
                                  torch.cat([ref, ref.new_zeros(1)]))
assert int(excl) == 2
city = urban.make_city(torch.Generator().manual_seed(1), device=cpu)
drive = urban.simulate_urban_epochs(
    torch.Generator().manual_seed(2), torch.zeros((3, 3), dtype=torch.float64),
    1000.0 + torch.arange(3, dtype=torch.float64),
    gpipe.synthetic_constellation(24, toe=1000.0, device=cpu), city,
    torch.tensor([0.39, 1.99, 50.0], dtype=torch.float64))
assert drive["budget"].usable.any()
from toyslam_tpu_torch.runtime import loader, native, rosbag
lib = native.build()
assert lib.parent.name == "_build" and native.bz2_available()
with tempfile.TemporaryDirectory() as d:
    clouds = [(1.5 + 0.1 * k, np.c_[pts + [0.2 * k, 0.0, 0.0],
                                    np.full(len(pts), k)].astype(np.float32))
              for k in range(3)]
    rosbag.write_bag(f"{d}/s.bag", clouds, compression="lz4")
    got = rosbag.pack_bag_scans(f"{d}/s.bag", capacity=2048)
    plain = rosbag.pack_bag_scans(f"{d}/s.bag", capacity=2048, native=False)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, plain))
    assert np.array_equal(got[0][2, :len(pts)], clouds[2][1])
    assert np.allclose([m[1] for m in rosbag.read_messages(f"{d}/s.bag")],
                       [1.5, 1.6, 1.7], rtol=0, atol=1e-9)
    for k, (_, c) in enumerate(clouds):
        pcd_io.write_pcd(f"{d}/cloud_{k}.pcd", c)
    stack = loader.load_scan_stack(loader.list_scan_files(d), 2048)
    assert stack[0].tobytes() == got[0].tobytes()
assert not any(k == "jax" or k.startswith(("jax.", "toyslam_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
