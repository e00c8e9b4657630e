"""The port's LOAM feature odometry against the JAX package on the CPU:
``sim/loam_world``, ``pipelines/loam`` and the ``loam_demo`` app.

The same numpy scans (16 x 360 rays of the walls-poles-ground world) go
through both packages in f64. The configuration is the default with the
bench's 16 rings, the feature caps at the most the 16 x 6 sectors can
pick (192 edge, 384 surface: the picks are the default's) and the maps
cut to 1024 and 2048 points (they hold < 1000 after 6 scans). Bounds,
each about twice what was observed:

- the generator: bit-equal to ``tests/test_loam.py``'s ray loop at three
  poses, and the drive's scans bit-equal to the JAX app's with its poses
  within 1e-15 m;
- ``organize_scan`` and ``organize_and_extract``: every field and every
  pick equal but the curvature, within 4e-16 relative (observed 1.9e-16:
  XLA sums the stencil's three components in its own order). The
  percentile sort's keys ``ring * 4 + c / (c + 1)`` are distinct on this
  data (checked), so its order does not depend on how ties break;
- the curvature against ``tests/golden_loam.py`` within 1e-9 relative,
  the adaptive thresholds within 35 % of the reference's (its border
  points, the JAX package's bounds);
- ``update_maps`` after two keyframes: masks equal, means within 1e-15 m
  (observed 4.4e-16); ``_knn`` from a pose 10 cm off: indices equal on
  the picked features' rows (unpicked 1e9 rows tie and weigh nothing),
  squared distances within 2.5e-13 m^2 (observed 1.1e-13); the edge and
  surface factor sums (A, b) within 2e-14 of their largest entry
  (observed 1.1e-14) with equal counts; ``optimize_pose`` within 1.5e-15
  m and 2e-17 (observed 6.7e-16, 6.9e-18);
- ``loam_odometry`` over 5 scans: positions within 6e-15 m (observed
  2.7e-15), quaternions within 5e-16 (observed 2.1e-16), the same
  keyframe count;
- the app in f32 over 2 frames against the JAX app (also f32): the
  trajectory file within 2e-6 (its six decimals; observed one flip of the
  last digit, 1e-6).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import golden_loam as G  # noqa: E402
import test_loam as jtest_loam  # noqa: E402
import test_loam_golden as jgolden  # noqa: E402

from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.pipelines import loam as jloam  # noqa: E402
from toyslam_tpu_torch import config as tconfig  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import se3 as tse3  # noqa: E402
from toyslam_tpu_torch.core.pointcloud import PointCloud  # noqa: E402
from toyslam_tpu_torch.pipelines import loam as tloam  # noqa: E402
from toyslam_tpu_torch.sim import loam_world  # noqa: E402

KW = dict(n_rings=16, vertical_fov_deg=(-25.0, 5.0), max_edge_features=192,
          max_surf_features=384, map_capacity_edge=256,
          map_capacity_surf=1024)
JCFG, TCFG = jloam.LoamConfig(**KW), tloam.LoamConfig(**KW)
SCANS = 5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_generator_matches_the_jax_test_world():
    for k in range(3):
        T = tse3.pose6_to_matrix(torch.tensor(
            [0.3 * k, -0.2 * k, 0.0, 0.01 * k, -0.02 * k, 0.3 * k],
            dtype=torch.float64)).numpy()
        want = jtest_loam._synthetic_lidar_scan(np.random.default_rng(k), T)
        got = loam_world.synthetic_lidar_scan(np.random.default_rng(k), T)
        np.testing.assert_array_equal(got, want)
    spec = importlib.util.spec_from_file_location(
        "jax_loam_demo", TESTS.parent / "apps" / "loam_demo.py")
    japp = importlib.util.module_from_spec(spec)  # JAX, in f64 here
    spec.loader.exec_module(japp)
    want_scans, want_poses, rings, fov = japp._synthetic_drive(3, 5)
    scans, poses = loam_world.drive(3, 5, step_dtype=np.float64)
    assert (rings, fov) == (16, (-25.0, 5.0))
    for got, want in zip(scans, want_scans):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(poses, np.stack(want_poses), rtol=0,
                               atol=1e-15)


def test_curvature_matches_golden_loam():
    pts = jgolden._clean_scan()
    oracle = G.extract_features(pts, jgolden.N_RINGS, fov_deg=jgolden.FOV,
                                edge_threshold=1.0, surf_threshold=0.1)
    cfg = tloam.LoamConfig(n_rings=jgolden.N_RINGS,
                           vertical_fov_deg=jgolden.FOV)
    xyzi = np.full((6144, 4), 1e9)
    xyzi[:len(pts), :3], xyzi[:len(pts), 3] = pts, 0.0
    org = tloam.organize_scan(PointCloud(_t(xyzi), _t(np.arange(6144)
                                                      < len(pts))), cfg)
    ocurv = {jgolden._key(p): c for ln in oracle["lines"]
             for p, c in zip(ln.pts, ln.curv) if c > 0.0}
    xs, curv = org.xyz.numpy(), org.curvature.numpy()
    compared = 0
    for i in np.flatnonzero(org.cur_ok.numpy()):
        key = jgolden._key(xs[i])
        if key in ocurv:
            assert abs(curv[i] - ocurv[key]) <= 1e-9 * max(1.0, ocurv[key])
            compared += 1
    assert compared > 2000
    ring = org.ring.numpy()
    for r in range(jgolden.N_RINGS):
        if len(oracle["lines"][r].pts) >= 40 and (ring == r).any():
            for thr, name in ((org.edge_thr, "edge_thr"),
                              (org.surf_thr, "surf_thr")):
                want = oracle[name][r]
                got = float(np.median(thr.numpy()[ring == r]))
                assert abs(got - want) <= 0.35 * max(want, 1e-6)


@pytest.fixture(scope="module")
def drive():
    """5 scans of the bench's drive (f64 step) in f64, their true poses,
    and a start pose for scan 2 10 cm and 0.02 rad off its own."""
    scans, poses = loam_world.drive(SCANS, 3, step_dtype=np.float64)
    xyzi, mask = loam_world.pack(scans)
    q = tse3.rot_to_quat(_t(poses[:, :3, :3]))
    q0 = tse3.quat_boxplus(q[2], torch.tensor([0.0, 0.0, 0.02],
                                              dtype=torch.float64))
    t0 = _t(poses[2, :3, 3]) + torch.tensor([0.1, -0.05, 0.0],
                                            dtype=torch.float64)
    return xyzi.astype(np.float64), mask, poses, q, q0, t0


def _stages(lib, cfg, xyzi, mask, q, pos, q0, t0, maps):
    """What the tests compare, through ``lib`` (either package's
    pipelines/loam): scans 0 and 3 organised and extracted; ``maps`` after
    scans 0 and 1 at their true poses (q, pos); scan 2's kNN and factor
    sums at (q0, t0) and its pose optimised from there; the odometry."""
    cloud = jpc.PointCloud if lib is jloam else PointCloud
    out = {}
    for k in (0, 3):
        c = cloud(xyzi[k], mask[k])
        out[f"org{k}"] = lib.organize_scan(c, cfg)
        out[f"feat{k}"] = lib.organize_and_extract(c, cfg)
    for k in (0, 1):
        maps = lib.update_maps(maps, lib.organize_and_extract(
            cloud(xyzi[k], mask[k]), cfg), q[k], pos[k], cfg)
    out["maps"] = maps
    f2 = lib.organize_and_extract(cloud(xyzi[2], mask[2]), cfg)
    R = (jse3 if lib is jloam else tse3).quat_to_rot(q0)
    for side, acc in (("edge", lib._accumulate_edge_factors),
                      ("surf", lib._accumulate_surf_factors)):
        local, fmask = getattr(f2, f"{side}_xyz"), getattr(f2, f"{side}_mask")
        ref = getattr(maps, f"{side}_xyz")
        rmask = getattr(maps, f"{side}_mask")
        world = local @ R.T + t0
        out[f"knn_{side}"] = lib._knn(world, fmask, ref, rmask, cfg.nn_k)
        out[f"sums_{side}"] = acc(world, fmask, R, local, ref, rmask, cfg)
    out["pose"] = lib.optimize_pose(f2, maps, q0, t0, cfg)
    out["odometry"] = lib.loam_odometry(xyzi, mask, cfg)
    return out


@pytest.fixture(scope="module")
def stages(drive):
    """Both packages' stages on the same inputs, JAX's in one jit."""
    xyzi, mask, poses, q, q0, t0 = drive
    tmaps = tloam.empty_maps(TCFG, torch.float64, "cpu")
    args = (xyzi, mask, q, poses[:, :3, 3], q0, t0)
    got = _stages(tloam, TCFG, *map(_t, args), tmaps)
    want = jax.jit(lambda *a: _stages(jloam, JCFG, *a))(
        *(jnp.asarray(np.asarray(a)) for a in args),
        jloam.LoamMaps(*(jnp.asarray(m.numpy()) for m in tmaps)))
    return got, want


def test_organize_and_extract_match_jax(stages):
    got, want = stages
    for k in (0, 3):
        org = got[f"org{k}"]
        for f in org._fields:
            if f != "curvature":
                _eq(getattr(org, f), getattr(want[f"org{k}"], f))
        # XLA fuses the stencil's 3-term sum in its own order: 1 ulp.
        c, jc = org.curvature.numpy(), np.asarray(want[f"org{k}"].curvature)
        np.testing.assert_allclose(c, jc, rtol=4e-16, atol=0)
        ok = org.cur_ok.numpy()
        ok = org.cur_ok.numpy()
        c = org.curvature.numpy()[ok]
        keys = org.ring.numpy()[ok] * 4.0 + c / (c + 1.0)
        assert np.unique(keys).size == keys.size
        feat = got[f"feat{k}"]
        for f in feat._fields:
            _eq(getattr(feat, f), getattr(want[f"feat{k}"], f))
        assert 10 < int(feat.edge_mask.sum()) and 100 < int(
            feat.surf_mask.sum())


def test_update_maps_matches_jax(stages):
    got, want = stages
    for f in ("edge_mask", "surf_mask"):
        _eq(getattr(got["maps"], f), getattr(want["maps"], f))
    for f in ("edge_xyz", "surf_xyz"):
        _close(getattr(got["maps"], f), getattr(want["maps"], f), 1e-15)
    assert 100 < int(got["maps"].surf_mask.sum()) < KW["map_capacity_surf"]


def test_knn_and_factor_sums_match_jax(stages):
    got, want = stages
    for side in ("edge", "surf"):
        (ti, td, tv), (ji, jd, jv) = got[f"knn_{side}"], want[f"knn_{side}"]
        _eq(tv, jv)
        # Rows of unpicked features (1e9) rank ties and carry no weight.
        rows = tv.numpy().any(1)
        assert rows.sum() > 20
        np.testing.assert_array_equal(ti.numpy()[rows], np.asarray(ji)[rows])
        np.testing.assert_allclose(td.numpy()[rows], np.asarray(jd)[rows],
                                   rtol=0, atol=2.5e-13)
        (tA, tb, tn), (jA, jb, jn) = got[f"sums_{side}"], want[f"sums_{side}"]
        assert int(tn) == int(jn) > 20
        scale = float(np.abs(np.asarray(jA)).max())
        _close(tA, jA, 2e-14 * scale)
        _close(tb, jb, 2e-14 * scale)


def test_optimize_pose_matches_jax(stages, drive):
    got, want = stages
    (tq, tt), (jq, jt) = got["pose"], want["pose"]
    _close(tt, jt, 1.5e-15)
    _close(tq, jq, 2e-17)
    assert float(torch.linalg.norm(tt - _t(drive[2][2, :3, 3]))) < 0.05


def test_loam_odometry_matches_jax(stages, drive):
    got, want = stages
    tout, jout = got["odometry"], want["odometry"]
    _close(tout.positions, jout.positions, 6e-15)
    _close(tout.quaternions, jout.quaternions, 5e-16)
    assert int(tout.n_keyframes) == int(jout.n_keyframes) >= 1
    err = np.linalg.norm(tout.positions.numpy() - drive[2][:, :3, 3], axis=1)
    assert err.max() < 0.3


def _trajectory(path):
    return np.loadtxt(path, comments="#")


def test_loam_demo_matches_jax_app(tmp_path):
    from toyslam_tpu_torch.apps import loam_demo

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    proc = subprocess.run(
        [sys.executable, str(TESTS.parent / "apps" / "loam_demo.py"),
         str(jdir), "--frames", "2"], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert loam_demo.main([str(tdir), "--frames", "2", "--device",
                           "cpu"]) == 0
    for name in ("taslo_trajectory.txt", "solution.csv", "metrics.jsonl"):
        assert (tdir / name).exists()
    got, want = (_trajectory(tdir / "taslo_trajectory.txt"),
                 _trajectory(jdir / "taslo_trajectory.txt"))
    assert got.shape == want.shape == (2, 8)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    # The file's six decimals: one flip of the last digit observed.
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=2e-6)


def test_loam_config_and_convert():
    assert convert.loam_config(jloam.LoamConfig()._asdict()) == (
        tloam.LoamConfig())
    assert convert.loam_config(JCFG._asdict()) == TCFG
    example = TESTS.parent / "configs" / "example.json"
    from toyslam_tpu import config as jconfig

    assert tconfig.load_section(example, "loam") == convert.loam_config(
        jconfig.load(example)["loam"]._asdict())
