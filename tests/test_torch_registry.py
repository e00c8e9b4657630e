"""The port's config registry (``config``) and its remaining public
helpers (``core/se3.rot_x``, ``rot_y``, ``rot_z``, ``rot_mat_2d``,
``angle_mod``; ``core/pointcloud.shrink_to``, ``transform``) against the
JAX package's, on the CPU.

- ``config.load("configs/example.json")`` returns all 16 sections, each
  equal to ``convert``'s object of JAX's ``load``; ``default(kind)`` equals
  the converted JAX default for every kind; a file the port ``save``s
  reads back through JAX's ``load`` to equal configs, and one JAX saves
  (with its TPU dispatch knobs) through the port's; an unknown section or
  parameter raises.
- The helpers on seeded inputs (numpy, f64 unless said), JAX's side one
  jit: ``rot_x``/``rot_y``/``rot_z``/``rot_mat_2d`` within 4e-16, two
  ulps of 1 (observed equal: the two libraries' sin and cos may differ by
  an ulp elsewhere); ``angle_mod`` in its four branches (radians or
  degrees, [-pi, pi) or [0, 2 pi)) over 256 angles in [-4 pi, 4 pi] and
  the edges ``tests/test_properties.py:100-110`` found (a negative
  denormal, -1e-17, multiples of pi) within 1e-15 rad, about two ulps of
  pi (observed equal), and 1.2e-13 deg (observed 5.7e-14: the
  remainders round differently), on the circle: one odd multiple of pi
  lands on -180 deg in one package and 180 in the other; with the port's
  own range checks; ``shrink_to`` equal, ``transform`` of an f32 cloud
  with padded lanes within 4e-6 m, one f32 ulp at its 20-32 m (observed
  equal; the padded lanes keep their sentinel bit for bit).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu import config as jconfig  # noqa: E402
from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu_torch import config as tconfig  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.core import se3 as tse3  # noqa: E402

EXAMPLE = Path(__file__).resolve().parents[1] / "configs" / "example.json"
ROT_TOL = 4e-16
ANGLE_TOL = {False: 1e-15, True: 1.2e-13}  # by ``degree``
TRANSFORM_TOL = 4e-6

CONVERT = {
    "ndt": convert.ndt_config, "icp": convert.icp_config,
    "gicp": convert.gicp_config, "odometry": convert.odometry_config,
    "loam": convert.loam_config, "icp_slam": convert.icp_slam_config,
    "fusion": convert.fusion_config,
    "batch_fusion": convert.batch_fusion_config,
    "eskf": convert.eskf_params,
    "preintegration": convert.preintegration_params,
    "trilateration": convert.trilateration_config,
    "window": convert.window_config, "raim": convert.raim_config,
    "gnss_epoch": convert.epoch_config, "imu_sim": convert.imu_sim_params,
    "gps_sim": convert.gps_sim_config,
}


def _port(kind, jcfg):
    return CONVERT[kind](jcfg._asdict())


def test_registry_has_every_jax_section():
    assert set(tconfig.SECTIONS) == set(jconfig._registry()) == set(CONVERT)
    assert len(tconfig.SECTIONS) == 16


@pytest.mark.parametrize("kind", sorted(CONVERT))
def test_example_and_defaults_match_jax(kind):
    loaded = tconfig.load(EXAMPLE)
    assert set(loaded) == set(json.loads(EXAMPLE.read_text()))
    assert loaded[kind] == _port(kind, jconfig.load(EXAMPLE)[kind])
    assert tconfig.load_section(EXAMPLE, kind) == loaded[kind]
    assert tconfig.default(kind) == _departed(kind,
                                              _port(kind,
                                                    jconfig.default(kind)))


def _departed(kind, cfg):
    """A converted JAX default with the port's one stated departure: the
    odometry's map hash keeps ``NDTConfig``'s 1 << 16 rows
    (``pipelines/odometry.OdometryConfig``)."""
    if kind == "fusion":
        return cfg._replace(odometry=_departed("odometry", cfg.odometry))
    if kind == "odometry":
        return cfg._replace(ndt=cfg.ndt._replace(grid_capacity=1 << 16))
    return cfg


def test_save_round_trips_with_jax(tmp_path):
    ours = tconfig.load(EXAMPLE)
    ours["window"] = ours["window"]._replace(window_size=7, huber_delta=0.2)
    tconfig.save(tmp_path / "port.json", ours)
    back = jconfig.load(tmp_path / "port.json")
    assert set(back) == set(ours)
    for kind, cfg in back.items():
        assert _port(kind, cfg) == ours[kind], kind
    assert tconfig.load(tmp_path / "port.json") == ours
    assert tconfig.to_dict(ours["fusion"]) == json.loads(
        (tmp_path / "port.json").read_text())["fusion"]
    # JAX's own file, with its TPU dispatch knobs, through the port's load
    jax_all = {k: jconfig.default(k) for k in jconfig._registry()}
    jconfig.save(tmp_path / "jax.json", jax_all)
    for kind, cfg in tconfig.load(tmp_path / "jax.json").items():
        assert cfg == _port(kind, jax_all[kind]), kind
    assert "nn_mode" in json.loads((tmp_path / "jax.json").read_text())["icp"]


def test_unknown_section_or_parameter_raises(tmp_path):
    (tmp_path / "bad.json").write_text(json.dumps({"ndtt": {}}))
    with pytest.raises(KeyError, match="unknown config section"):
        tconfig.load(tmp_path / "bad.json")
    (tmp_path / "typo.json").write_text(json.dumps({"icp": {"max_iter": 3}}))
    with pytest.raises(KeyError, match="no parameter"):
        tconfig.load(tmp_path / "typo.json")


def _angles():
    rng = np.random.default_rng(11)
    edges = [-1e-320, -1e-17, 1e-17, 0.0, math.pi, -math.pi, 2 * math.pi,
             -2 * math.pi, 3 * math.pi, -4 * math.pi, 4 * math.pi]
    return np.concatenate([rng.uniform(-4 * math.pi, 4 * math.pi, 256),
                           edges])


def _cloud():
    rng = np.random.default_rng(12)
    pts = np.concatenate([rng.uniform(-20, 20, (300, 3)),
                          rng.uniform(0, 1, (300, 1))], 1).astype(np.float32)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, rng.uniform(-5, 5, 3)
    return pts, T


BRANCHES = [(z, d) for z in (False, True) for d in (False, True)]


@pytest.fixture(scope="module")
def jax_side():
    a = _angles()
    pts, T = _cloud()
    cloud = jpc.from_numpy(pts, capacity=512)

    def run(a, deg, cloud, T):
        rots = [f(a[:32]) for f in (jse3.rot_x, jse3.rot_y, jse3.rot_z,
                                    jse3.rot_mat_2d)]
        mods = [jse3.angle_mod(deg if d else a, zero_2_2pi=z, degree=d)
                for z, d in BRANCHES]
        return (rots, mods, jpc.shrink_to(cloud, 320),
                jpc.transform(cloud, T))

    out = jax.jit(run)(jnp.asarray(a), jnp.asarray(np.rad2deg(a)), cloud,
                       jnp.asarray(T))
    return jax.tree_util.tree_map(np.asarray, out)


def test_rotations_match_jax(jax_side):
    rots = jax_side[0]
    a = torch.from_numpy(_angles()[:32])
    for f, want in zip((tse3.rot_x, tse3.rot_y, tse3.rot_z,
                        tse3.rot_mat_2d), rots):
        got = f(a)
        assert got.shape == want.shape and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROT_TOL)
    # the numpy route of ``utils/plotio``
    np.testing.assert_array_equal(
        tse3.rot_mat_2d(0.3), np.array([[np.cos(0.3), -np.sin(0.3)],
                                        [np.sin(0.3), np.cos(0.3)]]))
    R = tse3.rot_x(a[3]) @ tse3.rot_y(a[4]) @ tse3.rot_z(a[5])
    np.testing.assert_allclose(
        R.numpy(), tse3.euler_xyz_to_rot(a[3:6]).numpy(), rtol=0,
        atol=1e-15)


@pytest.mark.parametrize("branch", range(4),
                         ids=[f"{'0_2pi' if z else 'pm_pi'}-"
                              f"{'deg' if d else 'rad'}"
                              for z, d in BRANCHES])
def test_angle_mod_matches_jax(jax_side, branch):
    z, d = BRANCHES[branch]
    a = _angles()
    x = torch.from_numpy(np.rad2deg(a) if d else a)
    got = tse3.angle_mod(x, zero_2_2pi=z, degree=d).numpy()
    want = jax_side[1][branch]
    full = 360.0 if d else 2 * math.pi
    # On the circle: the [-pi, pi) branch may round an odd multiple of pi
    # to either end, both the same angle.
    diff = np.abs(got - want)
    np.testing.assert_allclose(np.minimum(diff, np.abs(diff - full)), 0,
                               rtol=0, atol=ANGLE_TOL[d])
    if z:
        np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_TOL[d])
    if z:
        assert (got >= 0).all() and (got < full).all()
    else:
        assert (got >= -full / 2).all() and (got <= full / 2).all()
        again = tse3.angle_mod(torch.from_numpy(got), degree=d).numpy()
        np.testing.assert_allclose(again, got, rtol=0, atol=ANGLE_TOL[d])


def test_pointcloud_helpers_match_jax(jax_side):
    pts, T = _cloud()
    cloud = tpc.from_numpy(pts, capacity=512, device="cpu")
    small = tpc.shrink_to(cloud, 320)
    want_small, want_moved = jax_side[2], jax_side[3]
    np.testing.assert_array_equal(small.xyzi.numpy(), want_small.xyzi)
    np.testing.assert_array_equal(small.mask.numpy(), want_small.mask)
    moved = tpc.transform(cloud, torch.from_numpy(T))
    np.testing.assert_allclose(moved.xyzi.numpy(), want_moved.xyzi, rtol=0,
                               atol=TRANSFORM_TOL)
    pad = ~cloud.mask.numpy()
    np.testing.assert_array_equal(moved.xyzi.numpy()[pad],
                                  cloud.xyzi.numpy()[pad])
    np.testing.assert_array_equal(moved.mask.numpy(), want_moved.mask)
