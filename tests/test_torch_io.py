"""The port's host-side modules against the JAX package's: quaternions,
trajectory writers and ATE (``utils/evalio``), PCD files (``core/pcd_io``),
the scan loader, config files, and the mapping app on the CPU.

Bounds: quaternions and ATE within 1e-12 (f64; the same formulas); the
TUM and EvaPos files, PCD round trips and loaded scan stacks equal byte
for byte. The app (``--device cpu``, five generated 16 x 512-ray scans):
batch, ``--stream`` and ``--resume`` write the same trajectory, solution
and map bytes, and its trajectory lies within 5e-4 m of the JAX app's on
the same PCD directory (both f32; observed 2e-6, one unit of the TUM
file's sixth decimal).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax.numpy as jnp  # noqa: E402

from toyslam_tpu import config as jconfig  # noqa: E402
from toyslam_tpu.core import pcd_io as jpcd  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.runtime import loader as jloader  # noqa: E402
from toyslam_tpu.utils import evalio as jevalio  # noqa: E402
from toyslam_tpu_torch import config as tconfig  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.apps import mapping_demo  # noqa: E402
from toyslam_tpu_torch.core import pcd_io as tpcd  # noqa: E402
from toyslam_tpu_torch.core import se3 as tse3  # noqa: E402
from toyslam_tpu_torch.runtime import loader as tloader  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402
from toyslam_tpu_torch.utils import evalio as tevalio  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _poses(n=24, seed=3):
    """Random poses; every fourth rotation near pi about one axis, so that
    each of the four Shepperd candidates is picked."""
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-np.pi, np.pi, (n, 3))
    for k, axis in enumerate(np.eye(3)):
        rpy[4 * k + 1] = np.pi * axis + 1e-3 * rng.normal(size=3)
    R = tse3.euler_xyz_to_rot(torch.from_numpy(rpy)).numpy()
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = np.cumsum(rng.normal(0, 0.5, (n, 3)), 0)
    return np.arange(n) * 0.1, T


def test_rot_to_quat_matches_jax():
    _, T = _poses()
    got = tse3.rot_to_quat(torch.from_numpy(T[:, :3, :3])).numpy()
    want = np.asarray(jse3.rot_to_quat(jnp.asarray(T[:, :3, :3])))
    np.testing.assert_allclose(got, want, atol=1e-12)
    picks = np.argmax(np.stack([1 + np.trace(T[:, :3, :3], axis1=1, axis2=2),
                                *(1 + 2 * T[:, i, i]
                                  - np.trace(T[:, :3, :3], axis1=1, axis2=2)
                                  for i in range(3))], -1), -1)
    assert set(picks) == {0, 1, 2, 3}
    f32 = tse3.rot_to_quat(torch.from_numpy(T[:, :3, :3]).float())
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), want, atol=1e-6)


def test_trajectory_writers_match_jax(tmp_path):
    times, T = _poses()
    for name, mod in (("jax", jevalio), ("port", tevalio)):
        mod.write_tum(tmp_path / f"{name}.txt", times, T)
        mod.write_evapos_csv(tmp_path / f"{name}.csv",
                             mod.from_transforms(times, T))
    for ext in ("txt", "csv"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes())
    t, pos, quat = tevalio.read_tum(tmp_path / "port.txt")
    np.testing.assert_allclose(pos, T[:, :3, 3], atol=1e-6)
    np.testing.assert_allclose(t, times, atol=1e-6)
    for got, want in zip(tevalio.read_tum(tmp_path / "port.txt"),
                         jevalio.read_tum(tmp_path / "jax.txt")):
        np.testing.assert_array_equal(got, want)


def test_ate_and_error_stats_match_jax():
    _, T = _poses()
    est = T[:, :3, 3] + np.random.default_rng(1).normal(0, 0.05, (len(T), 3))
    for align in (True, False):
        got, want = (mod.ate(est, T[:, :3, 3], align=align)
                     for mod in (tevalio, jevalio))
        np.testing.assert_allclose(got[0], want[0], atol=1e-12)
        np.testing.assert_allclose(got[1], want[1], atol=1e-12)
    errs = np.abs(est - T[:, :3, 3]).ravel()
    assert tuple(tevalio.error_stats(errs)) == tuple(
        jevalio.error_stats(errs))
    assert tuple(tevalio.error_stats([])) == tuple(jevalio.error_stats([]))


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_round_trip_and_jax_files(tmp_path, binary):
    pts = np.random.default_rng(2).normal(0, 20, (500, 4)).astype(np.float32)
    tpcd.write_pcd(tmp_path / "port.pcd", pts, binary=binary)
    jpcd.write_pcd(tmp_path / "jax.pcd", pts, binary=binary)
    assert ((tmp_path / "port.pcd").read_bytes()
            == (tmp_path / "jax.pcd").read_bytes())
    back = tpcd.read_pcd(tmp_path / "jax.pcd")
    if binary:
        np.testing.assert_array_equal(back, pts)
    else:  # "%.8g" text holds a float32 to within one rounding
        np.testing.assert_allclose(back, pts, rtol=1e-7)
    np.testing.assert_array_equal(back, jpcd.read_pcd(tmp_path / "port.pcd"))
    tpcd.write_pcd(tmp_path / "xyz.pcd", pts[:, :3], binary=binary)
    xyz = tpcd.read_pcd(tmp_path / "xyz.pcd")
    assert (xyz[:, 3] == 0).all() and xyz.shape == (500, 4)


def _lzf(data: bytes) -> bytes:
    """An LZF stream of ``data`` whose last 40 bytes repeat the 40 before
    them: literal runs, then one back reference."""
    out = bytearray()
    head = data[:-40]
    for i in range(0, len(head), 32):
        chunk = head[i:i + 32]
        out += bytes([len(chunk) - 1]) + chunk
    length, off = 40 - 2, 40 - 1  # copy 40 bytes from 40 back
    out += bytes([(7 << 5) | (off >> 8), length - 7, off & 0xFF])
    return bytes(out)


def test_binary_compressed_pcd_matches_jax(tmp_path):
    pts = np.random.default_rng(4).normal(0, 5, (10, 4)).astype(np.float32)
    pts[:, 3] = pts[:, 2]  # field-major: the last 40 bytes repeat
    soa = np.ascontiguousarray(pts.T).tobytes()
    payload = _lzf(soa)
    assert len(payload) < len(soa)
    head = ("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
            "TYPE F F F F\nCOUNT 1 1 1 1\nWIDTH 10\nHEIGHT 1\n"
            "POINTS 10\nDATA binary_compressed\n").encode()
    body = np.array([len(payload), len(soa)], "<u4").tobytes() + payload
    (tmp_path / "c.pcd").write_bytes(head + body)
    got = tpcd.read_pcd(tmp_path / "c.pcd")
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(got, jpcd.read_pcd(tmp_path / "c.pcd"))


def test_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    for k in (10, 2, 1):
        pts = rng.normal(0, 5, (100 + k, 4)).astype(np.float32)
        pts[3] = np.nan
        tpcd.write_pcd(tmp_path / f"cloud_{k}.pcd", pts)
    files = tloader.list_scan_files(tmp_path)
    assert [f.name for f in files] == ["cloud_1.pcd", "cloud_2.pcd",
                                       "cloud_10.pcd"]
    assert files == jloader.list_scan_files(tmp_path)
    got = tloader.load_scan_stack(files, 105)
    want = jloader.load_scan_stack(files, 105)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert not got[1][:, 3].any() and got[1][:, 2].all()


def test_config_file_loads_like_jax(tmp_path):
    path = REPO / "configs" / "example.json"
    want = jconfig.load(path)["odometry"]
    assert tconfig.load_odometry(path) == convert.odometry_config(
        want._asdict())
    (tmp_path / "typo.json").write_text(
        '{"odometry": {"ndt": {"step_sise": 0.2}}}')
    with pytest.raises(KeyError, match="step_sise"):
        tconfig.load_odometry(tmp_path / "typo.json")


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scans")
    xyzi, mask, _ = spinning_lidar_scans(2, 5, 16, 512)
    for k in range(len(xyzi)):
        tpcd.write_pcd(d / f"cloud_{k}.pcd", xyzi[k][mask[k]])
    return d


APP_ARGS = ("--device", "cpu", "--capacity", "8192", "--map-capacity",
            "4096")
OUTPUTS = ("trajectory.txt", "solution.csv", "map.pcd")


def test_mapping_app_stream_resume_and_jax(scan_dir, tmp_path, capsys):
    def run(out, *extra):
        assert mapping_demo.main([str(scan_dir), str(out), *APP_ARGS,
                                  *extra]) == 0
        return capsys.readouterr().out

    run(tmp_path / "batch")
    run(tmp_path / "stream", "--stream", "--checkpoint-every", "2")
    ckpt = tmp_path / "stream" / "mapping_state.npz"
    assert ckpt.exists()
    (tmp_path / "resume").mkdir()
    (tmp_path / "resume" / ckpt.name).write_bytes(ckpt.read_bytes())
    out = run(tmp_path / "resume", "--stream", "--resume")
    assert "resumed from" in out and "at scan 5" in out
    for name in OUTPUTS:
        batch = (tmp_path / "batch" / name).read_bytes()
        assert (tmp_path / "stream" / name).read_bytes() == batch
        assert (tmp_path / "resume" / name).read_bytes() == batch
    n_map = len(tpcd.read_pcd(tmp_path / "batch" / "map.pcd"))
    assert f"map.pcd ({n_map} pts)" in out
    metrics = tevalio.MetricsLogger(
        tmp_path / "batch" / "metrics.jsonl").read()
    assert [m["scan"] for m in metrics] == list(range(5))
    assert all(m["converged"] for m in metrics)

    proc = subprocess.run(
        [sys.executable, str(REPO / "apps" / "mapping_demo.py"),
         str(scan_dir), str(tmp_path / "jax"), *APP_ARGS],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    _, got, _ = tevalio.read_tum(tmp_path / "batch" / "trajectory.txt")
    _, want, _ = jevalio.read_tum(tmp_path / "jax" / "trajectory.txt")
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_mapping_app_needs_a_card_unless_told_cpu(scan_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mapping_demo.main([str(scan_dir), str(tmp_path / "out")])


def test_mapping_app_refuses_a_bag(tmp_path):
    """A file that is not a ROS bag is refused by the C reader (bags
    themselves: tests/test_torch_rosbag.py)."""
    bag = tmp_path / "drive.bag"
    bag.write_bytes(b"")
    with pytest.raises(ValueError, match="malformed ROS bag"):
        mapping_demo.main([str(bag), str(tmp_path / "out"), "--device",
                           "cpu"])
