"""The port's ICP-SLAM slice against the JAX package on the CPU:
``pipelines/icp_slam``, the evaluation helpers it reports with
(``utils/evalio``: ``read_evapos_csv``, ``rpe``, ``compare_solutions``)
and the ``icp_demo`` app.

Inputs from numpy with fixed seeds: ``tests/test_icp.py``'s 4-frame
icpslam scene. Bounds, each about twice what was observed:

- ``icp_slam`` in f64: poses within 6e-15 (observed 2.9e-15), the final
  ICP errors (mean matched distances, ~5e-3 m) within 2e-13 m (observed
  8.4e-14), the map's voxel count equal and its means within 4e-14 m
  (observed 1.6e-14), and every frame's
  ICP iteration count equal to JAX's ``icp_align`` run from the same map
  and guess;
- the evalio helpers on files written by the JAX writers: equal (f64
  numpy on both sides, the same formulas);
- the app (``--device cpu --seed 1``, 4 frames of 500 points):
  ``Solution1.csv`` byte-equal to the JAX app's, and its ATE < 0.1 m gate.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core.pointcloud import PointCloud as JCloud  # noqa: E402
from toyslam_tpu.pipelines import icp_slam as jslam  # noqa: E402
from toyslam_tpu.registration import icp as jicp  # noqa: E402
from toyslam_tpu.utils import evalio as jevalio  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.apps import icp_demo  # noqa: E402
from toyslam_tpu_torch.pipelines import icp_slam as tslam  # noqa: E402
from toyslam_tpu_torch.utils import evalio as tevalio  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
POSE_ATOL = 6e-15
ERR_ATOL = 2e-13
MAP_ATOL = 4e-14


def _frames(dtype):
    """``tests/test_icp.py:45``'s scene: 4 frames of 400 points seen from a
    sensor moving 0.1/0.05 m a frame."""
    rng = np.random.default_rng(42)
    base = rng.uniform(-5, 5, size=(400, 3))
    S, cap = 4, 512
    xyzi = np.full((S, cap, 4), 1e9)
    mask = np.zeros((S, cap), bool)
    for i in range(S):
        shift = np.array([0.1 * i, 0.05 * i, 0.0])
        xyzi[i, :400, :3] = base - shift + 0.002 * rng.normal(
            size=base.shape)
        xyzi[i, :400, 3] = 0
        mask[i, :400] = True
    return xyzi.astype(dtype), mask


@pytest.fixture(scope="module")
def slam64():
    xyzi, mask = _frames(np.float64)
    jcfg = jslam.IcpSlamConfig(map_capacity=2048, map_leaf=0.3)
    want = jax.jit(jslam.icp_slam, static_argnums=2)(
        jnp.asarray(xyzi), jnp.asarray(mask), jcfg)
    cfg = convert.icp_slam_config(jcfg._asdict())
    scans, masks = torch.from_numpy(xyzi), torch.from_numpy(mask)
    return xyzi, mask, cfg, jcfg, want, tslam.icp_slam(scans, masks, cfg)


def test_icp_slam_matches_jax_f64(slam64):
    *_, want, got = slam64
    assert got.poses.dtype == torch.float64
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors),
                               rtol=0, atol=ERR_ATOL)
    assert int(got.map_mask.sum()) == int(np.asarray(want.map_mask).sum())
    np.testing.assert_allclose(got.map_xyzi.numpy()[got.map_mask.numpy()],
                               np.asarray(want.map_xyzi)[
                                   np.asarray(want.map_mask)],
                               rtol=0, atol=MAP_ATOL)
    # The motion is recovered (tests/test_icp.py's own bound).
    true_t = np.array([[0.1 * i, 0.05 * i, 0.0] for i in range(4)])
    assert np.abs(got.poses.numpy()[:, :3, 3] - true_t).max() < 0.15


def test_icp_slam_iterations_match_jax_align(slam64):
    """Frame i's ICP iterations equal JAX's icp_align from the port's map
    after frame i - 1 and the same guess."""
    xyzi, mask, cfg, jcfg, _, got = slam64
    align = jax.jit(lambda s, t, g: jicp.icp_align(s, t, g, jcfg.icp))
    scans, masks = torch.from_numpy(xyzi), torch.from_numpy(mask)
    for i in range(1, xyzi.shape[0]):
        prefix = tslam.icp_slam(scans[:i], masks[:i], cfg)
        res = align(JCloud(jnp.asarray(xyzi[i]), jnp.asarray(mask[i])),
                    JCloud(jnp.asarray(prefix.map_xyzi.numpy()),
                           jnp.asarray(prefix.map_mask.numpy())),
                    jnp.asarray(got.poses[i - 1].numpy()))
        assert int(res.iterations) == int(got.iterations[i]), i
        assert bool(res.converged)


def test_icp_slam_f32_runs_through_k4_route(slam64):
    xyzi, mask, cfg, *_ = slam64
    out = tslam.icp_slam(torch.from_numpy(xyzi.astype(np.float32)),
                         torch.from_numpy(mask), cfg)
    assert out.poses.dtype == torch.float32
    assert out.iterations[0] == 0 and (out.iterations[1:] > 0).all()
    true_t = np.array([[0.1 * i, 0.05 * i, 0.0] for i in range(4)])
    assert np.abs(out.poses.numpy()[:, :3, 3] - true_t).max() < 0.15


def _trajectories():
    rng = np.random.default_rng(8)
    n = 30
    times = np.arange(n) * 0.1
    T = np.tile(np.eye(4), (n, 1, 1))
    yaw = np.cumsum(rng.normal(0, 0.2, n))
    T[:, 0, 0], T[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    T[:, 1, 0], T[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    T[:, :3, 3] = np.cumsum(rng.normal(0, 0.3, (n, 3)), 0)
    T2 = T.copy()
    T2[:, :3, 3] += rng.normal(0, 0.05, (n, 3))
    return times, T, T2


def test_read_evapos_csv_of_jax_files(tmp_path):
    times, T, _ = _trajectories()
    jevalio.write_evapos_csv(tmp_path / "a.csv",
                             jevalio.from_transforms(times + 3.0, T))
    want = jevalio.read_evapos_csv(tmp_path / "a.csv")
    got = tevalio.read_evapos_csv(tmp_path / "a.csv")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.time[0] == 0.0


def test_compare_solutions_and_rpe_match_jax(tmp_path):
    times, T, T2 = _trajectories()
    for name, traj in (("a", T), ("b", T2)):
        jevalio.write_evapos_csv(tmp_path / f"{name}.csv",
                                 jevalio.from_transforms(times, traj))
    ja, jb = (jevalio.read_evapos_csv(tmp_path / f"{n}.csv") for n in "ab")
    ta, tb = (tevalio.read_evapos_csv(tmp_path / f"{n}.csv") for n in "ab")
    want = jevalio.compare_solutions(ja, jb)
    got = tevalio.compare_solutions(ta, tb)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    for delta in (1, 5):
        assert tevalio.rpe(T2, T, delta) == jevalio.rpe(T2, T, delta)


def test_icp_demo_cpu_solution1_equals_jax_app(tmp_path, capsys):
    args = ["--seed", "1", "--frames", "4", "--points", "500"]
    assert icp_demo.main([str(tmp_path / "port"), *args, "--device",
                          "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ate_rmse_m"] < 0.1 and summary["device"] == "cpu"
    proc = subprocess.run(
        [sys.executable, str(REPO / "apps" / "icp_demo.py"),
         str(tmp_path / "jax"), *args], capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert ((tmp_path / "port" / "Solution1.csv").read_bytes()
            == (tmp_path / "jax" / "Solution1.csv").read_bytes())
    rows = [json.loads(line) for line in
            (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 5 and rows[-1]["event"] == "evapos"
