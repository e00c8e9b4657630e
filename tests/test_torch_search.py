"""The port's NDT search helpers and the align app against the JAX
package on the CPU.

Inputs from numpy with fixed seeds: a floor + wall + cross-wall scene,
its NDT map built by the JAX package and carried across with
``convert.ndt_map``, so that both sides search one map. Bounds, each
about twice what was observed:

- ``fitness_score`` in f64 within 5e-15 relative (observed 1.7e-15: K4's
  plain version takes ``min(|t|^2 - 2 s.t) + |s|^2``, JAX ``min((|s|^2 -
  2 s.t) + |t|^2)``); in f32 within 2e-6 relative (observed 1.05e-6, the
  same reordering at f32 rounding), both with and without a
  ``max_range``;
- ``lookup_neighbors`` equal (integer arithmetic and a binary search);
- ``nearest_k_search`` / ``radius_search``: squared distances, the found
  masks and the in-radius counts equal (observed: the same f64 formula
  gives the same bits), the indices
  equal where the distances are distinct (``torch.topk`` promises no
  order among ties, ``lax.top_k`` puts the lower index first);
- ``sample_display_cloud`` from JAX's own normals within 1e-15 (f64,
  observed 4.4e-16; the same closed-form Cholesky);
- the align app on two small generated PCDs: every fitness it prints equals
  ``fitness_score`` called directly on the same clouds and pose.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud as jpc  # noqa: E402
from toyslam_tpu.core import se3 as jse3  # noqa: E402
from toyslam_tpu.registration import ndt as jndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.apps import align  # noqa: E402
from toyslam_tpu_torch.core import pcd_io  # noqa: E402
from toyslam_tpu_torch.core import pointcloud as tpc  # noqa: E402
from toyslam_tpu_torch.registration import ndt as tndt  # noqa: E402

POSE = np.array([0.3, -0.2, 0.1, 0.02, -0.01, 0.05])
FIT_RTOL64 = 5e-15
FIT_RTOL32 = 2e-6


def _scene(rng, n):
    m = n // 3
    floor = np.stack([rng.uniform(-10, 10, m), rng.uniform(-10, 10, m),
                      0.02 * rng.normal(size=m)], 1)
    wall = np.stack([rng.uniform(-10, 10, m), 5.0 + 0.02 * rng.normal(size=m),
                     rng.uniform(0, 4, m)], 1)
    cross = np.stack([-8.0 + 0.02 * rng.normal(size=m),
                      rng.uniform(-10, 5, m), rng.uniform(0, 4, m)], 1)
    return np.concatenate([floor, wall, cross], 0)


@pytest.fixture(scope="module")
def scene():
    """(target, source) clouds of both packages in f64, the JAX NDT map
    of the target in both, and the JAX transform."""
    rng = np.random.default_rng(11)
    tgt_np = _scene(rng, 1500)
    src_np = _scene(rng, 900)
    T = jse3.pose6_to_matrix(jnp.asarray(POSE, jnp.float64))
    jt = jpc.from_numpy(tgt_np, capacity=1600, dtype=jnp.float64)
    js = jpc.from_numpy(src_np, capacity=1024, dtype=jnp.float64)
    cfg = jndt.NDTConfig(resolution=1.0, map_capacity=1024,
                         grid_capacity=1 << 12)
    jmap = jax.jit(jndt.build_ndt_map, static_argnums=1)(jt, cfg)
    tmap = convert.ndt_map({k: np.asarray(v)
                            for k, v in jmap._asdict().items()}, "cpu")

    def port(c):
        return convert.point_cloud(np.asarray(c.xyzi), np.asarray(c.mask),
                                   device="cpu")

    return {"jt": jt, "js": js, "tt": port(jt), "ts": port(js),
            "jmap": jmap, "tmap": tmap, "T": np.array(T)}


@pytest.mark.parametrize("max_range", [np.inf, 0.8])
def test_fitness_score_f64(scene, max_range):
    fit = jax.jit(jndt.fitness_score)
    want = float(fit(scene["js"], scene["jt"], jnp.asarray(scene["T"]),
                     max_range))
    got = float(tndt.fitness_score(scene["ts"], scene["tt"],
                                   torch.from_numpy(scene["T"]), max_range))
    assert want > 0
    assert abs(got - want) <= FIT_RTOL64 * want


@pytest.mark.parametrize("max_range", [np.inf, 0.8])
def test_fitness_score_f32(scene, max_range):
    def f32(c):
        return c._replace(xyzi=c.xyzi.astype(jnp.float32))

    fit = jax.jit(jndt.fitness_score)
    T32 = scene["T"].astype(np.float32)
    want = float(fit(f32(scene["js"]), f32(scene["jt"]), jnp.asarray(T32),
                     max_range))
    got = float(tndt.fitness_score(
        scene["ts"]._replace(xyzi=scene["ts"].xyzi.float()),
        scene["tt"]._replace(xyzi=scene["tt"].xyzi.float()),
        torch.from_numpy(T32), max_range))
    assert abs(got - want) <= FIT_RTOL32 * want


@pytest.mark.parametrize("search", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_lookup_neighbors_equal(scene, search):
    rng = np.random.default_rng(5)
    q = np.concatenate([rng.uniform(-12, 12, (200, 3)),
                        np.asarray(scene["jt"].xyzi)[:100, :3]])
    offsets = jndt._OFFSETS[search]
    slot, found = jndt.lookup_neighbors(scene["jmap"], jnp.asarray(q), 1.0,
                                        offsets)
    tslot, tfound = tndt.lookup_neighbors(scene["tmap"], torch.from_numpy(q),
                                          1.0, offsets)
    assert np.array_equal(tfound.numpy(), np.asarray(found))
    assert tslot.dtype == torch.int32
    assert np.array_equal(tslot.numpy(), np.asarray(slot))
    assert tfound.any()


def _same_ranking(tidx, jidx, d2):
    """Indices equal wherever a distance differs from its neighbours in
    the ranking (ties may order either way)."""
    d2 = np.asarray(d2)
    distinct = np.ones(d2.shape, bool)
    tie = d2[:, 1:] == d2[:, :-1]
    distinct[:, 1:] &= ~tie
    distinct[:, :-1] &= ~tie
    assert np.array_equal(np.asarray(tidx)[distinct],
                          np.asarray(jidx)[distinct])


def _queries(scene):
    """Points of the target moved by up to 1 m, and a few far off."""
    rng = np.random.default_rng(7)
    near = np.asarray(scene["jt"].xyzi)[:300:5, :3]
    return np.concatenate([near + rng.uniform(-1, 1, near.shape),
                           rng.uniform(-30, 30, (4, 3))])


def test_nearest_k_search(scene):
    q = _queries(scene)
    # k above the valid voxel count exercises found = False.
    n_valid = int(np.asarray(scene["jmap"].valid).sum())
    for k in (8, n_valid + 5):
        idx, d2, found = jndt.nearest_k_search(scene["jmap"], jnp.asarray(q),
                                               k)
        tidx, td2, tfound = tndt.nearest_k_search(scene["tmap"],
                                                  torch.from_numpy(q), k)
        assert np.array_equal(tfound.numpy(), np.asarray(found))
        assert np.array_equal(td2.numpy(), np.asarray(d2))
        _same_ranking(tidx.numpy()[:, :min(k, n_valid)],
                      np.asarray(idx)[:, :min(k, n_valid)],
                      np.asarray(d2)[:, :min(k, n_valid)])


def test_radius_search(scene):
    q = _queries(scene)
    idx, d2, found, count = jndt.radius_search(scene["jmap"], jnp.asarray(q),
                                               4.0, 8)
    tidx, td2, tfound, tcount = tndt.radius_search(
        scene["tmap"], torch.from_numpy(q), 4.0, 8)
    assert np.array_equal(tcount.numpy(), np.asarray(count))
    assert tcount.dtype == torch.int32
    assert (tcount.numpy() > 8).any() and (tcount.numpy() < 8).any()
    assert np.array_equal(tfound.numpy(), np.asarray(found))
    assert np.array_equal(td2.numpy(), np.asarray(d2))
    f = np.asarray(found)
    _same_ranking(np.where(f, tidx.numpy(), -1), np.where(f, idx, -1),
                  np.where(f, d2, -1.0))


def test_sample_display_cloud_from_jax_normals(scene):
    key = jax.random.PRNGKey(3)
    pts, mask = jndt.sample_display_cloud(scene["jmap"], key, 10)
    V = scene["jmap"].valid.shape[0]
    z = np.array(jax.random.normal(key, (V, 10, 3), jnp.float64))
    tpts, tmask = tndt.display_cloud_from_normals(scene["tmap"],
                                                  torch.from_numpy(z))
    assert np.array_equal(tmask.numpy(), np.asarray(mask))
    m = np.asarray(mask)
    np.testing.assert_allclose(tpts.numpy()[m], np.asarray(pts)[m], rtol=0,
                               atol=1e-15)
    gen = torch.Generator().manual_seed(0)
    spts, smask = tndt.sample_display_cloud(scene["tmap"], gen, 10)
    assert spts.shape == (V * 10, 3) and torch.equal(smask, tmask)
    assert bool(torch.isfinite(spts[smask]).all())


def test_align_app_fitness_equals_direct_calls(tmp_path, capsys):
    """The app on the CPU on two small generated PCDs: five methods, each
    fitness equal to fitness_score on the app's clouds and pose."""
    rng = np.random.default_rng(2)
    tgt = _scene(rng, 1200).astype(np.float32)
    T = np.asarray(jse3.pose6_to_matrix(jnp.asarray(
        [0.1, -0.05, 0.02, 0.0, 0.0, 0.02], jnp.float64)))
    src = ((_scene(rng, 1200) - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    pcd_io.write_pcd(tmp_path / "t.pcd", tgt)
    pcd_io.write_pcd(tmp_path / "s.pcd", src)
    assert align.main([str(tmp_path / "t.pcd"), str(tmp_path / "s.pcd"),
                       "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [m["method"] for m in out["methods"]] == [
        "ICP", "GICP", "NDT (DIRECT7)", "NDT (DIRECT1)", "NDT (DIRECT27)"]
    clouds = [tpc.voxel_downsample(tpc.from_numpy(
        pcd_io.read_pcd(tmp_path / f), capacity=1200, device="cpu"),
        align.LEAF, 1200) for f in ("t.pcd", "s.pcd")]
    for m in out["methods"]:
        assert m["converged"], m["method"]
        direct = float(tndt.fitness_score(
            clouds[1], clouds[0], torch.tensor(m["transform"])))
        assert m["fitness"] == direct, m["method"]
    # ICP and GICP improve on the identity guess; NDT at 1 m has too few
    # voxels of 6 points in so small a cloud to be held to that (the
    # card's smoke run holds all five on the align-65k pair).
    for m in out["methods"][:2]:
        got = np.asarray(m["transform"])
        assert np.linalg.norm(got[:3, 3] - T[:3, 3]) < np.linalg.norm(
            T[:3, 3]), m["method"]
