"""The port's RAIM and its GNSS simulators against the JAX package on the
CPU: ``gnss/raim`` (batched, against JAX's ``vmap``), ``sim/gps``,
``sim/urban`` and the ``raim_demo`` and ``urban_demo`` apps.

The simulators draw from a ``torch.Generator`` where JAX draws from a
PRNG key, so their noise is held to its law over many draws, and every
deterministic leaf to JAX's on the same geometry: the satellites placed
from JAX's own azimuths and elevations, and the urban budget on the JAX
tests' buildings with an explicit receiver clock. f64 throughout. Bounds,
each about twice what was observed ("equal" where the two agreed to the
bit):

- RAIM over 6 epochs of 9 satellites (faulted, clean, one satellite
  masked) against ``vmap`` of JAX's: states within 3e-12 m (observed
  1.3e-12 on ~6.4e6 m), residuals 5e-14 m (observed 2.3e-14), test
  statistics 2.5e-13 (observed 1.1e-13), covariances 1.6e-12 (observed
  7.7e-13), HPL/VPL 5.5e-13 m (observed 2.7e-13), weights 4.5e-16
  (observed 2.2e-16), detections equal; ``wls_solve`` 3e-12 m (observed
  1.0e-12); ``fault_exclusion``'s choices equal, its statistic within
  5e-16 (observed 2.2e-16) and its best subsets as above; the covariance
  ellipse within 6e-13 (observed 3.0e-13) and 8e-15 rad (observed
  3.6e-15); the batch equal to epoch-by-epoch calls;
- ``sim/gps``: satellites placed from JAX's angles within 1.5e-8 m of
  JAX's (observed 7.5e-9 on ~2.6e7 m); over 2000 draws of 8 satellites,
  the pseudorange noise's mean within 4 standard errors of 0 and its
  standard deviation within 3 % of ``noise_std``, the angles inside their
  ranges, a forced fault exactly ``fault_magnitude`` on its satellite, a
  random one on each satellite at least 150 times;
- ``sim/urban`` on the JAX tests' buildings: classes, attenuations,
  reflections and their buildings equal (reflections' extra paths
  within 8e-9 m), C/N0 within 1.8e-13 dB-Hz (observed 8.5e-14), noise
  std within rtol 2e-14 (observed 9.1e-15; it spans ~0.1 m to ~1e3 m),
  FSPL 1.2e-13 dB (observed 5.7e-14), the other link-budget helpers 2e-14
  and 2e-15 (observed equal, 8.9e-16); a drive of 6 epochs with an
  explicit clock: satellites in ENU within 3e-8 m (observed 1.3e-8 on
  2.6e7 m), elevations 1.5e-15 rad (observed 6.7e-16), iono 6e-15 m and
  tropo 5e-14 m (observed 2.7e-15, 2.5e-14), pseudorange errors 8e-9 m
  (observed 3.7e-9), every other budget leaf as above, the NaN pattern
  of the pseudoranges equal; the pseudorange noise over 240 epochs
  standard normal once divided by its std (mean within 4 standard
  errors, std within 6 %); the clock walk's second differences within
  10 % of their law; the skyplot records equal to JAX's
  ``skyplot_records`` on the same leaves;
- the apps on the host: exit 0 and write their files.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import geodesy as jgeo  # noqa: E402
from toyslam_tpu.gnss import pipeline as jpipe  # noqa: E402
from toyslam_tpu.gnss import raim as jraim  # noqa: E402
from toyslam_tpu.sim import gps as jgps  # noqa: E402
from toyslam_tpu.sim import urban as jurban  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import geodesy as tgeo  # noqa: E402
from toyslam_tpu_torch.gnss import pipeline as tpipe  # noqa: E402
from toyslam_tpu_torch.gnss import raim as traim  # noqa: E402
from toyslam_tpu_torch.sim import gps as tgps  # noqa: E402
from toyslam_tpu_torch.sim import urban as turban  # noqa: E402

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _receiver():
    return jgeo.lla_to_ecef(jnp.asarray(0.3896), jnp.asarray(1.995),
                            jnp.asarray(50.0))


# ---------------------------------------------------------------- RAIM


@pytest.fixture(scope="module")
def raim_case():
    """6 epochs of 9 satellites from JAX's simulator: faults on satellite
    3 in the odd epochs, satellite 7 masked in epoch 4."""
    rec = _receiver()
    cfg = jgps.GpsSimConfig(n_sats=9, noise_std=1.0, fault_magnitude=80.0)
    sims = [jgps.simulate_constellation(jax.random.PRNGKey(k), rec, cfg,
                                        fault_index=3 if k % 2 else None)
            for k in range(6)]
    sat = np.stack([np.asarray(s["sat_pos"]) for s in sims])
    pr = np.stack([np.asarray(s["pseudoranges"]) for s in sims])
    valid = np.ones((6, 9), bool)
    valid[4, 7] = False
    init = np.concatenate([np.asarray(rec) + 100.0, [0.0]])
    return sat, pr, valid, init, np.asarray(rec)


def _raim_close(got, want):
    _close(got.state, want.state, 3e-12)
    _close(got.residuals, want.residuals, 5e-14)
    _close(got.test_statistic, want.test_statistic, 2.5e-13)
    _eq(got.fault_detected, want.fault_detected)
    _close(got.covariance, want.covariance, 1.6e-12)
    _close(got.hpl, want.hpl, 5.5e-13)
    _close(got.vpl, want.vpl, 5.5e-13)
    _close(got.weights, want.weights, 4.5e-16)


def test_raim_detect_matches_jax_vmap(raim_case):
    sat, pr, valid, init, rec = raim_case
    jargs = (jnp.asarray(sat), jnp.asarray(pr), jnp.asarray(valid))
    want = jax.jit(jax.vmap(jraim.raim_detect, in_axes=(0, 0, 0, None)))(
        *jargs, jnp.asarray(init))
    got = traim.raim_detect(_t(sat), _t(pr), _t(valid), _t(init))
    _raim_close(got, want)
    assert got.fault_detected.tolist() == [False, True] * 3
    assert float(np.linalg.norm(got.state[0, :3].numpy() - rec)) < 10.0
    # The batch equals epoch-by-epoch calls
    one = traim.raim_detect(_t(sat[4]), _t(pr[4]), _t(valid[4]), _t(init))
    _close(one.state, got.state[4], 0)
    _close(one.test_statistic, got.test_statistic[4], 0)
    ell = traim.covariance_ellipse(got)
    jell = jax.vmap(jraim.covariance_ellipse)(want)
    for k in ("cov_enu", "semi_major", "semi_minor", "sigma_up", "hpl",
              "vpl"):
        _close(ell[k], jell[k], 6e-13)
    _close(ell["orientation_rad"], jell["orientation_rad"], 8e-15)
    assert bool((ell["semi_major"] >= ell["semi_minor"]).all())
    state, G, w = traim.wls_solve(_t(sat), _t(pr), _t(valid), _t(init))
    jstate, jG, jw = jax.vmap(jraim.wls_solve, in_axes=(0, 0, 0, None))(
        *jargs, jnp.asarray(init))
    _close(state, jstate, 3e-12)
    _close(G, jG, 2e-16)
    for p in (0.5, 0.95, 1.0 - 1e-3, 1.0 - 1e-5, 0.7):
        assert traim.k_multiplier(p) == float(jraim.k_multiplier(p))


def test_fault_exclusion_matches_jax_vmap(raim_case):
    sat, pr, valid, init, rec = raim_case
    want = jax.jit(jax.vmap(jraim.fault_exclusion,
                            in_axes=(0, 0, 0, None)))(
        jnp.asarray(sat), jnp.asarray(pr), jnp.asarray(valid),
        jnp.asarray(init))
    got = traim.fault_exclusion(_t(sat), _t(pr), _t(valid), _t(init))
    _eq(got[0], want[0])
    _close(got[1], want[1], 5e-16)
    _raim_close(got[2], want[2])
    # The faulted epochs exclude satellite 3 and land within 5 m
    assert got[0][1::2].tolist() == [3, 3, 3]
    err = np.linalg.norm(got[2].state[1::2, :3].numpy() - rec, axis=1)
    assert err.max() < 5.0
    # A masked satellite is never a candidate
    assert int(got[0][4]) != 7


# ---------------------------------------------------------------- sim/gps


def test_gps_sim_geometry_matches_jax():
    rec = _receiver()
    cfg = jgps.GpsSimConfig(n_sats=9)
    for k in range(3):
        sim = jgps.simulate_constellation(jax.random.PRNGKey(k), rec, cfg)
        got = tgps.place_satellites(_t(rec), _t(sim["azimuths"]),
                                    _t(sim["elevations"]))
        _close(got, sim["sat_pos"], 1.5e-8)


def test_gps_sim_noise_and_faults():
    rec = _t(_receiver())
    cfg = tgps.GpsSimConfig(n_sats=8, noise_std=2.0, clock_bias=42.0)
    N = 2000

    def sim(fault_index):
        gen = torch.Generator().manual_seed(5)
        return tgps.simulate_constellation(gen, rec, cfg, fault_index,
                                           batch=(N,))

    clean, forced, rand = sim(None), sim(3), sim(-1)
    noise = (clean["pseudoranges"]
             - (clean["sat_pos"] - rec).norm(dim=-1) - 42.0).numpy()
    n = noise.size
    assert abs(noise.mean()) < 4 * 2.0 / math.sqrt(n)
    assert abs(noise.std() / 2.0 - 1.0) < 0.03
    az, el = clean["azimuths"].numpy(), clean["elevations"].numpy()
    assert az.min() >= 0 and az.max() < 2 * math.pi
    assert el.min() >= math.radians(15) and el.max() <= math.radians(80)
    assert abs(az.mean() - math.pi) < 4 * (2 * math.pi / math.sqrt(12 * n))
    d = (forced["pseudoranges"] - clean["pseudoranges"]).numpy()
    assert (d[:, 3] == 50.0).all() and (d[:, np.arange(8) != 3] == 0).all()
    assert (clean["fault_idx"] == -1).all()
    idx = rand["fault_idx"].numpy()
    assert np.bincount(idx, minlength=8).min() >= 150
    d = (rand["pseudoranges"] - clean["pseudoranges"]).numpy()
    np.testing.assert_array_equal(d, 50.0 * (np.arange(8) == idx[:, None]))


# ---------------------------------------------------------------- sim/urban


def _cities(pad=None):
    """The JAX urban tests' buildings: one north block, a podium and a
    south wall, the same with a slab, and the six-block canyon; with
    ``pad``, each padded to that many buildings with boxes under the
    ground (no ray or reflection reaches them), so one JAX jit serves
    all."""
    one = ([[-10.0, 10.0, 0.0]], [[10.0, 20.0, 30.0]], [30.0], [0.6])
    podium = ([[-20.0, 10.0, 0.0], [-20.0, -20.0, 0.0]],
              [[20.0, 20.0, 6.0], [20.0, -10.0, 40.0]], [30.0] * 2, [0.6] * 2)
    slab = ([[-20.0, 10.0, 0.0], [-20.0, -20.0, 0.0], [-20.0, -6.0, 0.0]],
            [[20.0, 20.0, 6.0], [20.0, -10.0, 40.0], [20.0, -4.0, 40.0]],
            [30.0] * 3, [0.6] * 3)
    mins, maxs = [], []
    for i in range(3):
        x0 = -45.0 + 30.0 * i
        mins += [[x0, 15.0, 0.0], [x0, -45.0, 0.0]]
        maxs += [[x0 + 28.0, 45.0, 45.0], [x0 + 28.0, -15.0, 45.0]]
    canyon = (mins, maxs, [40.0] * 6, [0.6] * 6)
    out = []
    for c in (one, podium, slab, canyon):
        c = [np.array(a, np.float64) for a in c]
        if pad is not None:
            n = pad - len(c[2])
            c = [np.concatenate([c[0], np.tile([[0.0, 0.0, -100.0]], (n, 1))]),
                 np.concatenate([c[1], np.tile([[1.0, 1.0, -90.0]], (n, 1))]),
                 np.concatenate([c[2], np.full(n, 30.0)]),
                 np.concatenate([c[3], np.full(n, 0.6)])]
        out.append((jurban.Buildings(*(jnp.asarray(a) for a in c)),
                    turban.Buildings(*(_t(a) for a in c))))
    return out


def _budget_close(got, want):
    for k in ("blocked", "multipath", "usable"):
        _eq(getattr(got, k), getattr(want, k))
    _close(got.cn0, want.cn0, 1.8e-13)
    _close(got.pseudorange_error, want.pseudorange_error, 8e-9)
    # the noise std spans ~0.1 m (LOS) to ~1e3 m (through buildings)
    np.testing.assert_allclose(got.noise_std.numpy(),
                               np.asarray(want.noise_std), rtol=2e-14)


def test_urban_budget_matches_jax():
    rng = np.random.default_rng(3)
    # Receivers in the street, satellites all around at 5 km - 22000 km
    T, S = 5, 16
    rec = np.stack([rng.uniform(-20, 20, T), rng.uniform(-5, 5, T),
                    np.full(T, 1.5)], -1)
    az = rng.uniform(0, 2 * np.pi, (T, S))
    el = rng.uniform(0.02, 1.5, (T, S))
    dist = np.where(rng.uniform(size=(T, S)) < 0.5, 5000.0, 2.2e7)
    sat = rec[:, None] + dist[..., None] * np.stack(
        [np.cos(el) * np.sin(az), np.cos(el) * np.cos(az), np.sin(el)], -1)
    sat[0, 0] = [0.0, 5000.0, 900.0]  # the JAX tests' NLOS satellite
    el[0, 0] = np.arctan2(900.0, 5000.0 - rec[0, 1])
    def stages(r, s, e, c):
        return (jurban.signal_budget(r, s, e, c),
                jurban._face_reflections(r, s, c),
                jurban.classify_signals_attenuation(r, s, c))

    jstages = jax.jit(jax.vmap(stages, in_axes=(0, 0, 0, None)))
    n_mp = 0
    for jcity, tcity in _cities(pad=6):
        want, refl, classes = jstages(jnp.asarray(rec), jnp.asarray(sat),
                                      jnp.asarray(el), jcity)
        got = turban.signal_budget(_t(rec), _t(sat), _t(el), tcity)
        _budget_close(got, want)
        n_mp += int(got.multipath.sum())
        for a, b in zip(turban._face_reflections(_t(rec), _t(sat), tcity),
                        refl):
            _close(a, b, 8e-9)
        for a, b in zip(turban.classify_signals_attenuation(
                _t(rec), _t(sat), tcity), classes):
            _close(a, b, 0)
        blocked, n = turban.classify_signals(_t(rec), _t(sat), tcity)
        _eq(blocked, want.blocked)
    assert n_mp > 0  # the cases reach the reflection search
    d = rng.uniform(1e3, 3e7, 32)
    _close(turban.free_space_path_loss_db(_t(d)),
           jurban.free_space_path_loss_db(jnp.asarray(d)), 1.2e-13)
    _close(turban.cn0_from_elevation(_t(el[0]), _t(d[:S])),
           jurban.cn0_from_elevation(jnp.asarray(el[0]), jnp.asarray(d[:S])),
           2e-14)
    _close(turban.pseudorange_std_from_cn0(_t(d[:S] * 1e-6)),
           jurban.pseudorange_std_from_cn0(jnp.asarray(d[:S] * 1e-6)), 2e-15)
    o = rng.normal(0, 5, (64, 3))
    v = rng.normal(0, 1, (64, 3))
    v[:8, 0] = 0.0  # axis-parallel rays
    args = (o, v, np.array([-2.0, -2.0, 0.0]), np.array([2.0, 2.0, 3.0]),
            rng.uniform(1, 20, 64))
    _eq(turban.ray_aabb_intersect(*(_t(a) for a in args)),
        jurban.ray_aabb_intersect(*(jnp.asarray(a) for a in args)))


@pytest.fixture(scope="module")
def canyon_drive():
    """The JAX canyon test's drive (6 epochs), both packages, with an
    explicit clock; the atmosphere on."""
    jcity, tcity = _cities()[3]
    ref_lla = np.array([np.deg2rad(22.3), np.deg2rad(114.17), 50.0])
    T = 6
    times = 1000.0 + np.arange(T) * 2.0
    track = np.stack([np.linspace(-10.0, 10.0, T), np.zeros(T),
                      np.full(T, 1.5)], -1)
    clock = np.full(T, 30.0)
    want = jurban.simulate_urban_epochs(
        jax.random.PRNGKey(0), jnp.asarray(track), jnp.asarray(times),
        jpipe.synthetic_constellation(24, toe=1000.0), jcity,
        jnp.asarray(ref_lla), clock_bias_m=jnp.asarray(clock))
    got = turban.simulate_urban_epochs(
        torch.Generator().manual_seed(0), _t(track), _t(times),
        tpipe.synthetic_constellation(24, toe=1000.0, device=CPU), tcity,
        _t(ref_lla), clock_bias_m=_t(clock))
    return got, want, (track, times, clock, ref_lla, tcity)


def test_urban_epochs_match_jax(canyon_drive):
    got, want = canyon_drive[:2]
    _close(got["sat_enu"], want["sat_enu"], 3e-8)
    _close(got["elevations"], want["elevations"], 1.5e-15)
    _close(got["iono_m"], want["iono_m"], 6e-15)
    _close(got["tropo_m"], want["tropo_m"], 5e-14)
    _close(got["clock_bias_m"], want["clock_bias_m"], 0)
    _budget_close(got["budget"], want["budget"])
    _eq(torch.isnan(got["pseudoranges"]),
        np.isnan(np.asarray(want["pseudoranges"])))
    usable = got["budget"].usable.numpy()
    assert usable.sum(1).min() >= 4 and got["budget"].multipath.any()
    # The skyplot stream of the same leaves equals JAX's
    recs = turban.skyplot_records(got, times=np.arange(6) * 1.0)
    leaves = {k: v.numpy() if torch.is_tensor(v) else v
              for k, v in got.items()}
    assert json.dumps(recs) == json.dumps(jurban.skyplot_records(
        leaves, times=np.arange(6) * 1.0))
    az = np.arctan2(leaves["sat_enu"][0, :, 0], leaves["sat_enu"][0, :, 1])
    use = usable[0]
    assert turban.dop_from_az_el(az[use], leaves["elevations"][0][use]) == \
        jurban.dop_from_az_el(az[use], leaves["elevations"][0][use])


def test_urban_noise_atmosphere_and_clock_walk(canyon_drive):
    track, times, clock, ref_lla, tcity = canyon_drive[2]
    eph = tpipe.synthetic_constellation(24, toe=1000.0, device=CPU)
    T = 240
    times_l = 1000.0 + torch.arange(T, dtype=torch.float64)
    track_l = torch.stack([torch.linspace(-20.0, 20.0, T),
                           torch.zeros(T), torch.full((T,), 1.5)],
                          -1).double()
    cb = torch.full((T,), 30.0, dtype=torch.float64)

    def run(**kw):
        return turban.simulate_urban_epochs(
            torch.Generator().manual_seed(7), track_l, times_l, eph, tcity,
            _t(ref_lla), clock_bias_m=cb, **kw)

    atm, clean = run(), run(apply_atmosphere=False)
    b = atm["budget"]
    true = (atm["sat_enu"] - track_l[:, None]).norm(dim=-1)
    z = ((atm["pseudoranges"] - true - 30.0 - b.pseudorange_error)
         / b.noise_std)[b.usable].numpy()
    assert z.size > 1500
    assert abs(z.mean()) < 4 / math.sqrt(z.size)
    assert abs(z.std() - 1.0) < 0.06
    # The same draws with the atmosphere off: the difference is its budget
    both = (b.usable & clean["budget"].usable).numpy()
    d = (atm["pseudoranges"] - clean["pseudoranges"]).numpy()
    np.testing.assert_allclose(d[both], (atm["iono_m"] + atm["tropo_m"])
                               .numpy()[both], rtol=1e-6)
    assert (atm["tropo_m"].numpy()[b.usable.numpy()] >= 2.3 - 1e-9).all()
    assert bool((clean["iono_m"] == 0).all())
    # The clock walk (``:976-990``): smooth, drifting, its law
    bias = turban.receiver_clock_walk(torch.Generator().manual_seed(1), 1000,
                                      0.1, bias0=10.0, drift0=1e-7,
                                      device=CPU).numpy()
    d1 = np.diff(bias)
    assert np.all(np.abs(d1) < 5.0) and abs(bias[-1] - bias[0]) > 0.1
    law = tgeo.SPEED_OF_LIGHT * 0.1 * 1e-9 * math.sqrt(0.1)
    assert abs(np.diff(d1).std() / law - 1.0) < 0.1
    drawn = turban.simulate_urban_epochs(
        torch.Generator().manual_seed(7), track_l[:5], times_l[:5], eph,
        tcity, _t(ref_lla))
    assert drawn["clock_bias_m"].shape == (5,)
    city = turban.make_city(torch.Generator().manual_seed(2), 8,
                            device=CPU)
    assert city.min_xyz.shape == (8, 3)
    size = (city.max_xyz - city.min_xyz).numpy()
    assert (size[:, :2] >= 8.0).all() and (size[:, :2] <= 20.0).all()
    height = city.max_xyz[:, 2]
    assert (height >= 10).all() and (height <= 40).all()
    assert torch.equal(convert.buildings(city._asdict(), device=CPU).max_xyz,
                       city.max_xyz)


# ---------------------------------------------------------------- the apps


def test_raim_and_urban_demos_cpu(tmp_path):
    from toyslam_tpu_torch.apps import raim_demo, urban_demo

    assert raim_demo.main([str(tmp_path / "raim"), "--device", "cpu"]) == 0
    for name in ("raim.csv", "ellipse.jsonl"):
        assert (tmp_path / "raim" / name).stat().st_size > 0
    rows = (tmp_path / "raim" / "raim.csv").read_text().splitlines()
    assert len(rows) == 121
    assert urban_demo.main([str(tmp_path / "urban"), "--device", "cpu"]) == 0
    for name in ("skyplot.jsonl", "pseudoranges.csv"):
        assert (tmp_path / "urban" / name).stat().st_size > 0
    if not torch.cuda.is_available():  # no fallback to the host
        for app in (raim_demo, urban_demo):
            with pytest.raises(RuntimeError):
                app.main([str(tmp_path / "x")])
