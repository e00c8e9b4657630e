"""The port's GNSS positioning against the JAX package on the CPU:
``core/geodesy``, ``gnss/{ephemeris, atmosphere, spp, pipeline, local}``,
the ``convert`` and ``config`` helpers of their objects, and the
``gnss_demo`` app against the JAX app.

Inputs from numpy with fixed seeds and the JAX package's own epoch-log
generator (``tests/test_gnss_pipeline._make_epoch_log``: 12 epochs x 24
satellites, 1.5 m noise). f64 throughout unless stated. Bounds, each about
twice what was observed (a bound kept from the JAX package's own tests
says so; "equal" where the two agreed to the bit):

- geodesy: ECEF within 2e-9 m (observed 9.3e-10, one ulp of ~6.4e6 m),
  latitude and longitude within 2e-15 rad (observed equal), height 2e-9
  m (observed 9.3e-10), rotations 2e-15 (observed equal), ENU vectors
  3e-13 m (observed 1.1e-13), ENU -> ECEF 2e-9 m (observed equal), ENU
  velocities 3e-14 m/s (observed 1.4e-14), flat earth 1e-12 m (observed
  equal) and its inverse within 1.5e-14 (observed 7.1e-15); GPS time
  equal; the round trips within JAX's test bounds (1e-9 rad, 1e-4 m,
  1e-6 m);
- ephemeris over [12, 24] transmit times with every harmonic and rate
  term set: positions within 3e-8 m (observed 1.2e-8 on 2.7e7 m),
  velocities 3e-12 m/s (observed 1.4e-12), clocks 4e-21 s and 1e-27 s/s
  (observed equal), validity (the age gate) equal; and the port alone
  against physics (``tests/test_gnss.py::
  test_kepler_and_ephemeris_physical``'s radius, speed and
  finite-difference velocity): the simulators and the solvers share this
  function, so parity alone would inherit its errors;
- atmosphere: Klobuchar within 4e-15 m (observed 1.8e-15), troposphere
  8e-15 m (observed 3.6e-15);
- SPP: positions within 4e-9 m (observed equal), clock 1.5e-11 m
  (observed 7.3e-12), covariance 4.5e-14 (observed 2.2e-14), DOPs
  1.5e-14 (observed 7.6e-15); a masked channel's junk or NaN
  pseudorange kept out of the solve, as in JAX; velocities within 5e-11
  m/s (observed 2.4e-11), their covariance 2e-13 (observed 8.5e-14),
  elevations and azimuths 1.5e-15 rad (observed 7.8e-16), weights 1e-16
  (observed 4.2e-17);
- ``run_epochs`` (a masked PRN, a low-CN0 satellite, Klobuchar on):
  states within 2.5e-8 m (observed 1.2e-8), covariances 5e-14 (observed
  2.2e-14), DOPs 1.1e-14 (observed 5.3e-15), velocities 4e-12 m/s
  (observed 1.9e-12), ENU and heights 3e-8 m (observed 1.4e-8), the
  records 4e-13 (observed 1.8e-13), masks and validity equal; the store
  (update, replace, lookup of absent and out-of-range PRNs, the age gate)
  equal leaf for leaf;
- ``prep_epochs``: every f32 leaf within one f32 ulp of its largest
  magnitude (observed equal), masks equal;
- ``solve_epochs_local`` in f32 against JAX's f32: positions and ENU
  within 1.6e-5 m (observed 8.1e-6), clock 1.6e-5 m (observed 7.6e-6),
  velocities 3.5e-6 m/s (observed 1.7e-6), DOPs 7.5e-6 (observed
  3.6e-6), covariance 2.5e-5 (observed 1.1e-5); against the port's f64
  ``run_epochs`` within the JAX package's own bounds
  (``tests/test_gnss_local.py``: 0.1 m, 0.1 m, 0.05 m/s, rtol 2e-2, ENU
  0.1 m; observed 8.5e-5 m), also from an anchor 2 km off; a NaN channel
  on a masked satellite within that test's 1e-3 m / 1e-4 m/s of the
  clean run (observed equal), and within 1.2e-5 m of JAX's f32 on the
  same inputs (observed 5.7e-6);
- ``gnss_demo --device cpu`` against the JAX app's over 12 epochs: every
  CSV number within 2 units of its last printed digit (observed equal
  but for one last-digit flip), the skyplot's satellites equal and its
  DOPs within 1e-12 (observed 1e-15).
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_gnss_pipeline import _make_epoch_log  # noqa: E402
from toyslam_tpu import config as jconfig  # noqa: E402
from toyslam_tpu.core import geodesy as jgeo  # noqa: E402
from toyslam_tpu.gnss import atmosphere as jatm  # noqa: E402
from toyslam_tpu.gnss import ephemeris as jeph  # noqa: E402
from toyslam_tpu.gnss import local as jlocal  # noqa: E402
from toyslam_tpu.gnss import pipeline as jpipe  # noqa: E402
from toyslam_tpu.gnss import raim as jraim  # noqa: E402
from toyslam_tpu.gnss import spp as jspp  # noqa: E402
from toyslam_tpu.sim import gps as jgps  # noqa: E402
from toyslam_tpu.sim import urban as jurban  # noqa: E402
from toyslam_tpu_torch import config as tconfig  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.core import geodesy as tgeo  # noqa: E402
from toyslam_tpu_torch.gnss import atmosphere as tatm  # noqa: E402
from toyslam_tpu_torch.gnss import ephemeris as teph  # noqa: E402
from toyslam_tpu_torch.gnss import local as tlocal  # noqa: E402
from toyslam_tpu_torch.gnss import pipeline as tpipe  # noqa: E402
from toyslam_tpu_torch.gnss import spp as tspp  # noqa: E402

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
KLOBUCHAR = (np.array([1.1176e-8, 7.4506e-9, -5.9605e-8, -5.9605e-8]),
             np.array([90112.0, 0.0, -196610.0, -65536.0]))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _store(jstore):
    return convert.ephemeris_store(jstore._asdict(), device=CPU)


@pytest.fixture(scope="module")
def log():
    """The JAX test's epoch log in both packages' types."""
    (store, iono, tows, prns, prs, dops, cn0s, valids, ref, gt_pos,
     gt_vel) = _make_epoch_log(n_epochs=12)
    jargs = (tows, prns, prs, dops, cn0s, valids, ref)
    return {"jstore": store, "jiono": iono, "jargs": jargs,
            "store": _store(store),
            "iono": convert.iono_params(iono._asdict(), device=CPU),
            "args": tuple(_t(a) for a in jargs), "gt_pos": gt_pos}


CFG = dict(apply_iono_correction=False)


# ---------------------------------------------------------------- geodesy


def test_geodesy_matches_jax():
    rng = np.random.default_rng(0)
    lla = np.stack([rng.uniform(-1.4, 1.4, 64), rng.uniform(-3.1, 3.1, 64),
                    rng.uniform(-100, 4000, 64)], -1)
    jl = [jnp.asarray(lla[:, k]) for k in range(3)]
    tl = [_t(lla[:, k]) for k in range(3)]
    ecef = tgeo.lla_to_ecef(*tl)
    _close(ecef, jgeo.lla_to_ecef(*jl), 2e-9)
    back = tgeo.ecef_to_lla(ecef)
    _close(back[:, :2], jgeo.ecef_to_lla(jnp.asarray(ecef.numpy()))[:, :2],
           2e-15)
    _close(back[:, 2], jgeo.ecef_to_lla(jnp.asarray(ecef.numpy()))[:, 2],
           2e-9)
    # JAX's own round-trip bounds (tests/test_gnss.py)
    _close(back[:, :2], lla[:, :2], 1e-9)
    _close(back[:, 2], lla[:, 2], 1e-4)
    _close(tgeo.ecef_to_enu_rotation(tl[0], tl[1]),
           jgeo.ecef_to_enu_rotation(jl[0], jl[1]), 2e-15)
    ref = tgeo.lla_to_ecef(_t(0.39), _t(2.0), _t(50.0))
    pts = ref + _t(rng.uniform(-1000, 1000, (16, 3)))
    jref, jpts = jnp.asarray(ref.numpy()), jnp.asarray(pts.numpy())
    enu = tgeo.ecef_to_enu(pts, ref)
    _close(enu, jgeo.ecef_to_enu(jpts, jref), 3e-13)
    _close(tgeo.enu_to_ecef(enu, ref), pts, 1e-6)
    _close(tgeo.enu_to_ecef(enu, ref),
           jgeo.enu_to_ecef(jnp.asarray(enu.numpy()), jref), 2e-9)
    vel = _t(rng.normal(0, 100, (16, 3)))
    _close(tgeo.ecef_velocity_to_enu(vel, tl[0][:16], tl[1][:16]),
           jgeo.ecef_velocity_to_enu(jnp.asarray(vel.numpy()),
                                     jl[0][:16], jl[1][:16]), 3e-14)
    fe = tgeo.flat_earth_gps_to_enu(tl[0] * 1e-3, tl[1] * 1e-3, tl[2],
                                    0.001, 0.002, 5.0)
    _close(fe, jgeo.flat_earth_gps_to_enu(jl[0] * 1e-3, jl[1] * 1e-3, jl[2],
                                          0.001, 0.002, 5.0), 1e-12)
    for got, want in zip(tgeo.flat_earth_enu_to_gps(fe, 0.001, 0.002, 5.0),
                         (tl[0] * 1e-3, tl[1] * 1e-3, tl[2])):
        _close(got, want, 1.5e-14)


def test_gps_time_matches_jax():
    week, tow = 2300, 345600.0
    for t in (tow, tow * 1e6, 0.5, 604799.0):
        assert float(tgeo.gps_to_unix_time(week, t)) == float(
            jgeo.gps_to_unix_time(week, t))
    t_sec = float(tgeo.gps_to_unix_time(week, tow))
    assert abs(t_sec - float(tgeo.gps_to_unix_time(week, tow * 1e6))) < 1e-6
    w, s = tgeo.unix_to_gps_time(t_sec)
    assert int(w) == week and abs(float(s) - tow) < 1e-6
    jw, js = jgeo.unix_to_gps_time(t_sec)
    assert float(w) == float(jw) and float(s) == float(js)
    dt = _t(np.array([-400000.0, -10.0, 0.0, 302401.0, 500000.0]))
    _eq(tgeo.adjust_time_within_week(dt, 0.0),
        jgeo.adjust_time_within_week(jnp.asarray(dt.numpy()), 0.0))


# ---------------------------------------------------------------- ephemeris


def _perturbed_constellation():
    """The synthetic constellation with every harmonic and rate term set
    (both packages' types)."""
    rng = np.random.default_rng(1)
    eph = jpipe.synthetic_constellation(24, toe=1000.0)
    small = {k: rng.normal(0, s, 24) for k, s in (
        ("cus", 1e-6), ("cuc", 1e-6), ("crs", 50.0), ("crc", 50.0),
        ("cis", 1e-7), ("cic", 1e-7), ("delta_n", 4e-9), ("omg_dot", 1e-9),
        ("i_dot", 1e-10), ("af2", 1e-19), ("omega", 1.0))}
    small["omg_dot"] = small["omg_dot"] - 8e-9
    jeph_ = eph._replace(**{k: jnp.asarray(v) for k, v in small.items()},
                         e=eph.e + jnp.asarray(rng.uniform(0, 0.01, 24)))
    return jeph_, convert.ephemeris(jeph_._asdict(), device=CPU)


def test_ephemeris_matches_jax():
    jeph_, teph_ = _perturbed_constellation()
    # transmit times over a log, some past the age gate (7200 s)
    times = 1000.0 + np.linspace(-9000, 9000, 12)[:, None] + np.arange(24)
    got = teph.sat_pos_vel_clock(teph_, _t(times))
    want = jeph.sat_pos_vel_clock(jeph_, jnp.asarray(times))
    _close(got["pos"], want["pos"], 3e-8)
    _close(got["vel"], want["vel"], 3e-12)
    _close(got["clock_bias"], want["clock_bias"], 4e-21)
    _close(got["clock_drift"], want["clock_drift"], 1e-27)
    _eq(got["valid"], want["valid"])
    assert 0 < int(got["valid"].sum()) < got["valid"].numel()
    forced = teph.sat_pos_vel_clock(teph_, _t(times), force_use_ephemeris=True)
    _eq(forced["valid"], jeph.sat_pos_vel_clock(
        jeph_, jnp.asarray(times), force_use_ephemeris=True)["valid"])
    _close(teph.solve_kepler(_t([0.3, 2.0]), _t([0.01, 0.2])),
           jeph.solve_kepler(jnp.asarray([0.3, 2.0]),
                             jnp.asarray([0.01, 0.2])), 1e-15)


def test_ephemeris_physical():
    """The port alone against physics: the checks of the JAX package's
    ``test_kepler_and_ephemeris_physical`` (the simulators and the solvers
    share this function, so parity alone would inherit its errors)."""
    S, a = 4, 26560e3

    def full(v):
        return torch.full((S,), v, dtype=torch.float64)

    zeros = full(0.0)
    eph = teph.GpsEphemeris(
        sat=torch.arange(S, dtype=torch.int32), toe_sec=zeros,
        toc_sec=zeros, sqrta=full(math.sqrt(a)), e=full(0.01),
        m0=_t([0.0, 1.0, 2.0, 3.0]), delta_n=zeros, omega=zeros,
        omg=_t([0.0, 1.5, 3.0, 4.5]), omg_dot=zeros, i0=full(0.96),
        i_dot=zeros, cus=zeros, cuc=zeros, crs=zeros, crc=zeros, cis=zeros,
        cic=zeros, af0=full(1e-5), af1=zeros, af2=zeros, tgd=zeros,
        valid=torch.ones(S, dtype=torch.bool))
    out = teph.sat_pos_vel_clock(eph, 100.0)
    np.testing.assert_allclose(out["pos"].norm(dim=1).numpy(), a, rtol=0.02)
    v = out["vel"].norm(dim=1).numpy()
    # ECEF speed: the orbital speed moved by Earth's rotation (< ~2 km/s)
    assert np.all(np.abs(v - math.sqrt(tgeo.MU_GPS / a)) < 2500.0)
    assert bool(out["valid"].all())
    out2 = teph.sat_pos_vel_clock(eph, 100.5)
    v_fd = (out2["pos"] - out["pos"]).numpy() / 0.5
    np.testing.assert_allclose(out["vel"].numpy(), v_fd, atol=2.0)


# ---------------------------------------------------------------- atmosphere


def test_atmosphere_matches_jax():
    rng = np.random.default_rng(2)
    el = rng.uniform(-0.2, 1.5, 64)
    az = rng.uniform(-math.pi, math.pi, 64)
    t = rng.uniform(0, 86400 * 3, 64)
    for alpha, beta, valid in ((*KLOBUCHAR, True), (np.zeros(4), np.zeros(4),
                                                    True),
                               (*KLOBUCHAR, False)):
        tp = tatm.IonoParams(_t(alpha), _t(beta), valid)
        jp = jatm.IonoParams(jnp.asarray(alpha), jnp.asarray(beta), valid)
        got = tatm.klobuchar_delay(tp, _t(t), 0.39, 2.0, _t(el), _t(az))
        _close(got, jatm.klobuchar_delay(jp, jnp.asarray(t), 0.39, 2.0,
                                         jnp.asarray(el), jnp.asarray(az)),
               4e-15)
    _close(tatm.simple_troposphere_delay(_t(el)),
           jatm.simple_troposphere_delay(jnp.asarray(el)), 8e-15)


# ---------------------------------------------------------------- spp


def _spp_obs(seed, n_sats=10, junk=None):
    """The JAX test's noisy constellation with atmosphere, as (JAX obs,
    port obs, receiver)."""
    rng = np.random.default_rng(seed)
    rec_lla = (0.3896, 1.9950, 50.0)
    rec = np.asarray(jgeo.lla_to_ecef(*(jnp.asarray(v) for v in rec_lla)))
    az = rng.uniform(0, 2 * np.pi, n_sats)
    el = rng.uniform(np.deg2rad(15), np.deg2rad(85), n_sats)
    R = np.asarray(jgeo.ecef_to_enu_rotation(jnp.asarray(rec_lla[0]),
                                             jnp.asarray(rec_lla[1])))
    los = np.stack([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az),
                    np.sin(el)], -1) @ R
    sat_pos = rec + los * 2.2e7
    iono = 2.0 + rng.uniform(0, 3, n_sats)
    trop = 2.3 / np.sin(el)
    clk = rng.normal(0, 1e-6, n_sats)
    sagnac = -jgeo.EARTH_ROTATION_RATE * (
        rec[0] * sat_pos[:, 1] - rec[1] * sat_pos[:, 0]) / jgeo.SPEED_OF_LIGHT
    pr = (np.linalg.norm(sat_pos - rec, axis=1) + 123.4 + sagnac + iono
          + trop - (clk + 5e-9) * jgeo.SPEED_OF_LIGHT
          + rng.normal(0, 1.0, n_sats))
    valid = np.ones(n_sats, bool)
    if junk is not None:
        valid[3] = False
        pr[3] = junk
    fields = dict(pos=sat_pos, pseudorange=pr,
                  clock_bias=clk, iono_delay=iono,
                  trop_delay=trop, tgd=np.full(n_sats, 5e-9),
                  weight=np.asarray(jspp.elevation_weight(jnp.asarray(el))),
                  valid=valid)
    return (jspp.SatelliteObs(**{k: jnp.asarray(v) for k, v in
                                 fields.items()}),
            tspp.SatelliteObs(**{k: _t(v) for k, v in fields.items()}), rec)


def _spp_close(got, want):
    _close(got.state[:3], want.state[:3], 4e-9)
    _close(got.state[3], want.state[3], 1.5e-11)
    _close(got.covariance, want.covariance, 4.5e-14)
    for k in ("gdop", "pdop", "hdop", "vdop", "tdop"):
        _close(getattr(got, k), getattr(want, k), 1.5e-14)
    assert int(got.num_sats) == int(want.num_sats)
    assert bool(got.valid) == bool(want.valid)


def test_spp_matches_jax():
    jobs, tobs, rec = _spp_obs(12)
    init = np.concatenate([rec + 5000.0, [0.0]])
    want = jspp.solve_spp(jobs, jnp.asarray(init))
    got = tspp.solve_spp(tobs, _t(init))
    _spp_close(got, want)
    assert np.linalg.norm(got.state[:3].numpy() - rec) < 5.0
    _close(tspp.predicted_pseudorange(got.state, tobs),
           jspp.predicted_pseudorange(want.state, jobs), 4e-8)
    # A batch of the same epoch twice gives each its own solve
    batch = tspp.SatelliteObs(*(torch.stack([x, x]) for x in tobs))
    both = tspp.solve_spp(batch, _t(np.stack([init, init])))
    _close(both.state[1], got.state, 1e-9)
    # A masked channel's junk or NaN pseudorange stays out of the solve, as
    # in JAX (whose compiled products with the mask are selects)
    for junk in (1e9, np.nan):
        jobs, tobs, rec = _spp_obs(12, junk=junk)
        want = jspp.solve_spp(jobs, jnp.asarray(init))
        got = tspp.solve_spp(tobs, _t(init))
        _spp_close(got, want)
        assert np.linalg.norm(got.state[:3].numpy() - rec) < 5.0


def test_velocity_and_weights_match_jax():
    rng = np.random.default_rng(13)
    jobs, tobs, rec = _spp_obs(13, n_sats=8)
    sat_vel = rng.normal(0, 1000, (8, 3))
    fields = dict(sat_pos=np.asarray(jobs.pos), sat_vel=sat_vel,
                  sat_clock_drift=rng.normal(0, 1e-9, 8),
                  range_rate=rng.normal(0, 500, 8),
                  weight=rng.uniform(0.1, 1.0, 8),
                  valid=np.arange(8) != 5)
    want = jspp.solve_velocity(jspp.DopplerObs(
        **{k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(rec))
    got = tspp.solve_velocity(tspp.DopplerObs(
        **{k: _t(v) for k, v in fields.items()}), _t(rec))
    for k in ("vel_ecef", "clock_drift", "vel_enu", "speed"):
        _close(getattr(got, k), getattr(want, k), 5e-11)
    _close(got.covariance, want.covariance, 2e-13)
    assert bool(got.valid) == bool(want.valid)
    prev = _t(np.asarray(want.vel_ecef) + 25.0)
    assert bool(tspp.validate_velocity(got, prev)) == bool(
        jspp.validate_velocity(want, jnp.asarray(prev.numpy())))
    el, az = tspp.elevation_azimuth(tobs.pos, _t(rec))
    jel, jaz = jspp.elevation_azimuth(jobs.pos, jnp.asarray(rec))
    _close(el, jel, 1.5e-15)
    _close(az, jaz, 1.5e-15)
    cn0 = rng.uniform(-5, 60, 8)
    ura = rng.uniform(-1, 4, 8)
    _close(tspp.elevation_weight(el, _t(cn0), 20.0, _t(ura)),
           jspp.elevation_weight(jel, jnp.asarray(cn0), 20.0,
                                 jnp.asarray(ura)), 1e-16)


# ---------------------------------------------------------------- pipeline


def test_ephemeris_store_matches_jax():
    jeph_ = jpipe.synthetic_constellation(4, toe=1000.0)
    teph_ = tpipe.synthetic_constellation(4, toe=1000.0, device=CPU)
    for k in teph.GpsEphemeris._fields:
        _close(getattr(teph_, k), getattr(jeph_, k), 0)
    jstore, tstore = jpipe.store_init(), tpipe.store_init(device=CPU)
    for k in range(4):
        jstore = jstore.update(jax.tree_util.tree_map(lambda x: x[k], jeph_))
        tstore = tstore.update(teph.GpsEphemeris(*(x[k] for x in teph_)))
    # Replace PRN 2 with a fresher toe
    jnew = jax.tree_util.tree_map(lambda x: x[1], jeph_)._replace(
        toe_sec=jnp.asarray(5000.0), toc_sec=jnp.asarray(5000.0))
    jstore = jstore.update(jnew)
    tstore = tstore.update(convert.ephemeris(jnew._asdict(), device=CPU))
    for k in teph.GpsEphemeris._fields:
        _close(getattr(tstore.eph, k), getattr(jstore.eph, k), 0)
    prn = np.array([1, 2, 3, 31, 0, -1, 40, 4])
    got = tstore.lookup(_t(prn).int())
    want = jstore.lookup(jnp.asarray(prn, jnp.int32))
    for k in teph.GpsEphemeris._fields:
        _close(getattr(got, k), getattr(want, k), 0)
    _close(got.toe_sec[:3], [1000.0, 5000.0, 1000.0], 0)
    assert not got.valid[3:7].any()  # never stored, or out of range
    # The age gate: a transmit time 3 h past toe invalidates the satellite
    t_tx = _t([1500.0, 1500.0, 1500.0 + 3 * 3600] + [1500.0] * 5)
    _eq(teph.sat_pos_vel_clock(got, t_tx)["valid"],
        jeph.sat_pos_vel_clock(want, jnp.asarray(t_tx.numpy()))["valid"])
    assert bool(teph.sat_pos_vel_clock(got, t_tx)["valid"][0])
    assert not bool(teph.sat_pos_vel_clock(got, t_tx)["valid"][2])


def test_run_epochs_matches_jax(log):
    """A masked PRN, a low-CN0 satellite and Klobuchar on."""
    jargs, args = list(log["jargs"]), list(log["args"])
    valids = np.asarray(jargs[5]).copy()
    valids[:, 7] = False
    cn0 = np.asarray(jargs[4]).copy()
    cn0[:, 2] = 5.0  # below min_cn0 10
    jargs[4], jargs[5] = jnp.asarray(cn0), jnp.asarray(valids)
    args[4], args[5] = _t(cn0), _t(valids)
    jiono = jatm.IonoParams(*(jnp.asarray(a) for a in KLOBUCHAR))
    tiono = tatm.IonoParams(*(_t(a) for a in KLOBUCHAR))
    cfg = jpipe.EpochConfig()
    want = jax.jit(lambda *a: jpipe.run_epochs(*a, config=cfg))(
        log["jstore"], jiono, *jargs)
    got = tpipe.run_epochs(log["store"], tiono, *args,
                           config=convert.epoch_config(cfg._asdict()))
    p, jp = got.position, want.position
    _close(p.state, jp.state, 2.5e-8)
    _close(p.covariance, jp.covariance, 5e-14)
    for k in ("gdop", "pdop", "hdop", "vdop", "tdop"):
        _close(getattr(p, k), getattr(jp, k), 1.1e-14)
    _eq(p.num_sats, jp.num_sats)
    _eq(p.valid, jp.valid)
    v, jv = got.velocity, want.velocity
    for k in ("vel_ecef", "clock_drift", "vel_enu", "speed"):
        _close(getattr(v, k), getattr(jv, k), 4e-12)
    _eq(v.valid, jv.valid)
    _close(got.enu, want.enu, 3e-8)
    _close(got.lla[:, :2], want.lla[:, :2], 3e-15)
    _close(got.lla[:, 2], want.lla[:, 2], 3e-8)
    for k in ("elevation", "azimuth", "iono_delay", "trop_delay"):
        _close(getattr(got.record, k), getattr(want.record, k), 4e-13)
    _eq(got.record.used, want.record.used)
    used = got.record.used.numpy()
    assert not used[:, 7].any() and not used[:, 2].any()
    assert bool(p.valid.all()) and bool(v.valid.all())


# ---------------------------------------------------------------- local


@pytest.fixture(scope="module")
def local_runs(log):
    """prep_epochs and solve_epochs_local in both packages (f32), and the
    port's f64 run_epochs, on the JAX test's log."""
    jcfg, tcfg = jpipe.EpochConfig(**CFG), tpipe.EpochConfig(**CFG)
    jep = jlocal.prep_epochs(log["jstore"], log["jiono"], *log["jargs"],
                             config=jcfg)
    tep = tlocal.prep_epochs(log["store"], log["iono"], *log["args"],
                             config=tcfg)
    jsol = jax.jit(jlocal.solve_epochs_local, static_argnums=1)(jep, jcfg)
    tsol = tlocal.solve_epochs_local(tep, tcfg)
    t64 = tpipe.run_epochs(log["store"], log["iono"], *log["args"],
                           config=tcfg)
    return jep, tep, jsol, tsol, t64


def test_prep_epochs_matches_jax(local_runs):
    jep, tep = local_runs[:2]
    for k in tlocal.LocalEpochs._fields:
        got, want = getattr(tep, k), np.asarray(getattr(jep, k))
        assert got.dtype == getattr(torch, str(want.dtype)), k
        if got.dtype == torch.bool or got.dtype == torch.int32:
            _eq(got, want)
        else:
            scale = max(float(np.abs(want).max()), 1e-30)
            _close(got, want, scale * 2.0 ** -23)


def test_solve_local_f32_matches_jax_f32(local_runs):
    jsol, tsol = local_runs[2:4]
    _close(tsol.delta, jsol.delta, 1.6e-5)
    _close(tsol.enu, jsol.enu, 1.6e-5)
    _close(tsol.clock_bias, jsol.clock_bias, 1.6e-5)
    _close(tsol.vel_ecef, jsol.vel_ecef, 3.5e-6)
    _close(tsol.vel_enu, jsol.vel_enu, 3.5e-6)
    _close(tsol.clock_drift, jsol.clock_drift, 3.5e-6)
    for k in ("gdop", "pdop", "hdop", "vdop", "tdop"):
        _close(getattr(tsol, k), getattr(jsol, k), 7.5e-6)
    _close(tsol.covariance, jsol.covariance, 2.5e-5)
    for k in ("num_sats", "valid", "vel_valid"):
        _eq(getattr(tsol, k), getattr(jsol, k))


def _within_f64(sol32, sols64, anchor):
    """The JAX package's own f32-vs-f64 bounds (tests/test_gnss_local.py)."""
    est = anchor + sol32.delta.double().numpy()
    st = sols64.position.state.numpy()
    assert np.linalg.norm(est - st[:, :3], axis=1).max() < 0.1
    assert np.abs(sol32.clock_bias.double().numpy() - st[:, 3]).max() < 0.1
    assert np.linalg.norm(sol32.vel_ecef.double().numpy()
                          - sols64.velocity.vel_ecef.numpy(), axis=1).max() \
        < 0.05
    for k in ("pdop", "hdop"):
        np.testing.assert_allclose(getattr(sol32, k).numpy(),
                                   getattr(sols64.position, k).numpy(),
                                   rtol=2e-2)
    _eq(sol32.num_sats, sols64.position.num_sats.numpy())
    return est


def test_local_f32_within_f64_pipeline(local_runs, log):
    tsol, t64 = local_runs[3:]
    assert bool(tsol.valid.all()) and bool(tsol.vel_valid.all())
    est = _within_f64(tsol, t64, log["args"][6].numpy())
    err = np.linalg.norm(est - log["gt_pos"], axis=1)
    assert np.sqrt(np.mean(err ** 2)) < 5.0
    _close(tsol.enu, t64.enu, 0.1)


def test_local_km_scale_anchor(log):
    """A 2 km anchor error (a cold start's approximate position) keeps the
    f32 solve within the bounds: the second-order range term's truncation
    is < 2 mm at 10 km."""
    anchor = log["args"][6] + _t([1500.0, -1200.0, 400.0])
    args = (*log["args"][:6], anchor)
    cfg = tpipe.EpochConfig(**CFG)
    sol = tlocal.solve_epochs_local(tlocal.prep_epochs(
        log["store"], log["iono"], *args, config=cfg), cfg)
    t64 = tpipe.run_epochs(log["store"], log["iono"], *args, config=cfg)
    _within_f64(sol, t64, anchor.numpy())
    assert float(sol.delta.norm(dim=1).min()) > 1000.0


def test_local_nan_on_masked_satellite(log, local_runs):
    """A NaN pseudorange/Doppler on a masked satellite (a PRN absent from
    an epoch) must not poison the f32 solve (JAX's
    ``test_local_nan_on_masked_satellite_does_not_poison_epoch``)."""
    cfg = tpipe.EpochConfig(**CFG)
    tows, prns, prs, dops, cn0s, valids, ref = log["args"]
    drop = valids.clone()
    drop[:, 5] = False
    clean = tlocal.solve_epochs_local(tlocal.prep_epochs(
        log["store"], log["iono"], tows, prns, prs, dops, cn0s, drop, ref,
        config=cfg), cfg)
    prs_nan, dops_nan = prs.clone(), dops.clone()
    prs_nan[:, 5] = math.nan
    dops_nan[:, 5] = math.nan
    ep = tlocal.prep_epochs(log["store"], log["iono"], tows, prns, prs_nan,
                            dops_nan, cn0s, drop, ref, config=cfg)
    for k in ("los", "y", "inv_rho0", "sag_coef", "sat_vel", "z0", "weight"):
        assert bool(torch.isfinite(getattr(ep, k)).all()), k
    sol = tlocal.solve_epochs_local(ep, cfg)
    assert bool(sol.valid.all())
    _close(sol.delta, clean.delta, 1e-3)
    _close(sol.vel_ecef, clean.vel_ecef, 1e-4)
    assert bool(torch.isfinite(sol.gdop).all())
    est = ref.numpy() + sol.delta.double().numpy()
    assert np.linalg.norm(est - log["gt_pos"], axis=1).max() < 10.0
    # and as JAX's on the same inputs
    jcfg = jpipe.EpochConfig(**CFG)
    jargs = [jnp.asarray(a.numpy()) for a in (tows, prns, prs_nan, dops_nan,
                                              cn0s, drop, ref)]
    jsol = jax.jit(jlocal.solve_epochs_local, static_argnums=1)(
        jlocal.prep_epochs(log["jstore"], log["jiono"], *jargs, config=jcfg),
        jcfg)
    _close(sol.delta, jsol.delta, 1.2e-5)


# ---------------------------------------------------------------- convert


def test_gnss_configs_and_convert():
    for kind, conv in (("raim", convert.raim_config),
                       ("gnss_epoch", convert.epoch_config),
                       ("gps_sim", convert.gps_sim_config)):
        assert conv(jconfig.default(kind)._asdict()) == \
            tconfig.SECTIONS[kind]()
    example = REPO / "configs" / "example.json"
    loaded = jconfig.load(example)
    for kind, conv in (("raim", convert.raim_config),
                       ("gnss_epoch", convert.epoch_config),
                       ("gps_sim", convert.gps_sim_config)):
        assert tconfig.load_section(example, kind) == conv(
            loaded[kind]._asdict())
    cfg = jpipe.EpochConfig(cut_off_degree=15.0, use_doppler=False)
    assert convert.epoch_config(cfg._asdict()) == tpipe.EpochConfig(
        cut_off_degree=15.0, use_doppler=False)
    assert convert.raim_config(jraim.RaimConfig(max_iterations=3)._asdict()
                               ).max_iterations == 3
    assert convert.gps_sim_config(jgps.GpsSimConfig(n_sats=11)._asdict()
                                  ).n_sats == 11
    iono = convert.iono_params(jatm.IonoParams(
        *(jnp.asarray(a) for a in KLOBUCHAR), valid=False), device=CPU)
    _close(iono.alpha, KLOBUCHAR[0], 0)
    assert iono.valid is False
    jeph_ = jpipe.synthetic_constellation(5, toe=30.0)
    teph_ = convert.ephemeris(jeph_, device=CPU)
    assert teph_.sat.dtype == torch.int32 and teph_.valid.dtype == torch.bool
    for k in teph.GpsEphemeris._fields:
        _close(getattr(teph_, k), getattr(jeph_, k), 0)
    store = convert.ephemeris_store(jpipe.store_init(), device=CPU)
    assert store.eph.toe_sec.shape == (32,) and not bool(store.eph.valid.any())
    city = jurban.Buildings(jnp.zeros((2, 3)), jnp.ones((2, 3)),
                            jnp.full((2,), 30.0), jnp.full((2,), 0.5))
    tcity = convert.buildings(city._asdict(), device=CPU)
    _close(tcity.max_xyz, np.ones((2, 3)), 0)
    _close(tcity.reflectivity, [0.5, 0.5], 0)


# ---------------------------------------------------------------- the app


def _rows(path, skip=1):
    return np.genfromtxt(path, delimiter=",", skip_header=skip)


def test_gnss_demo_cpu_matches_jax_app(tmp_path):
    from toyslam_tpu_torch.apps import gnss_demo

    port, ref = tmp_path / "port", tmp_path / "jax"
    assert gnss_demo.main([str(port), "--epochs", "12", "--device",
                           "cpu"]) == 0
    out = subprocess.run([sys.executable, str(REPO / "apps" / "gnss_demo.py"),
                          str(ref), "--epochs", "12"], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    # gnss_position.csv: 4-9 printed decimals; 2 units of the last digit
    a, b = _rows(port / "gnss_position.csv"), _rows(ref / "gnss_position.csv")
    assert a.shape == b.shape == (12, 18)
    digits = np.array([6, 0, 6, 9, 9, 4, 4, 4, 4, 4, 4, 4, 4, 0, 3, 3, 3, 3])
    assert (np.abs(a - b) <= 2 * 10.0 ** -digits).all()
    a = _rows(port / "solution.csv")[:, :11]
    b = _rows(ref / "solution.csv")[:, :11]
    assert (np.abs(a - b) <= 2e-5).all()
    for la, lb in zip((port / "skyplot.jsonl").read_text().splitlines(),
                      (ref / "skyplot.jsonl").read_text().splitlines()):
        ra, rb = json.loads(la), json.loads(lb)
        assert ra["sats"] == rb["sats"] and ra["tow"] == rb["tow"]
        assert abs(ra["pdop"] - rb["pdop"]) < 1e-12
        assert abs(ra["hdop"] - rb["hdop"]) < 1e-12
    # Bag replay is tests/test_torch_rosbag.py's; here only that a missing
    # bag raises and --write-bag writes the 12 epochs.
    with pytest.raises(FileNotFoundError):
        gnss_demo.main([str(port), "--bag", str(tmp_path / "x.bag"),
                        "--device", "cpu"])
    assert gnss_demo.main([str(port), "--epochs", "12", "--device", "cpu",
                           "--write-bag", str(tmp_path / "w.bag")]) == 0
    from toyslam_tpu_torch.runtime import rosbag
    assert len(rosbag.pack_bag_gnss_meas(tmp_path / "w.bag")) == 12
    if not torch.cuda.is_available():  # no fallback to the host
        with pytest.raises(RuntimeError):
            gnss_demo.main([str(port)])
        with pytest.raises((RuntimeError, AssertionError)):
            tpipe.store_init()
