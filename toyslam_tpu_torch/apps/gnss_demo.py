"""End-to-end GNSS SPP: the ``gnssSpp`` node's story as a CLI (port of
``apps/gnss_demo.py``).

    python -m toyslam_tpu_torch.apps.gnss_demo out_dir [--epochs 60] \\
        [--noise 1.5] [--n-sats 24] [--seed 0] [--speed 1.5] \\
        [--device cuda|cpu] [--write-bag file.bag] [--bag file.bag]

Simulates the Kepler constellation over a receiver moving from the Hong
Kong reference point, in float64 on the run's device, and feeds the
pseudorange and Doppler epochs through the ephemeris store, the masks and
weights, the WLS position and the Doppler velocity. Writes

    out_dir/gnss_position.csv   the reference's CSV columns
                                (``gnssSpp.cpp:1086-1108``)
    out_dir/skyplot.jsonl       per-epoch per-satellite az/el/CN0/used,
                                the headless skyplot/DOP stream
                                (``RangingRC.cpp:1917-3497``)
    out_dir/solution.csv        the EvaPos ENU trajectory

and prints the ENU ATE against the truth. ``--device cuda`` (the default)
runs ``gnss/local``: ``prep_epochs`` linearises the log about the
reference point in float64 on the card, then ``solve_epochs_local``
solves it in float32 there; it prints the solve's epochs/s beside the
card. ``--device cpu`` runs the float64 ECEF pipeline
(``gnss/pipeline.run_epochs``) on the host, as the JAX app's
``--device cpu`` does. The draws come from numpy's ``default_rng(seed)``
in the JAX app's order, so ``--device cpu`` writes the JAX app's numbers
up to float64 rounding.

``--write-bag`` also writes the simulated epochs as
``gnss_comm/GnssMeasMsg`` records on /ublox_driver/range_meas (lz4
chunks), the reference's ``rawMeasCallback`` input (``gnssSpp.cpp:827``):
one L1 observation a satellite above the horizon, Doppler in Hz as the
receiver reports it, -rr / lambda. ``--bag`` replays such a bag in place
of the simulated measurements (the constellation still comes from
``--n-sats``; range rate = -Doppler * lambda, ``gnssSpp.cpp:1207``) and,
knowing no truth, prints the spread of the ENU track instead of the ATE.
The pseudoranges go through the bag as float64, so a replay solves to the
simulation's positions.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

REF_LAT_DEG, REF_LON_DEG, REF_ALT_M = 22.3, 114.17, 50.0
CLOCK_BIAS_M = 42.0
GPS_WEEK = 2300
L1_HZ = 1575.42e6
MEAS_TOPIC = "/ublox_driver/range_meas"


def write_meas_bag(path, channels):
    """The epochs of ``channels`` (tows [E], prn, pr, rr, cn0, valid [E,
    S]) as GnssMeasMsg records, lz4 chunks; the JAX app's bag for the
    same numbers."""
    from toyslam_tpu_torch.core.geodesy import SPEED_OF_LIGHT
    from toyslam_tpu_torch.runtime import rosbag

    tows, prn, pr, rr, cn0, valid = (x.cpu().numpy() for x in channels)
    wavelength = SPEED_OF_LIGHT / L1_HZ
    records = []
    for e in range(len(tows)):
        use = valid[e]
        records.append((
            MEAS_TOPIC, "gnss_comm/GnssMeasMsg", float(tows[e]),
            rosbag.encode_gnss_meas(
                GPS_WEEK, float(tows[e]), prn[e][use].astype(np.int32),
                pr[e][use], cn0[e][use], -rr[e][use] / wavelength,
                stamp_sec=float(tows[e]))))
    rosbag.write_mixed_bag(path, records, compression="lz4")


def read_meas_bag(path, n_sats, dev):
    """A GnssMeasMsg bag -> the ``run_epochs`` channels on ``dev`` (PRNs
    1..n_sats; a satellite outside them is dropped) and the median count
    of satellites an epoch."""
    from toyslam_tpu_torch.core.geodesy import SPEED_OF_LIGHT
    from toyslam_tpu_torch.runtime import rosbag

    epochs = rosbag.pack_bag_gnss_meas(path, topic=MEAS_TOPIC)
    if not epochs:
        raise SystemExit("bag contains no GnssMeasMsg epochs")
    E, S = len(epochs), n_sats
    wavelength = SPEED_OF_LIGHT / L1_HZ
    pr, rr, cn0 = (np.zeros((E, S)) for _ in range(3))
    valid = np.zeros((E, S), bool)
    for e, ep in enumerate(epochs):
        for i, prn_i in enumerate(ep["sats"]):
            s = int(prn_i) - 1
            if not 0 <= s < S:
                continue  # a PRN outside the loaded constellation
            pr[e, s] = ep["psr"][i]
            rr[e, s] = -ep["dopp"][i] * wavelength
            cn0[e, s] = ep["cn0"][i]
            valid[e, s] = np.isfinite(ep["psr"][i])

    def t(a):
        return torch.from_numpy(a).to(dev)

    tows = t(np.asarray([ep["tow"] for ep in epochs], np.float64))
    prn = torch.arange(1, S + 1, dtype=torch.int32, device=dev).expand(E, S)
    channels = (tows, prn, t(pr), t(rr), t(cn0), t(valid))
    return channels, int(np.median([len(ep["sats"]) for ep in epochs]))


def simulate(n_epochs, n_sats, noise, seed, speed, dev):
    """The JAX app's log, every epoch at once in float64 on ``dev``:
    transmit-time-consistent pseudoranges and range rates of the receiver
    moving at (speed, 0.4, 0) m/s ENU. Returns (store, iono, the
    ``run_epochs`` channels, ref ECEF [3], R_enu [3, 3], truth [E, 3])."""
    from toyslam_tpu_torch.core.geodesy import (SPEED_OF_LIGHT,
                                                ecef_to_enu_rotation,
                                                lla_to_ecef)
    from toyslam_tpu_torch.gnss import atmosphere, pipeline, spp
    from toyslam_tpu_torch.gnss.ephemeris import (GpsEphemeris,
                                                  sat_pos_vel_clock)
    from toyslam_tpu_torch.gnss.local import W_C

    f64 = torch.float64
    E, S = n_epochs, n_sats
    rng = np.random.default_rng(seed)
    # The JAX app draws each epoch's pseudorange, range-rate and CN0 noise
    # in turn
    draws = torch.from_numpy(rng.standard_normal((E, 3, S))).to(dev)

    lat0 = torch.tensor(math.radians(REF_LAT_DEG), dtype=f64, device=dev)
    lon0 = torch.tensor(math.radians(REF_LON_DEG), dtype=f64, device=dev)
    ref = lla_to_ecef(lat0, lon0, torch.tensor(REF_ALT_M, dtype=f64,
                                               device=dev))
    R = ecef_to_enu_rotation(lat0, lon0)
    v_ecef = spp.mat_vec(R.T, torch.tensor([speed, 0.4, 0.0], dtype=f64,
                                           device=dev))
    eph = pipeline.synthetic_constellation(S, toe=1000.0, device=dev)
    store = pipeline.store_init(device=dev)
    for k in range(S):
        store = store.update(GpsEphemeris(*(x[k] for x in eph)))
    iono = atmosphere.IonoParams(alpha=torch.zeros(4, dtype=f64, device=dev),
                                 beta=torch.zeros(4, dtype=f64, device=dev))

    steps = torch.arange(E, dtype=f64, device=dev)
    tows = 1000.0 + steps
    pos = ref + v_ecef * steps[:, None]
    sat = sat_pos_vel_clock(eph, tows[:, None].expand(E, S))
    r0 = torch.linalg.norm(sat["pos"] - pos[:, None], dim=-1)
    for _ in range(2):
        sat = sat_pos_vel_clock(eph, tows[:, None] - r0 / SPEED_OF_LIGHT)
        r0 = torch.linalg.norm(sat["pos"] - pos[:, None], dim=-1)
    el, _ = spp.elevation_azimuth(sat["pos"], pos)
    zeros = torch.zeros_like(r0)
    truth = spp.SatelliteObs(
        pos=sat["pos"], pseudorange=r0, clock_bias=sat["clock_bias"],
        iono_delay=zeros, trop_delay=atmosphere.simple_troposphere_delay(el),
        tgd=eph.tgd.expand(E, S), weight=zeros + 1.0,
        valid=torch.ones_like(el, dtype=torch.bool))
    state = torch.cat([pos, torch.full((E, 1), CLOCK_BIAS_M, dtype=f64,
                                       device=dev)], -1)
    pr = spp.predicted_pseudorange(state, truth) + noise * draws[:, 0]
    los = (sat["pos"] - pos[:, None]) / r0[..., None]
    vel = sat["vel"]
    rr = ((los * v_ecef).sum(-1) - (los * vel).sum(-1)
          - W_C * (vel[..., 0] * pos[:, None, 1]
                   - vel[..., 1] * pos[:, None, 0])
          + sat["clock_drift"] * SPEED_OF_LIGHT + 0.05 * draws[:, 1])
    cn0 = (45.0 + 5.0 * draws[:, 2]).clamp(25, 55)
    prn = torch.arange(1, S + 1, dtype=torch.int32, device=dev).expand(E, S)
    channels = (tows, prn, pr, rr, cn0, el > 0)
    return store, iono, channels, ref, R, pos


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--noise", type=float, default=1.5)
    ap.add_argument("--n-sats", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speed", type=float, default=1.5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: float64 prep and the float32 local-frame "
                         "solve on the card; cpu: the float64 ECEF "
                         "pipeline on the host")
    ap.add_argument("--bag", default=None,
                    help="replay gnss_comm/GnssMeasMsg epochs from a ROS1 "
                         "bag instead of simulating measurements (the "
                         "constellation still comes from --n-sats)")
    ap.add_argument("--write-bag", default=None,
                    help="also write the simulated epochs as GnssMeasMsg "
                         "records (lz4 chunks)")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.core.geodesy import ecef_to_lla
    from toyslam_tpu_torch.gnss import local, pipeline
    from toyslam_tpu_torch.utils import evalio

    dev = device(args.device)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    E, S = args.epochs, args.n_sats
    store, iono, channels, ref, R, gt = simulate(
        E, S, args.noise, args.seed, args.speed, dev)
    if args.write_bag:
        write_meas_bag(args.write_bag, channels)
        print(f"wrote GNSS measurement bag: {args.write_bag}")
    if args.bag:
        channels, med = read_meas_bag(args.bag, S, dev)
        E, gt = channels[0].shape[0], None
        print(f"bag: {E} GnssMeas epochs, median sats/epoch {med}")
    cfg = pipeline.EpochConfig(apply_iono_correction=False)

    synchronize(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        ep = local.prep_epochs(store, iono, *channels, ref, config=cfg)
        sol = local.solve_epochs_local(ep, cfg)
        synchronize(dev)
        sec = time.perf_counter() - t0
        print(f"float64 prep and float32 local-frame solve on the card: {E} "
              f"epochs in {sec:.3f} s ({E / sec:.1f} epochs/s; "
              f"{card_line(dev)})")
        est_xyz = ref + sol.delta.double()
        est = torch.cat([est_xyz, sol.clock_bias.double()[:, None]], -1)
        enu, lla = sol.enu.double(), ecef_to_lla(est_xyz)
        num_sats = sol.num_sats
        dops = (sol.pdop, sol.hdop, sol.vdop, sol.tdop)
        rec = (ep.prn, ep.elevation, ep.azimuth, ep.cn0, ep.valid)
        vel_enu, vel_valid = sol.vel_enu.double(), sol.vel_valid
    else:
        sols = pipeline.run_epochs(store, iono, *channels, ref, config=cfg)
        sec = time.perf_counter() - t0
        print(f"float64 ECEF pipeline on the host: {E} epochs in {sec:.3f} s "
              f"({E / sec:.1f} epochs/s)")
        p, r = sols.position, sols.record
        est, enu, lla, num_sats = p.state, sols.enu, sols.lla, p.num_sats
        dops = (p.pdop, p.hdop, p.vdop, p.tdop)
        rec = (r.prn, r.elevation, r.azimuth, r.cn0, r.used)
        vel_enu, vel_valid = sols.velocity.vel_enu, sols.velocity.valid

    def host(x):
        return x.cpu().numpy()

    tows = host(channels[0])
    est, enu, lla, num_sats = host(est), host(enu), host(lla), host(num_sats)
    pdop, hdop, vdop, tdop = (host(d) for d in dops)
    rec_prn, rec_el, rec_az, rec_cn0, rec_used = (host(x) for x in rec)
    vel_enu, vel_valid = host(vel_enu), host(vel_valid)

    # gnss_position.csv: the reference's columns (:1086-1108)
    with open(out / "gnss_position.csv", "w") as f:
        f.write("time,gps_week,gps_tow,latitude,longitude,altitude,"
                "ecef_x,ecef_y,ecef_z,enu_e,enu_n,enu_u,clock_bias,"
                "num_satellites,pdop,hdop,vdop,tdop\n")
        for e in range(E):
            f.write(
                f"{tows[e]:.6f},{GPS_WEEK},{tows[e]:.6f},"
                f"{np.rad2deg(lla[e, 0]):.9f},{np.rad2deg(lla[e, 1]):.9f},"
                f"{lla[e, 2]:.4f},"
                f"{est[e, 0]:.4f},{est[e, 1]:.4f},{est[e, 2]:.4f},"
                f"{enu[e, 0]:.4f},{enu[e, 1]:.4f},{enu[e, 2]:.4f},"
                f"{est[e, 3]:.4f},{int(num_sats[e])},"
                f"{pdop[e]:.3f},{hdop[e]:.3f},{vdop[e]:.3f},{tdop[e]:.3f}\n")

    # skyplot.jsonl: the per-epoch per-satellite stream
    with open(out / "skyplot.jsonl", "w") as f:
        for e in range(E):
            f.write(json.dumps({
                "tow": float(tows[e]), "pdop": float(pdop[e]),
                "hdop": float(hdop[e]),
                "sats": [{"prn": int(rec_prn[e, s]),
                          "el_deg": round(float(np.rad2deg(rec_el[e, s])), 2),
                          "az_deg": round(float(np.rad2deg(rec_az[e, s])), 2),
                          "cn0": round(float(rec_cn0[e, s]), 1),
                          "used": bool(rec_used[e, s])}
                         for s in range(S)]}) + "\n")

    # The EvaPos ENU solution
    T = np.tile(np.eye(4), (E, 1, 1))
    T[:, :3, 3] = enu
    evalio.write_evapos_csv(out / "solution.csv",
                            evalio.from_transforms(tows, T, vel=vel_enu))

    print(f"epochs: {E}, used sats (median): {int(np.median(num_sats))}")
    if gt is not None:
        err = np.linalg.norm(enu - host((gt - ref) @ R.T), axis=1)
        print(f"ENU ATE vs ground truth: {float(np.sqrt(np.mean(err**2))):.3f}"
              f" m (pseudorange noise {args.noise} m)")
    else:
        spread = np.linalg.norm(enu - enu.mean(0), axis=1)
        print(f"bag replay: ENU spread RMS "
              f"{float(np.sqrt(np.mean(spread**2))):.3f} m")
    print(f"velocity valid: {int(vel_valid.sum())}/{E}")
    print(f"wrote {out}/gnss_position.csv, skyplot.jsonl, solution.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
