"""End-to-end urban-canyon GNSS: the ``RangingRC`` + ``user_teleop``
story as a CLI (port of ``apps/urban_demo.py``).

    python -m toyslam_tpu_torch.apps.urban_demo out_dir [--epochs 40] \\
        [--n-sats 24] [--length 60] [--speed 3] [--seed 0] \\
        [--raim/--no-raim] [--device cuda|cpu]

The reference pair drives a teleop trajectory through a simulated street
canyon and, each epoch, Kepler-propagates the constellation, ray-traces
every signal against the buildings (LOS / blocked / single-bounce
multipath, the bounce segments checked for blockage), applies the
pseudorange error budget (iono, tropo, the multipath extra path, C/N0
receiver noise, the receiver clock walk) and publishes pseudoranges, a
coloured skyplot and DOP text to RViz (``RangingRC.cpp:135-266,379-542,
996-1131,1447-1916,1917-3583``). Here a circuit drive
(``sim/trajectories.circuit``) down a two-row street canyon runs all
epochs at once (``sim/urban.simulate_urban_epochs``) and writes

    out_dir/skyplot.jsonl       per-epoch per-satellite az/el/CN0/class
                                (los|blocked|multipath) and the DOPs of
                                the usable geometry
    out_dir/pseudoranges.csv    the observation stream (pr, cn0, class,
                                iono, tropo, usable)

With ``--raim`` (the default) it reseeds the generator and simulates the
same drive without the atmosphere (clean geometric ranges: the same
geometry and classes), then runs RAIM on every epoch that holds a large
NLOS multipath error and at least 6 usable satellites, in one batched
``raim_detect``, and prints how many it flags and the run's time beside
the card. Exits 0 iff RAIM flags at least half of them (the bound of the
JAX package's ``test_canyon_drive_raim_flags_ray_traced_nlos``).

Float64 on the card by default, on the host with ``--device cpu``. The
draws come from a CPU ``torch.Generator`` seeded with ``--seed`` (the
same draws on the card and the host), not the JAX app's.
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


def street_canyon(n_blocks: int, half_len: float, device):
    """Two rows of buildings flanking a street along x (the reference's
    canyon world): street |y| < 15, walls 30 m deep and 45 m tall, 4 m
    cross streets between blocks."""
    from toyslam_tpu_torch.sim import urban

    mins, maxs = [], []
    pitch = 2.0 * half_len / n_blocks
    for i in range(n_blocks):
        x0 = -half_len + pitch * i
        x1 = x0 + pitch - 4.0
        mins += [[x0, 15.0, 0.0], [x0, -45.0, 0.0]]
        maxs += [[x1, 45.0, 45.0], [x1, -15.0, 45.0]]
    B = len(mins)

    def t(v):
        return torch.tensor(v, dtype=torch.float64, device=device)

    return urban.Buildings(min_xyz=t(mins), max_xyz=t(maxs),
                           attenuation_db=t([40.0] * B),
                           reflectivity=t([0.6] * B))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--n-sats", type=int, default=24)
    ap.add_argument("--length", type=float, default=60.0,
                    help="circuit length (m); the street spans "
                         "+-(length/2 + 10)")
    ap.add_argument("--speed", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--raim", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.core.geodesy import (ecef_to_enu_rotation,
                                                lla_to_ecef)
    from toyslam_tpu_torch.gnss import pipeline, raim
    from toyslam_tpu_torch.sim import trajectories, urban

    dev = device(args.device)
    f64 = torch.float64
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    T, S = args.epochs, args.n_sats
    city = street_canyon(3, args.length / 2 + 10, dev)
    ref_lla = torch.tensor([math.radians(22.3), math.radians(114.17), 50.0],
                           dtype=f64, device=dev)
    eph = pipeline.synthetic_constellation(S, toe=1000.0, device=dev)
    times = 1000.0 + torch.arange(T, dtype=f64, device=dev)
    # The circuit down the street: width 14 keeps |y| <= 7 (street |y| < 15)
    track = trajectories.circuit(times - times[0], length=args.length,
                                 width=14.0, speed=args.speed, z=1.5)["pos"]
    gen = torch.Generator()  # CPU: the same draws on the card and the host

    synchronize(dev)
    t0 = time.perf_counter()
    sim = urban.simulate_urban_epochs(gen.manual_seed(args.seed), track,
                                      times, eph, city, ref_lla)
    synchronize(dev)
    sim_s = time.perf_counter() - t0

    # skyplot.jsonl, with each epoch's DOPs
    recs = urban.skyplot_records(sim, times=times)
    with open(out / "skyplot.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")

    # pseudoranges.csv: the observation stream
    budget = sim["budget"]
    prs, cn0, usable, multipath, blocked, iono, tropo = (
        x.cpu().numpy() for x in (sim["pseudoranges"], budget.cn0,
                                  budget.usable, budget.multipath,
                                  budget.blocked, sim["iono_m"],
                                  sim["tropo_m"]))
    times_np = times.cpu().numpy()
    with open(out / "pseudoranges.csv", "w") as f:
        f.write("t,sat,pseudorange,cn0,class,usable,iono_m,tropo_m\n")
        for e in range(T):
            for s in range(S):
                cls = ("multipath" if multipath[e, s]
                       else "blocked" if blocked[e, s] else "los")
                f.write(f"{float(times_np[e]):.1f},{s + 1},"
                        f"{prs[e, s]:.3f},{cn0[e, s]:.1f},{cls},"
                        f"{int(usable[e, s])},{iono[e, s]:.3f},"
                        f"{tropo[e, s]:.3f}\n")

    n_los = int((usable & ~multipath).sum())
    n_mp = int((usable & multipath).sum())
    n_blk = int(blocked.sum())
    pdops = [r["pdop"] for r in recs if np.isfinite(r["pdop"])]
    print(f"epochs: {T}, sats: {S}, buildings: {city.min_xyz.shape[0]}; "
          f"ray-traced drive in {sim_s:.3f} s ({card_line(dev)})")
    print(f"signals: {n_los} LOS, {n_mp} NLOS-multipath, {n_blk} blocked; "
          f"median PDOP {np.median(pdops):.2f}")
    print(f"wrote {out}/skyplot.jsonl, pseudoranges.csv")
    if not args.raim:
        return 0

    # RAIM on the clean rerun: the same seed gives the same ray tracing, so
    # the NLOS extra path is the only systematic error
    synchronize(dev)
    t0 = time.perf_counter()
    sim_c = urban.simulate_urban_epochs(
        gen.manual_seed(args.seed), track, times, eph, city, ref_lla,
        clock_bias_m=torch.full((T,), 30.0, dtype=f64, device=dev),
        apply_atmosphere=False)
    b = sim_c["budget"]
    nlos_big = b.usable & b.multipath & (b.pseudorange_error > 10.0)
    cand = torch.nonzero(nlos_big.any(1) & (b.usable.sum(1) >= 6))[:, 0]
    if len(cand) == 0:
        print("RAIM stage: no big-NLOS epochs with >= 6 usable sats; "
              "geometry too open: rerun with a longer drive")
        return 0
    ref_ecef = lla_to_ecef(ref_lla[0], ref_lla[1], ref_lla[2])
    R = ecef_to_enu_rotation(ref_lla[0], ref_lla[1])
    prs_c = sim_c["pseudoranges"][cand]
    sat_ecef = sim_c["sat_enu"][cand] @ R + ref_ecef  # ENU -> ECEF
    valid = b.usable[cand] & torch.isfinite(prs_c)
    init = torch.cat([ref_ecef, ref_ecef.new_zeros(1)])
    res = raim.raim_detect(sat_ecef, torch.nan_to_num(prs_c), valid, init)
    hits = int(res.fault_detected.sum())
    raim_s = time.perf_counter() - t0
    rate = hits / len(cand)
    print(f"RAIM flags {hits}/{len(cand)} ray-traced big-NLOS epochs "
          f"({rate:.0%}); clean rerun and RAIM in {raim_s:.3f} s")
    return 0 if rate >= 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
