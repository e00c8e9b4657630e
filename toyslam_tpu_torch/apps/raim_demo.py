"""End-to-end GPS RAIM: the ``GPSRAIM_node`` story as a CLI (port of
``apps/raim_demo.py``).

    python -m toyslam_tpu_torch.apps.raim_demo out_dir [--epochs 120] \\
        [--n-sats 8] [--fault-every 6] [--fault-magnitude 50] \\
        [--noise 2.0] [--seed 0] [--device cuda|cpu]

The reference node (``GPSRAIM.cpp``) runs a 1 Hz timer: simulate a
constellation around the true receiver, inject a pseudorange fault on a
random satellite, solve the iterated elevation-weighted WLS, run the
chi-square residual test, compute the HPL/VPL protection levels, try
leave-one-out exclusion, and publish the covariance ellipse and the
protection cylinder to RViz (``:251-303,395-725,823-918``). Here every
epoch is simulated, solved, tested and excluded in one batched call each
(``sim/gps.simulate_constellation`` over [epochs], ``raim_detect`` and
``fault_exclusion`` over [epochs] and [epochs, candidates]). Writes

    out_dir/raim.csv        per epoch: position error, test statistic,
                            detection and exclusion, HPL/VPL
    out_dir/ellipse.jsonl   per epoch: the covariance ellipse and the
                            protection cylinder (the RViz marker stream)

and prints the detection, false-alarm and exclusion rates and the run's
time beside the card. Exits 0 iff every injected fault is detected and
fewer than 10 % of the clean epochs raise an alarm. Float64 on the card
by default (the card computes float64 natively; ECEF needs it), on the
host with ``--device cpu``. The draws come from a CPU ``torch.Generator``
seeded with ``--seed``, so the card and the host draw the same numbers;
they are not the JAX app's, so a run matches its gates, not its
numbers.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--n-sats", type=int, default=8)
    ap.add_argument("--fault-every", type=int, default=6,
                    help="inject a fault on every k-th epoch (0 = never)")
    ap.add_argument("--fault-magnitude", type=float, default=50.0)
    ap.add_argument("--noise", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.core.geodesy import lla_to_ecef
    from toyslam_tpu_torch.gnss import raim
    from toyslam_tpu_torch.sim import gps

    dev = device(args.device)
    f64 = torch.float64
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    E, S = args.epochs, args.n_sats
    receiver = lla_to_ecef(*(torch.tensor(v, dtype=f64, device=dev) for v in
                             (math.radians(22.3), math.radians(114.17),
                              50.0)))
    sim_cfg = gps.GpsSimConfig(n_sats=S, noise_std=args.noise,
                               clock_bias=42.0, fault_magnitude=0.0)
    raim_cfg = raim.RaimConfig(noise_stddev_m=args.noise)
    gen = torch.Generator().manual_seed(args.seed)  # the same draws anywhere

    synchronize(dev)
    t0 = time.perf_counter()
    sim = gps.simulate_constellation(gen, receiver, sim_cfg, batch=(E,))
    # Every k-th epoch biases one uniformly drawn satellite (the
    # reference's random-index injection, ``:287-296``)
    steps = torch.arange(E, device=dev)
    faulted = ((steps % max(args.fault_every, 1) == 0) if args.fault_every > 0
               else torch.zeros(E, dtype=torch.bool, device=dev))
    fault_sat = torch.where(
        faulted, torch.randint(0, S, (E,), generator=gen).to(dev), -1)
    pr = sim["pseudoranges"] + torch.where(
        torch.arange(S, device=dev) == fault_sat[:, None],
        args.fault_magnitude, 0.0)
    valid = torch.ones((E, S), dtype=torch.bool, device=dev)
    # A cold start ~30 m off the truth with a zero clock; the reference
    # starts its WLS from the (known) simulation site too (``:395-481``)
    init = torch.cat([receiver + torch.tensor([30.0, -20.0, 10.0], dtype=f64,
                                              device=dev),
                      receiver.new_zeros(1)])
    det = raim.raim_detect(sim["sat_pos"], pr, valid, init, raim_cfg)
    excl, post_stat, best = raim.fault_exclusion(sim["sat_pos"], pr, valid,
                                                 init, raim_cfg)
    # Exclusion is attempted only on a detection, as the reference does
    excl = torch.where(det.fault_detected, excl, -1)
    ellipse = raim.covariance_ellipse(det)
    res = {
        "err_m": torch.linalg.norm(det.state[:, :3] - receiver, dim=-1),
        "err_after_excl_m": torch.linalg.norm(best.state[:, :3] - receiver,
                                              dim=-1),
        "test_stat": det.test_statistic, "detected": det.fault_detected,
        "excluded": excl, "post_stat": post_stat, "hpl": det.hpl,
        "vpl": det.vpl, "semi_major": ellipse["semi_major"],
        "semi_minor": ellipse["semi_minor"],
        "orientation_rad": ellipse["orientation_rad"],
        "sigma_up": ellipse["sigma_up"],
    }
    synchronize(dev)
    sec = time.perf_counter() - t0
    res = {k: v.cpu().numpy() for k, v in res.items()}
    fault_sat = fault_sat.cpu().numpy()
    faulted = faulted.cpu().numpy()

    with open(out / "raim.csv", "w") as f:
        f.write("epoch,fault_sat,err_m,err_after_excl_m,test_stat,"
                "detected,excluded,post_stat,hpl,vpl\n")
        for e in range(E):
            f.write(f"{e},{int(fault_sat[e])},{res['err_m'][e]:.3f},"
                    f"{res['err_after_excl_m'][e]:.3f},"
                    f"{res['test_stat'][e]:.3f},{int(res['detected'][e])},"
                    f"{int(res['excluded'][e])},{res['post_stat'][e]:.3f},"
                    f"{res['hpl'][e]:.3f},{res['vpl'][e]:.3f}\n")

    with open(out / "ellipse.jsonl", "w") as f:
        for e in range(E):
            f.write(json.dumps({
                "epoch": e,
                "semi_major_m": round(float(res["semi_major"][e]), 4),
                "semi_minor_m": round(float(res["semi_minor"][e]), 4),
                "orientation_rad": round(float(res["orientation_rad"][e]), 5),
                "sigma_up_m": round(float(res["sigma_up"][e]), 4),
                "hpl_m": round(float(res["hpl"][e]), 3),
                "vpl_m": round(float(res["vpl"][e]), 3),
            }) + "\n")

    det_rate = float(res["detected"][faulted].mean()) if faulted.any() else 1.0
    fa_rate = (float(res["detected"][~faulted].mean()) if (~faulted).any()
               else 0.0)
    hits = res["excluded"][faulted] == fault_sat[faulted]
    excl_acc = float(hits.mean()) if faulted.any() else 1.0
    clean_err = float(np.sqrt(np.mean(res["err_m"][~faulted] ** 2)))
    print(f"epochs: {E} ({int(faulted.sum())} faulted, "
          f"{args.fault_magnitude:.0f} m bias); simulation, detection and "
          f"exclusion in {sec:.3f} s ({card_line(dev)})")
    print(f"detection rate on faulted epochs: {det_rate:.2%}; "
          f"false alarms on clean epochs: {fa_rate:.2%}")
    print(f"exclusion picks the injected satellite: {excl_acc:.2%}")
    print(f"clean-epoch position RMSE {clean_err:.2f} m; "
          f"mean HPL {res['hpl'].mean():.1f} m, VPL {res['vpl'].mean():.1f} m")
    print(f"wrote {out}/raim.csv, ellipse.jsonl")
    return 0 if (det_rate == 1.0 and fa_rate < 0.1) else 1


if __name__ == "__main__":
    sys.exit(main())
