"""End-to-end UWB positioning: the ``uwb_node`` + ``uwb_imu_EKF_node``
stories as one CLI (port of ``apps/uwb_demo.py``).

    python -m toyslam_tpu_torch.apps.uwb_demo out_dir [--duration 60] \\
        [--uwb-hz 10] [--imu-hz 200] [--range-noise 0.3] \\
        [--nlos-prob 0.05] [--no-eskf] [--device cuda|cpu] [--seed 0]

Stage 1 (``uwb_node``): 8 anchors on a height-staggered 50 m ring, noisy
ranges to a 30 m circle at ``--uwb-hz`` with optional NLOS spikes (+1..3 m
on one random anchor), and a Huber Gauss-Newton trilateration per epoch,
warm-started from the previous fix (``uwb_node.cpp:221``): a sequential
loop, as in JAX. Stage 2 (``uwb_imu_EKF_node``, skipped with
``--no-eskf``): a simulated IMU at ``--imu-hz`` (bias and noise) and the
fixes fuse in the 15-state ESKF.

Writes out_dir/{solution_uwb.csv, solution_eskf.csv} (EvaPos) and
anchors.json, and prints both ATEs and the stages' times. Exits 0 iff the
fused ATE after the 10 s transient (with ``--no-eskf``: the horizontal
trilateration ATE) is below 0.5 m. Draws come from a ``torch.Generator``
seeded with ``--seed`` on the run's device, so a run matches the JAX
app's gates, not its numbers. Runs on the card in f32; ``--device cpu``
runs in f64 on the host, as the JAX app does off the TPU.
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
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--uwb-hz", type=float, default=10.0)
    ap.add_argument("--imu-hz", type=float, default=200.0)
    ap.add_argument("--range-noise", type=float, default=0.3)
    ap.add_argument("--nlos-prob", type=float, default=0.05,
                    help="per-epoch probability of a +1..3 m NLOS spike "
                         "on one random anchor")
    ap.add_argument("--no-eskf", action="store_true",
                    help="stop after trilateration (pure uwb_node story)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.estimators import eskf, trilateration
    from toyslam_tpu_torch.sim import sensors, trajectories
    from toyslam_tpu_torch.utils import evalio

    dev = device(args.device)
    dt = torch.float64 if dev.type == "cpu" else torch.float32
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # ---- ground truth + anchors (x10-scale ring, uwb_node.cpp:70-98) ----
    R_traj, omega = 30.0, 0.08
    E = int(args.duration * args.uwb_hz)
    t_uwb = torch.arange(E, dtype=dt, device=dev) / args.uwb_hz
    gt = trajectories.circle(t_uwb, radius=R_traj, omega=omega, z=1.0)
    k = torch.arange(8, dtype=dt, device=dev)
    theta_a = k * (2 * math.pi / 8)
    # Height-staggered ring (0/3/6/9 m): with all anchors on one plane the
    # vertical DOP at 50 m horizontal range is ~12x.
    anchors = torch.stack([50.0 * torch.cos(theta_a),
                           50.0 * torch.sin(theta_a), 3.0 * (k % 4)], -1)

    # ---- stage 1: ranges + warm-started trilateration ----
    ranges = sensors.simulate_uwb_ranges(gen, gt["pos"], anchors,
                                         noise_std=args.range_noise)
    nlos_hit = torch.rand(E, generator=gen, dtype=dt, device=dev) < (
        args.nlos_prob)
    nlos_anchor = torch.randint(0, 8, (E,), generator=gen, device=dev)
    nlos_mag = 1.0 + 2.0 * torch.rand(E, generator=gen, dtype=dt,
                                      device=dev)
    spike = nlos_hit[:, None] & (torch.arange(8, device=dev)[None]
                                 == nlos_anchor[:, None])
    ranges = ranges + torch.where(spike, nlos_mag[:, None], 0.0)

    tri_cfg = trilateration.TrilaterationConfig(huber_delta=0.5)
    # Cold start near the arena centre; every later epoch warm-starts from
    # the previous fix.
    p = torch.eye(3, dtype=dt, device=dev)[0] + torch.eye(
        3, dtype=dt, device=dev)[2] * 0.5
    synchronize(dev)
    t0 = time.perf_counter()
    fixes = []
    for e in range(E):
        p, _ = trilateration.solve_position(ranges[e], anchors, p,
                                            config=tri_cfg)
        fixes.append(p)
    fixes = torch.stack(fixes)
    synchronize(dev)
    tri_s = time.perf_counter() - t0
    fixes_np = fixes.double().cpu().numpy()
    gt_np = gt["pos"].double().cpu().numpy()
    tri_d = fixes_np - gt_np
    tri_ate = float(np.sqrt(np.mean(np.sum(tri_d**2, 1))))
    # Vertical error is DOP-limited; the uwb-only gate is horizontal.
    tri_ate_h = float(np.sqrt(np.mean(np.sum(tri_d[:, :2] ** 2, 1))))

    T_mat = np.tile(np.eye(4), (E, 1, 1))
    T_mat[:, :3, 3] = fixes_np
    evalio.write_evapos_csv(out / "solution_uwb.csv", evalio.from_transforms(
        t_uwb.double().cpu().numpy(), T_mat))
    with open(out / "anchors.json", "w") as f:
        json.dump({"anchors": anchors.double().cpu().numpy().tolist()}, f)
    card = card_line(dev)
    print(f"trilateration: {E} epochs, ATE {tri_ate:.3f} m (horizontal "
          f"{tri_ate_h:.3f} m; range noise {args.range_noise} m, "
          f"{int(nlos_hit.sum())} NLOS epochs); {tri_s:.3f} s, "
          f"{1e3 * tri_s / max(E, 1):.3f} ms/epoch ({card})")
    if args.no_eskf:
        print(f"wrote {out}/solution_uwb.csv, anchors.json")
        return 0 if tri_ate_h < 0.5 else 1

    # ---- stage 2: IMU + position fixes -> ESKF ----
    ratio = max(int(round(args.imu_hz / args.uwb_hz)), 1)
    T_imu = E * ratio
    t_imu = torch.arange(T_imu, dtype=dt, device=dev) / args.imu_hz
    gt_imu = trajectories.circle(t_imu, radius=R_traj, omega=omega, z=1.0)
    acc, gyro = sensors.simulate_imu(gen, gt_imu)
    # Fix e lands on the IMU tick at the same timestamp, e * ratio.
    at = torch.arange(E, device=dev) * ratio
    meas = torch.zeros((T_imu, 3), dtype=dt, device=dev).index_copy(
        0, at, fixes)
    meas_valid = torch.zeros((T_imu,), dtype=torch.bool,
                             device=dev).index_fill(0, at, True)
    log = eskf.ESKFLog(
        dt=torch.full((T_imu,), 1.0 / args.imu_hz, dtype=dt, device=dev),
        acc=acc, gyro=gyro, meas=meas, meas_valid=meas_valid)
    # The filter starts at the first fix (as the reference EKF does) with
    # the identity attitude, which the position updates correct.
    state = eskf.init_state(dt, device=dev)._replace(p=fixes[0])
    params = eskf.ESKFParams(meas_noise=float(args.range_noise) ** 2)
    synchronize(dev)
    t0 = time.perf_counter()
    _, traj = eskf.eskf_run(log, state, params)
    synchronize(dev)
    eskf_s = time.perf_counter() - t0

    fused_p = traj["p"].double().cpu().numpy()
    # ~10 s of updates settle the attitude and biases; that transient is
    # left out (at most half the run).
    warm = min(int(10.0 * args.imu_hz), T_imu // 2)
    fused_err = np.linalg.norm(
        fused_p - gt_imu["pos"].double().cpu().numpy(), axis=1)
    fused_ate = float(np.sqrt(np.mean(fused_err[warm:] ** 2)))

    T_mat = np.tile(np.eye(4), (T_imu, 1, 1))
    T_mat[:, :3, 3] = fused_p
    evalio.write_evapos_csv(out / "solution_eskf.csv", evalio.from_transforms(
        t_imu.double().cpu().numpy(), T_mat,
        vel=traj["v"].double().cpu().numpy()))
    print(f"ESKF fused ({dev}, {str(dt).replace('torch.', '')}): {T_imu} IMU "
          f"ticks, ATE {fused_ate:.3f} m (post-transient); {eskf_s:.3f} s, "
          f"{1e3 * eskf_s / T_imu:.4f} ms/tick ({card})")
    print(f"wrote {out}/solution_uwb.csv, solution_eskf.csv, anchors.json")
    return 0 if fused_ate < 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
