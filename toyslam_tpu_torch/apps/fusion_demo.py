"""UWB + IMU fusion through the sliding-window smoother as a CLI (port of
``apps/fusion_demo.py``, its simulation mode).

    python -m toyslam_tpu_torch.apps.fusion_demo out_dir \\
        [--trajectory circle|figure8] [--duration 25] [--imu-hz 200] \\
        [--kf-hz 4] [--range-noise 0.05] [--seed 0] [--device cuda|cpu]

The ``uwb_imu_batch_node`` story without ROS: a simulated trajectory with
a biased, noisy IMU and UWB ranges to the five default beacons
(``uwb_imu_sim_node``), a trilaterated position fix a keyframe
(``uwb_node``), the IMU preintegrated between keyframes, and the window
smoother (10 keyframes, 5 Gauss-Newton steps) with marginalisation.
Writes:

    out_dir/trajectory.txt   TUM-format smoothed poses
    out_dir/solution.csv     EvaPos CSV
    out_dir/metrics.jsonl    a line a keyframe: time, fix RMS, speed

and prints the smoothed-vs-fix, fix-vs-truth and smoothed-vs-truth RMSE
(after the first five keyframes) and the keyframe rate with the card's
name and power limit. Exits 0 iff the smoothed track is closer to the
truth than the raw fixes. Runs in f32 on the card (as the JAX app runs
f32 on its accelerator), in f64 with ``--device cpu``. The draws come
from a ``torch.Generator`` seeded with ``--seed``, so the numbers are not
the JAX app's. The keyframe loop reads nothing from the device; the
window's ``eigh`` does, once a marginalisation. ROS bag replay
(``--bag``, ``--write-bag``) waits for the port of ``runtime/rosbag``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def smooth(accs, gyrs, dtc, vld, fixes, stamps, q_start, q_end,
           cfg, params=None):
    """The app's keyframe loop over chunks ``accs``/``gyrs [n, R, 3]``,
    ``dtc``/``vld [n, R]`` and fixes [n, 3]: each chunk preintegrated with
    zero biases and gravity in the frame of ``q_start[k]``, a keyframe
    guessed at the fix with attitude ``q_end[k]``, pushed and optimised.
    Returns the newest state after each keyframe (a NavState of [n, ...]
    tensors). Reads nothing from the device; ``eigh`` does, once a
    marginalisation."""
    from toyslam_tpu_torch.core import se3
    from toyslam_tpu_torch.estimators import preintegration, window
    from toyslam_tpu_torch.estimators.factors import NavState

    if params is None:
        params = preintegration.PreintegrationParams(acc_noise=0.03,
                                                     gyro_noise=0.002)
    dtype, dev = accs.dtype, accs.device
    gw = torch.eye(3, dtype=dtype, device=dev)[2] * -9.81
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    spans = dtc.sum(1)
    win = window.window_init(cfg, dtype, dev)
    count = 0
    est = []
    for k in range(accs.shape[0]):
        R_T = se3.quat_to_rot(se3.quat_conjugate(q_start[k]))
        pre = preintegration.preintegrate(
            accs[k], gyrs[k], dtc[k], zero3, zero3,
            gravity_sensor=R_T @ gw, params=params, valid=vld[k])
        guess = NavState(p=fixes[k], q=q_end[k], v=zero3, ba=zero3,
                         bg=zero3)
        win = window.window_push(win, guess, stamps[k], fixes[k], True, pre,
                                 spans[k], cfg, count=count)
        count = min(count, cfg.window_size - 1) + 1
        win = window.window_optimize(win, cfg)
        est.append(window._state_at(win.states, count - 1))
    return NavState(*(torch.stack(x) for x in zip(*est)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--trajectory", choices=("circle", "figure8"),
                    default="circle")
    ap.add_argument("--duration", type=float, default=25.0)
    ap.add_argument("--imu-hz", type=float, default=200.0)
    ap.add_argument("--kf-hz", type=float, default=4.0)
    ap.add_argument("--range-noise", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bag", default=None)
    ap.add_argument("--write-bag", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.bag or args.write_bag:
        raise NotImplementedError(
            "--bag and --write-bag need runtime/rosbag, which the port does "
            "not have yet (ROADMAP, 'The rest'); run the simulation mode")

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.core import se3
    from toyslam_tpu_torch.estimators import trilateration, window
    from toyslam_tpu_torch.sim import sensors, trajectories
    from toyslam_tpu_torch.utils import evalio

    dev = device(args.device)
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    dt = 1.0 / args.imu_hz
    T = int(args.duration * args.imu_hz)
    imu_per_kf = max(int(args.imu_hz / args.kf_hz), 2)
    n_kf = T // imu_per_kf
    t = (torch.arange(T, dtype=dtype, device=dev) + 1) * dt
    traj_fn = getattr(trajectories, args.trajectory)
    traj = traj_fn(t)
    acc, gyro = sensors.simulate_imu(gen, traj)
    kf_idx = torch.arange(imu_per_kf - 1, T, imu_per_kf, device=dev)[:n_kf]
    ranges = sensors.simulate_uwb_ranges(gen, traj["pos"][kf_idx],
                                         noise_std=args.range_noise)
    beacons = torch.tensor(sensors.DEFAULT_BEACONS, dtype=dtype, device=dev)
    fixes, rms = trilateration.solve_positions_batch(
        ranges, beacons, torch.eye(3, dtype=dtype, device=dev)[2])

    accs = acc[:n_kf * imu_per_kf].reshape(n_kf, imu_per_kf, 3)
    gyrs = gyro[:n_kf * imu_per_kf].reshape(n_kf, imu_per_kf, 3)
    dtc = torch.full((n_kf, imu_per_kf), dt, dtype=dtype, device=dev)
    vld = torch.ones((n_kf, imu_per_kf), dtype=torch.bool, device=dev)
    # Attitude hints from the simulated trajectory: each chunk's start
    # (gravity compensation) and end (the keyframe's guess).
    q0 = traj_fn(torch.zeros(1, dtype=dtype, device=dev))["quat"]
    q_start = torch.cat([q0, traj["quat"][kf_idx[:-1] + 1]], 0)
    q_end = traj["quat"][kf_idx]
    stamps = kf_idx.to(dtype) * dt

    cfg = window.WindowConfig(window_size=10, gn_iterations=5,
                              pos_sigma=max(args.range_noise, 0.01))
    synchronize(dev)
    t0 = time.perf_counter()
    est = smooth(accs, gyrs, dtc, vld, fixes, stamps, q_start, q_end, cfg)
    synchronize(dev)
    wall = time.perf_counter() - t0

    est_p = est.p.double().cpu().numpy()
    fixes_np = fixes.double().cpu().numpy()
    gt_p = traj["pos"][kf_idx].double().cpu().numpy()
    times = stamps.double().cpu().numpy()
    speed = torch.linalg.norm(est.v, dim=-1).double().cpu().numpy()
    rms_np = rms.double().cpu().numpy()
    poses = np.tile(np.eye(4), (n_kf, 1, 1))
    poses[:, :3, :3] = se3.quat_to_rot(est.q.double().cpu()).numpy()
    poses[:, :3, 3] = est_p
    evalio.write_tum(out_dir / "trajectory.txt", times, poses)
    evalio.write_evapos_csv(out_dir / "solution.csv",
                            evalio.from_transforms(times, poses))
    log = evalio.MetricsLogger(out_dir / "metrics.jsonl")
    for k in range(n_kf):
        log.log(keyframe=k, time=float(times[k]), fix_rms=float(rms_np[k]),
                speed=float(speed[k]))

    warm = slice(5, None)  # the fill-up transient is left out

    def rmse(a, b):
        return float(np.sqrt(np.mean(np.sum((a[warm] - b[warm]) ** 2, 1))))

    raw = rmse(fixes_np, gt_p)
    smoothed = rmse(est_p, gt_p)
    print(f"{n_kf} keyframes in {wall:.2f} s ({n_kf / wall:.1f} keyframes/s;"
          f" {dev}, {str(dtype).replace('torch.', '')}, {card_line(dev)})")
    print(f"smoothed vs raw-fix RMSE:  {rmse(est_p, fixes_np):.4f} m")
    print(f"raw UWB fix RMSE vs GT:  {raw:.4f} m")
    print(f"smoothed RMSE vs GT:     {smoothed:.4f} m")
    print(f"wrote {out_dir}/trajectory.txt, solution.csv, metrics.jsonl")
    return 0 if smoothed < raw else 1


if __name__ == "__main__":
    sys.exit(main())
