"""UWB/GPS + IMU fusion through the sliding-window smoother as a CLI (port
of ``apps/fusion_demo.py``).

    python -m toyslam_tpu_torch.apps.fusion_demo out_dir \\
        [--trajectory circle|figure8] [--duration 25] [--imu-hz 200] \\
        [--kf-hz 4] [--range-noise 0.05] [--seed 0] [--device cuda|cpu] \\
        [--write-bag file.bag] [--bag file.bag]

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
window's ``eigh`` does, once a marginalisation.

``--write-bag`` also writes the simulated sensors as a ROS1 bag with lz4
chunks: ``sensor_msgs/Imu`` on /imu/data at every IMU sample and a NovAtel
INSPVAX fix on /novatel_data/inspvax at every keyframe, about the Hong
Kong reference point. ``--bag`` replays such a bag (or a NavSatFix GPS
stream on that topic) in place of the simulation, the reference's
``imuCallback``/``gpsCallback`` graph (``uwb_imu_batch_node.cpp:3027,
2284``): the fixes go to ENU about the first by the reference's flat-earth
conversion (``:2182-2213``), each fix is a keyframe (``:3147``), and the
IMU samples between fixes are preintegrated as a padded, masked chunk,
each chunk's attitude taken from the estimate before it. A replay knows no
truth: it prints the smoothed-vs-fix RMSE and exits 0.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Hong Kong reference point of the written GPS stream (the reference's
# dataset is UrbanNav-HK), and the Unix time of its first stamp.
_REF_LAT_DEG, _REF_LON_DEG, _REF_ALT = 22.3, 114.18, 5.0
_BAG_BASE_UNIX = 1.7e9


def write_sensor_bag(path, t_imu, acc, gyro, kf_times, fixes_enu):
    """Write the sensors as the JAX app's mixed bag: an Imu message a
    sample and an INSPVAX fix a keyframe, sorted by time, lz4 chunks. All
    arrays are float64 numpy (times [T], acc/gyro [T, 3], kf_times [K],
    fixes_enu [K, 3])."""
    from toyslam_tpu_torch.core import geodesy
    from toyslam_tpu_torch.runtime import rosbag

    lat, lon, alt = geodesy.flat_earth_enu_to_gps(
        torch.from_numpy(np.asarray(fixes_enu, np.float64)),
        np.deg2rad(_REF_LAT_DEG), np.deg2rad(_REF_LON_DEG), _REF_ALT)
    lat, lon, alt = lat.numpy(), lon.numpy(), alt.numpy()
    records = []
    for i in range(len(t_imu)):
        t = _BAG_BASE_UNIX + float(t_imu[i])
        records.append(("/imu/data", "sensor_msgs/Imu", t,
                        rosbag.encode_imu(t, gyro[i], acc[i])))
    for k in range(len(kf_times)):
        t = _BAG_BASE_UNIX + float(kf_times[k])
        week, tow = geodesy.unix_to_gps_time(np.float64(t))
        records.append((
            "/novatel_data/inspvax", "novatel_msgs/INSPVAX", t,
            rosbag.encode_inspvax(int(week), int(round(float(tow) * 1000.0)),
                                  float(np.rad2deg(lat[k])),
                                  float(np.rad2deg(lon[k])), float(alt[k]))))
    records.sort(key=lambda r: r[2])
    rosbag.write_mixed_bag(path, records, compression="lz4")


def load_bag_inputs(bag_path, dtype, dev):
    """A bag -> the smoother's inputs: fixes [K, 3] f64 numpy (ENU about
    the first fix), keyframe stamps [K] f64 numpy (from the first fix),
    and acc/gyro [K, R, 3], dt [K, R] and valid [K, R] tensors on ``dev``
    (the IMU samples up to each fix, padded to the longest chunk)."""
    from toyslam_tpu_torch.core import geodesy
    from toyslam_tpu_torch.runtime import rosbag

    t_imu, acc, gyro, dt = rosbag.pack_bag_imu(bag_path)
    t_gps, lla, _vel = rosbag.pack_bag_gps(bag_path)
    if len(t_gps) < 2 or len(t_imu) < 2:
        raise SystemExit("bag must contain IMU and GPS messages")
    ref_lat, ref_lon = np.deg2rad(lla[0, 0]), np.deg2rad(lla[0, 1])
    fixes = geodesy.flat_earth_gps_to_enu(
        np.deg2rad(lla[:, 0]), np.deg2rad(lla[:, 1]), lla[:, 2],
        ref_lat, ref_lon, lla[0, 2]).numpy()
    bounds = np.searchsorted(t_imu, t_gps, side="right")
    starts = np.concatenate([[0], bounds[:-1]])
    R = max(int((bounds - starts).max()), 2)
    K = len(t_gps)
    accs = np.zeros((K, R, 3), np.float32)
    gyrs = np.zeros((K, R, 3), np.float32)
    dtc = np.zeros((K, R), np.float32)
    vld = np.zeros((K, R), bool)
    for k in range(K):
        lo, hi = int(starts[k]), int(bounds[k])
        accs[k, :hi - lo] = acc[lo:hi]
        gyrs[k, :hi - lo] = gyro[lo:hi]
        dtc[k, :hi - lo] = dt[lo:hi]
        vld[k, :hi - lo] = True

    def t(a):
        return torch.from_numpy(a).to(dev, dtype)

    return (fixes, t_gps - t_gps[0], t(accs), t(gyrs), t(dtc),
            torch.from_numpy(vld).to(dev))


def smooth(accs, gyrs, dtc, vld, fixes, stamps, q_start, q_end,
           cfg, params=None):
    """The app's keyframe loop over chunks ``accs``/``gyrs [n, R, 3]``,
    ``dtc``/``vld [n, R]`` and fixes [n, 3]: each chunk preintegrated with
    zero biases and gravity in the frame of ``q_start[k]``, a keyframe
    guessed at the fix with attitude ``q_end[k]``, pushed and optimised.
    With ``q_start``/``q_end`` None (a bag replay, which has no attitude
    hints) both are the newest estimate's attitude before the chunk,
    identity at the start. Returns the newest state after each keyframe
    (a NavState of [n, ...] tensors). Reads nothing from the device;
    ``eigh`` does, once a marginalisation."""
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
    q_prev = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev)
    for k in range(accs.shape[0]):
        qs = q_prev if q_start is None else q_start[k]
        R_T = se3.quat_to_rot(se3.quat_conjugate(qs))
        pre = preintegration.preintegrate(
            accs[k], gyrs[k], dtc[k], zero3, zero3,
            gravity_sensor=R_T @ gw, params=params, valid=vld[k])
        guess = NavState(p=fixes[k], q=q_prev if q_end is None else q_end[k],
                         v=zero3, ba=zero3, bg=zero3)
        win = window.window_push(win, guess, stamps[k], fixes[k], True, pre,
                                 spans[k], cfg, count=count)
        count = min(count, cfg.window_size - 1) + 1
        win = window.window_optimize(win, cfg)
        est.append(window._state_at(win.states, count - 1))
        q_prev = est[-1].q
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
    ap.add_argument("--bag", default=None,
                    help="replay a ROS1 bag (sensor_msgs/Imu + "
                         "INSPVAX/NavSatFix) instead of simulating")
    ap.add_argument("--write-bag", default=None,
                    help="also write the simulated sensors as a ROS1 bag "
                         "(Imu + INSPVAX, lz4 chunks)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from toyslam_tpu_torch.apps.common import card_line, device, synchronize
    from toyslam_tpu_torch.core import se3
    from toyslam_tpu_torch.estimators import trilateration, window
    from toyslam_tpu_torch.sim import sensors, trajectories
    from toyslam_tpu_torch.utils import evalio

    dev = device(args.device)
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    gt_p = rms = q_start = q_end = None
    if args.bag:
        fixes_np, kf_times, accs, gyrs, dtc, vld = load_bag_inputs(
            args.bag, dtype, dev)
        n_kf = len(kf_times)
        fixes = torch.from_numpy(fixes_np).to(dev, dtype)
        stamps = torch.from_numpy(kf_times).to(dev, dtype)
        print(f"bag: {n_kf} GPS keyframes, IMU chunks up to "
              f"{accs.shape[1]} samples")
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        dt = 1.0 / args.imu_hz
        T = int(args.duration * args.imu_hz)
        imu_per_kf = max(int(args.imu_hz / args.kf_hz), 2)
        n_kf = T // imu_per_kf
        t = (torch.arange(T, dtype=dtype, device=dev) + 1) * dt
        traj_fn = getattr(trajectories, args.trajectory)
        traj = traj_fn(t)
        acc, gyro = sensors.simulate_imu(gen, traj)
        kf_idx = torch.arange(imu_per_kf - 1, T, imu_per_kf,
                              device=dev)[:n_kf]
        ranges = sensors.simulate_uwb_ranges(gen, traj["pos"][kf_idx],
                                             noise_std=args.range_noise)
        beacons = torch.tensor(sensors.DEFAULT_BEACONS, dtype=dtype,
                               device=dev)
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
        fixes_np = fixes.double().cpu().numpy()
        gt_p = traj["pos"][kf_idx].double().cpu().numpy()
        if args.write_bag:
            def host(x):
                return x.double().cpu().numpy()

            write_sensor_bag(args.write_bag, host(t), host(acc), host(gyro),
                             host(stamps), fixes_np)
            print(f"wrote sensor bag: {args.write_bag}")

    cfg = window.WindowConfig(window_size=10, gn_iterations=5,
                              pos_sigma=max(args.range_noise, 0.01))
    synchronize(dev)
    t0 = time.perf_counter()
    est = smooth(accs, gyrs, dtc, vld, fixes, stamps, q_start, q_end, cfg)
    synchronize(dev)
    wall = time.perf_counter() - t0

    est_p = est.p.double().cpu().numpy()
    times = stamps.double().cpu().numpy()
    speed = torch.linalg.norm(est.v, dim=-1).double().cpu().numpy()
    rms_np = (np.zeros(n_kf) if rms is None
              else rms.double().cpu().numpy())
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

    print(f"{n_kf} keyframes in {wall:.2f} s ({n_kf / wall:.1f} keyframes/s;"
          f" {dev}, {str(dtype).replace('torch.', '')}, {card_line(dev)})")
    print(f"smoothed vs raw-fix RMSE:  {rmse(est_p, fixes_np):.4f} m")
    if gt_p is None:
        print(f"wrote {out_dir}/trajectory.txt, solution.csv, metrics.jsonl")
        return 0
    raw = rmse(fixes_np, gt_p)
    smoothed = rmse(est_p, gt_p)
    print(f"raw UWB fix RMSE vs GT:  {raw:.4f} m")
    print(f"smoothed RMSE vs GT:     {smoothed:.4f} m")
    print(f"wrote {out_dir}/trajectory.txt, solution.csv, metrics.jsonl")
    return 0 if smoothed < raw else 1


if __name__ == "__main__":
    sys.exit(main())
