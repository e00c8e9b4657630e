"""Trajectory output and evaluation (port of ``toyslam_tpu/utils/evalio.py``).

- the EvaPos CSV schema (``Time, PosXYZ, QuatWXYZ, VelXYZ``, Time in
  nanoseconds) and TUM text (``t x y z qx qy qz qw``), written and read;
- ATE (optionally Umeyama-aligned), RPE and error statistics, and the
  EvaPos "Baseline vs Proposed" comparison of two solutions;
- per-scan JSONL metrics.

Host-side numpy; quaternions come from the port's ``se3.rot_to_quat`` in
the poses' dtype, as the JAX module computes them in ``jnp``.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from toyslam_tpu_torch.core import se3


class Trajectory(NamedTuple):
    time: np.ndarray  # [T] seconds
    pos: np.ndarray  # [T, 3]
    quat: np.ndarray  # [T, 4] wxyz
    vel: np.ndarray  # [T, 3]


def _quats(transforms: np.ndarray) -> np.ndarray:
    return se3.rot_to_quat(torch.from_numpy(
        np.ascontiguousarray(transforms[:, :3, :3]))).numpy()


def from_transforms(times, transforms, vel=None) -> Trajectory:
    """Build a Trajectory from [T, 4, 4] pose matrices; velocities by
    central differences over the sample times when not given."""
    transforms = np.asarray(transforms)
    quat = _quats(transforms)
    pos = transforms[:, :3, 3]
    if vel is None:
        t = np.asarray(times, dtype=np.float64)
        if len(t) > 1:
            # Stamps clamped to monotone, then a 1e-9 s jitter: logs hold
            # duplicated and out-of-order stamps, and np.gradient needs
            # strictly increasing ones.
            tt = np.maximum.accumulate(t) + np.arange(len(t)) * 1e-9
            vel = np.gradient(pos, tt, axis=0)
        else:
            vel = np.zeros_like(pos)
    return Trajectory(np.asarray(times, np.float64), pos, quat,
                      np.asarray(vel))


def write_evapos_csv(path: str | Path, traj: Trajectory) -> None:
    """Write the EvaPos CSV schema (Time in nanoseconds, trailing comma)."""
    with open(path, "w", newline="") as f:
        f.write("Time,PosX,PosY,PosZ,QuatW,QuatX,QuatY,QuatZ,VelX,VelY,VelZ,\n")
        for i in range(len(traj.time)):
            t_ns = int(round(traj.time[i] * 1e9))
            row = [t_ns] + [f"{v:.5f}" for v in (*traj.pos[i], *traj.quat[i],
                                                 *traj.vel[i])]
            f.write(",".join(str(v) for v in row) + ",\n")


def read_evapos_csv(path: str | Path) -> Trajectory:
    """Read an EvaPos-schema CSV; times in seconds from the first row's."""
    cols = ("Time", "PosX", "PosY", "PosZ", "QuatW", "QuatX", "QuatY",
            "QuatZ", "VelX", "VelY", "VelZ")
    with open(path) as f:
        a = np.asarray([[float(r[c]) for c in cols]
                        for r in csv.DictReader(f)])
    return Trajectory((a[:, 0] - a[0, 0]) / 1e9, a[:, 1:4], a[:, 4:8],
                      a[:, 8:11])


def write_tum(path: str | Path, times, transforms) -> None:
    """TUM format: ``t x y z qx qy qz qw`` per line."""
    transforms = np.asarray(transforms)
    quat = _quats(transforms)
    with open(path, "w") as f:
        for t, T, q in zip(np.asarray(times), transforms, quat):
            x, y, z = T[:3, 3]
            f.write(f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def read_tum(path: str | Path):
    """-> (times [T], positions [T, 3], quaternions [T, 4] wxyz)."""
    data = np.loadtxt(path)
    quat_xyzw = data[:, 4:8]
    quat = np.concatenate([quat_xyzw[:, 3:4], quat_xyzw[:, :3]], 1)
    return data[:, 0], data[:, 1:4], quat


class ErrorStats(NamedTuple):
    """current / min / max / avg / rmse over a stream of errors."""

    current: float
    min: float
    max: float
    avg: float
    rmse: float
    count: int


def error_stats(errors) -> ErrorStats:
    e = np.asarray(errors, np.float64)
    if not len(e):
        return ErrorStats(0.0, 0.0, 0.0, 0.0, 0.0, 0)
    return ErrorStats(current=float(e[-1]), min=float(e.min()),
                      max=float(e.max()), avg=float(e.mean()),
                      rmse=float(np.sqrt(np.mean(e**2))), count=len(e))


def ate(est_pos, gt_pos, align: bool = True):
    """Absolute trajectory error: (RMSE, per-sample errors), after an SE(3)
    Umeyama alignment of the estimate when ``align``."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    if align:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        W = (est - mu_e).T @ (gt - mu_g)
        u, _, vt = np.linalg.svd(W)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        R = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        est = est @ R.T + (mu_g - R @ mu_e)
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err**2))), err


def rpe(est_T, gt_T, delta: int = 1):
    """Relative pose error over a fixed frame delta: (translation RMSE,
    rotation RMSE in rad); est/gt [T, 4, 4]."""
    est = np.asarray(est_T, np.float64)
    gt = np.asarray(gt_T, np.float64)
    errs_t, errs_r = [], []
    for i in range(len(est) - delta):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        errs_t.append(np.linalg.norm(e[:3, 3]))
        errs_r.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1,
                                        1)))
    return (float(np.sqrt(np.mean(np.square(errs_t)))),
            float(np.sqrt(np.mean(np.square(errs_r)))))


class MetricsLogger:
    """Append-only JSONL per-scan metrics."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, **metrics):
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics) + "\n")

    def read(self):
        if not self.path.exists():
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def compare_solutions(traj_a: Trajectory, traj_b: Trajectory):
    """EvaPos-style comparison of two solutions ("Baseline vs Proposed"):
    B interpolated onto A's times; a dict of ErrorStats for the position
    components, the horizontal and 3D position error, the 3D velocity
    error and the wrapped yaw difference."""
    def interp(col):
        return np.interp(traj_a.time, traj_b.time, col)

    pos_b = np.stack([interp(traj_b.pos[:, i]) for i in range(3)], -1)
    vel_b = np.stack([interp(traj_b.vel[:, i]) for i in range(3)], -1)
    d = traj_a.pos - pos_b
    out = {
        "pos_x": error_stats(np.abs(d[:, 0])),
        "pos_y": error_stats(np.abs(d[:, 1])),
        "pos_z": error_stats(np.abs(d[:, 2])),
        "pos_2d": error_stats(np.linalg.norm(d[:, :2], axis=1)),
        "pos_3d": error_stats(np.linalg.norm(d, axis=1)),
        "vel_3d": error_stats(np.linalg.norm(traj_a.vel - vel_b, axis=1)),
    }

    def yaw_of(q):
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))

    yaw_b = interp(np.unwrap(yaw_of(traj_b.quat)))
    dyaw = np.mod(yaw_of(traj_a.quat) - yaw_b + np.pi, 2 * np.pi) - np.pi
    out["yaw"] = error_stats(np.abs(dyaw))
    return out
