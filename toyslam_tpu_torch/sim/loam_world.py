"""The LOAM test world in numpy: a spinning LiDAR ray-cast into walls,
poles and ground, and the drive through it that the LOAM app and
benchmark run (port of ``tests/test_loam.py``'s ``_synthetic_lidar_scan``
and ``apps/loam_demo.py``'s ``_synthetic_drive``).

The JAX package loops over rays in Python; here every ray of a scan is
cast at once. Each ray keeps the loop's candidate order (ground, wall
y = 15, wall x = 20, the four poles) and its strict ``0 < t < best``
updates, and the noise is drawn in one ``rng.normal(size=(hits, 3))``,
which is the stream of one ``size=3`` draw a hit in ray order, so a seed
gives the JAX generator's points.
"""

from __future__ import annotations

import numpy as np
import torch

from toyslam_tpu_torch.core import se3

# Poles of radius 0.3 m at these (x, y) corners.
POLES = ((-8, 4), (5, -7), (-4, -9), (10, 8))
# The drive's motion a frame: [tx ty tz roll pitch yaw] (apps/loam_demo.py).
DRIVE_STEP = (0.35, 0.05, 0.0, 0.0, 0.0, 0.05)


def synthetic_lidar_scan(rng, pose_T=np.eye(4), n_per_ring=360, n_rings=16,
                         fov_deg=(-25.0, 5.0)):
    """Body-frame hits [n, 3] f32 of ``n_rings`` x ``n_per_ring`` rays
    (elevations evenly over ``fov_deg``, azimuths over [-pi, pi)) from
    ``pose_T``, each 2-60 m away, with 0.01 m Gaussian noise."""
    az = np.linspace(-np.pi, np.pi, n_per_ring, endpoint=False)
    el = np.deg2rad(np.linspace(fov_deg[0], fov_deg[1], n_rings))
    e, a = np.repeat(el, n_per_ring), np.tile(az, n_rings)  # ring-major
    d_body = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                       np.sin(e)], -1)
    origin = np.asarray(pose_T[:3, 3], np.float64)
    Rw = np.asarray(pose_T[:3, :3], np.float64)
    d = d_body @ Rw.T
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    best = np.full(len(d), np.inf)
    oz = origin[2] + 1.5  # the sensor rides 1.5 m above the ground z = 0

    def take(ok, t):
        nonlocal best
        with np.errstate(divide="ignore", invalid="ignore"):
            hit = ok & (0 < t) & (t < best)
        best = np.where(hit, t, best)

    with np.errstate(divide="ignore", invalid="ignore"):
        take(dz < -1e-3, -oz / dz)
        t = (15.0 - origin[1]) / dy
        p = origin + t[:, None] * d
        take((np.abs(dy) > 1e-6) & (0 <= p[:, 2] + oz - origin[2])
             & (p[:, 2] < 6) & (-30 < p[:, 0]) & (p[:, 0] < 30), t)
        t = (20.0 - origin[0]) / dx
        p = origin + t[:, None] * d
        take((np.abs(dx) > 1e-6) & (p[:, 2] < 6) & (-30 < p[:, 1])
             & (p[:, 1] < 30), t)
        for px, py in POLES:
            oc = origin[:2] + 0 - np.array([px, py])
            A = dx**2 + dy**2
            B = 2 * (oc[0] * dx + oc[1] * dy)
            C = oc @ oc - 0.09
            disc = B * B - 4 * A * C
            take((disc > 0) & (A > 1e-9), (-B - np.sqrt(disc)) / (2 * A))
    hit = np.isfinite(best) & (2.0 < best) & (best < 60.0)
    p = (origin + best[hit, None] * d[hit]
         + 0.01 * rng.normal(size=(int(hit.sum()), 3)))
    return ((p - origin) @ Rw).astype(np.float32)


def drive(frames, seed, step=DRIVE_STEP, step_dtype=np.float32,
          n_per_ring=360, n_rings=16):
    """``frames`` scans along a drive of constant ``step`` a frame from the
    identity: (scans [list of [n, 3] f32], ground-truth poses [frames, 4,
    4]). The step matrix is rounded through ``step_dtype``: f32 as the JAX
    app computes it (it never enables x64), f64 as the benchmark does."""
    rng = np.random.default_rng(seed)
    step_T = se3.pose6_to_matrix(torch.tensor(step, dtype=torch.float64))
    step_T = step_T.numpy().astype(step_dtype).astype(np.float64)
    T = np.eye(4)
    scans, poses = [], []
    for _ in range(frames):
        scans.append(synthetic_lidar_scan(rng, T, n_per_ring, n_rings))
        poses.append(T.copy())
        T = T @ step_T
    return scans, np.stack(poses)


def pack(scans, capacity=None):
    """Scans [n_k, 3] -> (xyzi [S, capacity, 4] f32, mask [S, capacity]):
    the hits with intensity 0, then rows of 1e9, as the JAX app packs
    them; ``capacity`` defaults to the longest scan plus 64."""
    if capacity is None:
        capacity = max(len(s) for s in scans) + 64
    xyzi = np.full((len(scans), capacity, 4), 1e9, np.float32)
    mask = np.zeros((len(scans), capacity), bool)
    for i, s in enumerate(scans):
        xyzi[i, :len(s), :3] = s
        xyzi[i, :len(s), 3] = 0
        mask[i, :len(s)] = True
    return xyzi, mask
