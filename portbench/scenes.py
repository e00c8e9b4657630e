"""Spinning-LiDAR scans of a generated street scene, ray-cast on the device.

The benchmark's own copy of the port's ``sim/urban_scans``: the scene (box
buildings with facade columns, poles, cars, cross streets) and the
trajectory come from ``numpy.random.default_rng(scene_seed)`` exactly as
there, so a scene seed names the same street in both; the ray cast runs as
one tensor program in float64 on the device (every ray against every box
within range, in chunks of rays), which is what keeps a log of 256k-ray
scans out of the set-up's time. Range noise is drawn from a
``torch.Generator`` on the device, so the scans of one seed are the same
on every run, and not the numpy generator's.

A log is cast once (``cast_log``: noiseless ranges and surface kinds);
``realise`` turns it into scans with a given noise draw and a yaw of the
sensor about its z axis, so one cast gives many byte-distinct logs of the
same street.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PAD_COORD = 1.0e9
SENSOR_HEIGHT = 1.8
MIN_RANGE = 2.0
MAX_RANGE = 80.0


def street_scene(rng: np.random.Generator, x_lo=-110.0, x_hi=130.0):
    """Axis-aligned boxes ``[B, 2, 3]`` (min corner, max corner) and a
    surface kind per box (1 building, 2 pole, 3 car)."""
    boxes, kinds = [], []
    for side in (-1.0, 1.0):
        x = x_lo
        while x < x_hi:
            if rng.random() < 0.1:  # cross street
                x += rng.uniform(12.0, 18.0)
                continue
            length = rng.uniform(8.0, 25.0)
            setback = rng.uniform(6.0, 10.0)
            depth = rng.uniform(8.0, 15.0)
            height = rng.uniform(6.0, 30.0)
            y0, y1 = sorted((side * setback, side * (setback + depth)))
            boxes.append([[x, y0, 0.0], [x + length, y1, height]])
            kinds.append(1)
            for cx in np.arange(x + 0.5, x + length - 1.0,
                                rng.uniform(3.0, 5.0)):
                face = side * setback
                y0, y1 = sorted((face, face - side * 0.4))
                boxes.append([[cx, y0, 0.0], [cx + 0.6, y1, height]])
                kinds.append(1)
            x += length + rng.uniform(0.0, 3.0)
        for x in np.arange(x_lo, x_hi, rng.uniform(10.0, 14.0)):
            y = side * rng.uniform(5.0, 6.0)
            boxes.append([[x, y - 0.15, 0.0], [x + 0.3, y + 0.15, 6.0]])
            kinds.append(2)
        for x in rng.uniform(x_lo, x_hi, 12):
            y = side * rng.uniform(3.0, 4.5)
            boxes.append([[x, y - 0.9, 0.0], [x + 4.5, y + 0.9, 1.5]])
            kinds.append(3)
    return np.asarray(boxes, np.float64), np.asarray(kinds)


def trajectory(rng: np.random.Generator, num_scans: int, step=0.3,
               yaw_rate=0.004, tilt_deg=0.5):
    """World-from-sensor poses ``[S, 4, 4]``: ``step`` metres along the
    heading a scan, yawing ``yaw_rate`` rad a scan, with roll and pitch
    drawn from N(0, ``tilt_deg``) a scan."""
    poses = np.tile(np.eye(4), (num_scans, 1, 1))
    x = y = yaw = 0.0
    for k in range(num_scans):
        c, s = np.cos(yaw), np.sin(yaw)
        roll, pitch = rng.normal(0.0, np.deg2rad(tilt_deg), 2)
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        poses[k, :3, :3] = (
            np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            @ np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
            @ np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]]))
        poses[k, :3, 3] = [x, y, SENSOR_HEIGHT]
        x += step * c
        y += step * s
        yaw += yaw_rate
    return poses


def ray_directions(rings: int, azimuths: int, fov_deg) -> np.ndarray:
    """Unit ray directions in the sensor frame, ``[rings * azimuths, 3]``
    f64, ring-major."""
    elev = np.deg2rad(np.linspace(fov_deg[0], fov_deg[1], rings))
    azim = np.linspace(0.0, 2 * np.pi, azimuths, endpoint=False)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    return np.stack([ce * np.cos(azim), ce * np.sin(azim),
                     np.broadcast_to(se, (rings, azimuths))], -1
                    ).reshape(-1, 3)


def ray_ranges(origin, dirs, boxes, chunk=16384):
    """First hit distance of each world ray ``dirs [n, 3]`` from ``origin
    [3]`` (inf on a miss) and the kind of surface hit (0 ground, else box
    index + 1), as f64 / int64 tensors on ``dirs``' device. A box wins over
    the ground only when strictly closer, and among boxes the first of the
    nearest."""
    safe = torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12),
                       dirs)
    best = torch.where(dirs[:, 2] < 0, -origin[2] / safe[:, 2],
                       torch.full_like(dirs[:, 2], math.inf))
    kind = torch.zeros(len(dirs), dtype=torch.int64, device=dirs.device)
    gap = torch.clamp(torch.maximum(boxes[:, 0] - origin,
                                    origin - boxes[:, 1]), min=0.0)
    near = torch.nonzero(torch.linalg.vector_norm(gap, dim=1) <= MAX_RANGE
                         )[:, 0]
    if len(near) == 0:
        return best, kind
    lo, hi = boxes[near, 0] - origin, boxes[near, 1] - origin  # [B, 3]
    for s in range(0, len(dirs), chunk):
        inv = 1.0 / safe[s:s + chunk, None, :]  # [c, 1, 3]
        t1, t2 = lo[None] * inv, hi[None] * inv
        t_near = torch.minimum(t1, t2).amax(-1)
        t_far = torch.maximum(t1, t2).amin(-1)
        t_hit = torch.where((t_far >= t_near) & (t_near > 0), t_near,
                            torch.full_like(t_near, math.inf))
        t_min, j = t_hit.min(1)
        closer = t_min < best[s:s + chunk]
        best[s:s + chunk] = torch.where(closer, t_min, best[s:s + chunk])
        kind[s:s + chunk] = torch.where(closer, near[j] + 1,
                                        kind[s:s + chunk])
    return best, kind


def cast_log(scene_seed: int, num_scans: int, rings: int, azimuths: int,
             fov_deg, step=0.3, yaw_rate=0.004, tilt_deg=0.5,
             device="cuda"):
    """The noiseless log of one street: ``{"dirs" [n, 3], "range" [S, n],
    "surface" [S, n] (0 ground, 1 building, 2 pole, 3 car), "poses" [S, 4,
    4] f64 numpy}``, tensors f64 / int64 on ``device``."""
    rng = np.random.default_rng(scene_seed)
    boxes, box_kind = street_scene(rng)
    poses = trajectory(rng, num_scans, step, yaw_rate, tilt_deg)
    dirs = torch.as_tensor(ray_directions(rings, azimuths, fov_deg),
                           device=device)
    boxes_t = torch.as_tensor(boxes, device=device)
    surface = torch.as_tensor(np.concatenate([[0], box_kind]), device=device)
    poses_t = torch.as_tensor(poses, device=device)
    ranges, kinds = [], []
    for k in range(num_scans):
        R, t = poses_t[k, :3, :3], poses_t[k, :3, 3]
        r, kind = ray_ranges(t, dirs @ R.T, boxes_t)
        ranges.append(r)
        kinds.append(surface[kind])
    return {"dirs": dirs, "range": torch.stack(ranges),
            "surface": torch.stack(kinds), "poses": poses}


def realise(log, noise: float, yaw: float, generator: torch.Generator):
    """Scans of a cast log: ranges plus N(0, ``noise``) drawn from
    ``generator`` (on the log's device), the sensor turned by ``yaw`` rad
    about its z axis. Returns ``(xyzi [S, n, 4] f32, mask [S, n])``;
    intensity is ``0.25 * surface + 0.2 * (1 - range / 80)`` and rays that
    miss, or fall outside 2-80 m, carry ``PAD_COORD`` and are masked."""
    rng0, dirs = log["range"], log["dirs"]
    ok = (rng0 >= MIN_RANGE) & (rng0 <= MAX_RANGE)
    r = rng0 + noise * torch.randn(rng0.shape, generator=generator,
                                   dtype=rng0.dtype, device=rng0.device)
    c, s = math.cos(yaw), math.sin(yaw)
    d = torch.stack([c * dirs[:, 0] - s * dirs[:, 1],
                     s * dirs[:, 0] + c * dirs[:, 1], dirs[:, 2]], -1)
    pts = d[None] * torch.where(ok, r, torch.zeros_like(r))[..., None]
    inten = 0.25 * log["surface"] + 0.2 * (1.0 - torch.clamp(
        r, max=MAX_RANGE) / MAX_RANGE)
    xyz = torch.where(ok[..., None], pts, torch.full_like(pts, PAD_COORD))
    xyzi = torch.cat([xyz, torch.where(ok, inten, 0.0)[..., None]], -1)
    return xyzi.to(torch.float32), ok

