"""Spinning-LiDAR scans of a generated street scene (numpy only).

A vectorised ray cast: the sensor rides 1.8 m above a ground plane along a
street lined with box buildings of varying setback and height, broken by
cross streets, with poles and car-sized boxes at the kerbs. That gives
structure in x, y and z, so no direction of the registration is
degenerate. Every scene, trajectory and noise draw comes from one
``numpy.random.Generator(seed)``, so the CPU tests, the JAX package and the
GPU smoke run can share the data.

Returns ``xyzi [S, R*A, 4] float32`` in the sensor frame (intensity from
the surface kind and range), ``mask [S, R*A]`` (rays that miss, or fall
outside the 2-80 m range, carry ``PAD_COORD`` and are masked) and the
ground-truth world-from-sensor poses ``[S, 4, 4] float64``.
"""

from __future__ import annotations

import numpy as np

PAD_COORD = 1.0e9  # equal to core.pointcloud.PAD_COORD; kept numpy-only here
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
            # Facade columns: structure along the street, so that motion
            # along it is observable from the walls and not only from
            # building ends and poles.
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
    """World-from-sensor poses: ``step`` metres along the heading per scan,
    yawing by ``yaw_rate`` rad per scan, with body roll and pitch drawn
    from N(0, ``tilt_deg``) per scan. Without the tilt every scan would
    sample the flat ground on the same rings in the sensor frame, which
    pulls scan-to-scan registration towards zero motion."""
    poses = np.tile(np.eye(4), (num_scans, 1, 1))
    x = y = yaw = 0.0
    for k in range(num_scans):
        c, s = np.cos(yaw), np.sin(yaw)
        roll, pitch = rng.normal(0.0, np.deg2rad(tilt_deg), 2)
        cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch)
        poses[k, :3, :3] = (
            np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            @ np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
            @ np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]]))
        poses[k, :3, 3] = [x, y, SENSOR_HEIGHT]
        x += step * c
        y += step * s
        yaw += yaw_rate
    return poses


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _azimuth_span(ang):
    """Centre and half-width of a set of angles ``[..., k]`` spanning less
    than pi."""
    ref = ang[..., :1]
    d = _wrap(ang - ref)
    lo, hi = d.min(-1), d.max(-1)
    return _wrap(ref[..., 0] + 0.5 * (lo + hi)), 0.5 * (hi - lo)


def _ray_ranges(origin, dirs, boxes, chunk=2048):
    """First hit distance of each world ray (inf on a miss) and the kind of
    surface hit (0 ground, else box index + 1).

    Rays are processed in azimuth order, ``chunk`` at a time, against only
    the boxes whose azimuth span from the sensor overlaps the chunk's.
    """
    safe = np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    best = np.where(dirs[:, 2] < 0, -origin[2] / safe[:, 2], np.inf)
    kind = np.zeros(len(dirs), np.int64)
    # Boxes out of range of this sensor position cannot be hit.
    near = np.flatnonzero(np.linalg.norm(
        np.maximum(np.maximum(boxes[:, 0] - origin, origin - boxes[:, 1]),
                   0.0), axis=1) <= MAX_RANGE)
    lo, hi = boxes[near, 0] - origin, boxes[near, 1] - origin  # [B, 3]
    cx = np.stack([lo[:, 0], lo[:, 0], hi[:, 0], hi[:, 0]], 1)
    cy = np.stack([lo[:, 1], hi[:, 1], lo[:, 1], hi[:, 1]], 1)
    box_mid, box_half = _azimuth_span(np.arctan2(cy, cx))
    # The sensor never stands inside a box footprint, so spans are < pi.
    ray_az = np.arctan2(dirs[:, 1], dirs[:, 0])
    order = np.argsort(ray_az, kind="stable")
    for s in range(0, len(dirs), chunk):
        idx = order[s:s + chunk]
        mid, half = _azimuth_span(ray_az[idx][None])
        cand = np.flatnonzero(np.abs(_wrap(box_mid - mid[0]))
                              <= box_half + half[0] + 1e-3)
        if not len(cand):
            continue
        inv = 1.0 / safe[idx, None, :]  # [c, 1, 3]
        t1, t2 = lo[cand][None] * inv, hi[cand][None] * inv
        t_near = np.minimum(t1, t2).max(-1)
        t_far = np.maximum(t1, t2).min(-1)
        t_hit = np.where((t_far >= t_near) & (t_near > 0), t_near, np.inf)
        j = t_hit.argmin(1)
        t_min = t_hit[np.arange(len(j)), j]
        closer = t_min < best[idx]
        best[idx] = np.where(closer, t_min, best[idx])
        kind[idx] = np.where(closer, near[cand[j]] + 1, kind[idx])
    return best, kind


def spinning_lidar_scans(seed: int, num_scans: int, rings: int = 64,
                         azimuths: int = 4096, fov_deg=(-24.8, 2.0),
                         noise=0.015, step=0.3, yaw_rate=0.004,
                         tilt_deg=0.5):
    """Scans of ``rings x azimuths`` rays along :func:`trajectory`.

    Returns ``(xyzi [S, rings*azimuths, 4] f32, mask [S, rings*azimuths],
    poses [S, 4, 4] f64)``.
    """
    rng = np.random.default_rng(seed)
    boxes, box_kind = street_scene(rng)
    poses = trajectory(rng, num_scans, step, yaw_rate, tilt_deg)
    elev = np.deg2rad(np.linspace(fov_deg[0], fov_deg[1], rings))
    azim = np.linspace(0.0, 2 * np.pi, azimuths, endpoint=False)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    dirs = np.stack([ce * np.cos(azim), ce * np.sin(azim),
                     np.broadcast_to(se, (rings, azimuths))], -1
                    ).reshape(-1, 3)  # sensor frame
    surface = np.concatenate([[0], box_kind])  # ground = 0
    n = rings * azimuths
    xyzi = np.empty((num_scans, n, 4), np.float32)
    mask = np.empty((num_scans, n), bool)
    for k in range(num_scans):
        R, t = poses[k, :3, :3], poses[k, :3, 3]
        rng_k, kind = _ray_ranges(t, dirs @ R.T, boxes)
        ok = (rng_k >= MIN_RANGE) & (rng_k <= MAX_RANGE)
        r = rng_k + rng.normal(0.0, noise, n)
        pts = dirs * np.where(ok, r, 0.0)[:, None]
        inten = 0.25 * surface[kind] + 0.2 * (1.0 - np.minimum(r, MAX_RANGE)
                                              / MAX_RANGE)
        xyzi[k, :, :3] = np.where(ok[:, None], pts, PAD_COORD)
        xyzi[k, :, 3] = np.where(ok, inten, 0.0)
        mask[k] = ok
    return xyzi, mask, poses
