"""Ground-truth trajectory generators (port of
``toyslam_tpu/sim/trajectories.py``).

Circular motion with tangent heading (``uwb_imu_sim_node.cpp:107-199``),
the helix and line modes (``uwb_node.cpp:158-189``), a figure-8
(``user_teleop.cpp:33-76``) and a stadium street circuit
(``RangingRC.cpp:1014-1131``). Deterministic: each takes sample times
``t [T]`` (a tensor, whose dtype and device the outputs share) and returns
dense arrays for the simulators and for errors against estimates.
"""

from __future__ import annotations

import math

import torch

from toyslam_tpu_torch.core import se3


def _yaw_quat(yaw):
    """Quaternions [T, 4] of rotations by ``yaw`` about +z."""
    axis = torch.zeros(yaw.shape + (3,), dtype=yaw.dtype, device=yaw.device)
    axis[..., 2] = 1.0
    return se3.quat_from_axis_angle(axis, yaw)


def circle(t, radius=3.0, omega=0.1, z=1.0):
    """Circular motion with tangent yaw (``uwb_imu_sim_node.cpp:116-137,
    203``): dict of pos, vel, acc [T, 3], yaw [T], quat [T, 4] and the
    body rates gyro [T, 3]."""
    theta = omega * t
    zero = torch.zeros_like(theta)
    pos = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta),
                       torch.full_like(theta, z)], -1)
    vel = torch.stack([-radius * omega * torch.sin(theta),
                       radius * omega * torch.cos(theta), zero], -1)
    acc = torch.stack([-radius * omega**2 * torch.cos(theta),
                       -radius * omega**2 * torch.sin(theta), zero], -1)
    yaw = theta + math.pi / 2  # tangent to the circle
    return {"pos": pos, "vel": vel, "acc": acc, "yaw": yaw,
            "quat": _yaw_quat(yaw),
            "gyro": torch.stack([zero, zero, torch.full_like(yaw, omega)],
                                -1)}


def helix(t, radius=3.0, omega=0.1, z0=1.0, climb_rate=0.05):
    out = circle(t, radius, omega, 0.0)
    out["pos"][..., 2] = z0 + climb_rate * t
    out["vel"][..., 2] = climb_rate
    return out


def figure8(t, scale=10.0, omega=0.1, z=1.0):
    """Lemniscate (``user_teleop.cpp:33-76``) with analytic acceleration,
    tangent-yaw attitude and the matching body yaw rate."""
    a = omega * t
    zero = torch.zeros_like(a)
    pos = torch.stack([scale * torch.sin(a),
                       scale * torch.sin(a) * torch.cos(a),
                       torch.full_like(a, z)], -1)
    # y = (scale / 2) sin(2a): the double-angle form for the derivatives
    vel = torch.stack([scale * omega * torch.cos(a),
                       scale * omega * torch.cos(2.0 * a), zero], -1)
    acc = torch.stack([-scale * omega**2 * torch.sin(a),
                       -2.0 * scale * omega**2 * torch.sin(2.0 * a), zero],
                      -1)
    yaw = torch.atan2(vel[..., 1], vel[..., 0])
    sp2 = vel[..., 0] ** 2 + vel[..., 1] ** 2
    yaw_rate = (vel[..., 0] * acc[..., 1] - vel[..., 1] * acc[..., 0]) / (
        sp2.clamp(min=1e-12))
    return {"pos": pos, "vel": vel, "acc": acc, "yaw": yaw,
            "quat": _yaw_quat(yaw),
            "gyro": torch.stack([zero, zero, yaw_rate], -1)}


def circuit(t, length=40.0, width=14.0, speed=2.0, z=1.0):
    """A closed stadium street circuit at constant speed
    (``RangingRC.cpp:1014-1131``): bottom straight, right half-turn, top
    straight, left half-turn of radius ``width / 2``, counterclockwise by
    arc length. The same fields as :func:`circle`."""
    r = width / 2.0
    Lx = max(length - width, 1e-3)  # straight-segment length
    per = 2.0 * Lx + 2.0 * math.pi * r
    s = torch.remainder(speed * t, per)
    s1 = Lx
    s2 = s1 + math.pi * r
    s3 = s2 + Lx

    a_r = (s - s1) / r - math.pi / 2.0
    a_l = (s - s3) / r + math.pi / 2.0
    segs = [  # (xy, yaw) of each segment's formula at every s
        (torch.stack([s - Lx / 2.0, torch.full_like(s, -r)], -1),
         torch.zeros_like(s)),
        (torch.stack([Lx / 2.0 + r * torch.cos(a_r), r * torch.sin(a_r)], -1),
         a_r + math.pi / 2.0),
        (torch.stack([Lx / 2.0 - (s - s2), torch.full_like(s, r)], -1),
         torch.full_like(s, math.pi)),
        (torch.stack([-Lx / 2.0 + r * torch.cos(a_l), r * torch.sin(a_l)],
                     -1), a_l + math.pi / 2.0),
    ]
    in_b = s < s1
    in_r = (s >= s1) & (s < s2)
    in_t = (s >= s2) & (s < s3)
    xy, yaw = segs[3]
    for cond, (xy_k, yaw_k) in ((in_t, segs[2]), (in_r, segs[1]),
                                (in_b, segs[0])):
        xy = torch.where(cond[..., None], xy_k, xy)
        yaw = torch.where(cond, yaw_k, yaw)
    zero = torch.zeros_like(yaw)
    pos = torch.cat([xy, torch.full_like(xy[..., :1], z)], -1)
    vel = torch.stack([speed * torch.cos(yaw), speed * torch.sin(yaw), zero],
                      -1)
    # Centripetal acceleration on the turns, zero on the straights
    yaw_rate = torch.where(in_b | in_t, zero, zero + speed / r)
    a_mag = speed * yaw_rate
    acc = torch.stack([-a_mag * torch.sin(yaw), a_mag * torch.cos(yaw), zero],
                      -1)
    return {"pos": pos, "vel": vel, "acc": acc, "yaw": yaw,
            "quat": _yaw_quat(yaw),
            "gyro": torch.stack([zero, zero, yaw_rate], -1)}


def line(t, speed=0.5, direction=(1.0, 0.0, 0.0), z=1.0):
    d = torch.tensor(direction, dtype=t.dtype, device=t.device)
    d = d / torch.linalg.norm(d)
    pos = t[..., None] * speed * d
    pos[..., 2] += z
    return {"pos": pos, "vel": (speed * d).expand(pos.shape)}
