"""Plain LOAM feature odometry for the reference, as the reference node
``loam_mapping_node.cpp`` (TASLO) runs it on one scan a callback, after
LOAM (Zhang & Singh, RSS 2014) in its A-LOAM and F-LOAM forms.

A scan's points, in order:

- kept when their range lies strictly between ``min_range`` and
  ``max_range``; each gets a ring from its elevation (rounded to the
  nearest of ``n_rings`` rings spread evenly over the vertical field of
  view) and is sorted by ring, then azimuth (``:1040-1088``);
- the curvature of each sorted point is the squared norm of the sum of
  its 10 neighbours (5 each side) minus 10 times itself, defined where all
  11 points are kept and on one ring (``:768-801``);
- each ring of at least ``adaptive_min_points`` defined curvatures has
  its own gates (F-LOAM, ``:744-766``): an edge needs a curvature above
  the larger of ``edge_threshold`` and half the ring's 90th percentile,
  a surface point one below the larger of ``surf_threshold`` and twice
  its 10th percentile (the percentiles are the sorted curvatures at
  indices ``9 cnt // 10`` and ``cnt // 10``);
- each ring splits into ``n_sectors`` azimuth sectors; a sector gives its
  ``edge_per_sector`` sharpest edges and ``surf_per_sector`` flattest
  surface points (ties to the earlier point), and the scan keeps the
  first ``max_edge_features`` and ``max_surf_features`` picks in sorted
  order.

The pose, scan to map (``:1111-1193``, ``:1225-1421``):
``optimization_iterations`` Gauss-Newton iterations on the features moved
into the world. An edge pairs with its ``nn_k`` nearest edge-map points,
a surface point with its nearest surface-map points; the neighbourhood
counts when the farthest lies between 0.1 m and ``sqrt(max_nn_sqdist)``.
Its scatter's eigenvalues l0 <= l1 <= l2 make it a line when l2 >= 3 l0
(the residual is the distance to the line through the centroid along
l2's eigenvector) and a plane when l0 <= 0.02 l2 (the signed distance to
the plane through the centroid normal to l0's eigenvector, turned away
from the origin); a residual counts up to ``max_corr_dist`` and weighs
0.1 / d beyond 0.1 m. A step solves (J'WJ + 1000 ``system_noise`` I) dx =
-J'Wr, with the rotation perturbed on the right, when at least 50 factors
count and the step is finite; at every 4th iteration from the first, a
step shorter than 1e-6 ends the loop (``:1197-1211``).

Between scans (``predictMotion``, ``:630-656``; keyframes, ``:1626+``):
the pose is predicted at constant velocity, with a nudge of 5 cm forward
and ``(frame % 3 - 1)`` cm to the left after more than
``forced_motion_frames`` near-static frames (moves under 2 cm); a scan is
a keyframe when it lies more than ``keyframe_dist`` or ``keyframe_angle``
from the last keyframe, or its index is a multiple of
``keyframe_interval``; a keyframe's features join the maps, which are
refiltered through the voxel grid (``reference/voxel.py``) at
``map_leaf_edge`` and ``map_leaf_surf``, keeping the first
``map_capacity_edge`` and ``map_capacity_surf`` voxels. The first scan's
features make the maps at the identity.

Plain torch in any float dtype, with no matrix product (sums of
elementwise products), so no precision setting changes a result; TF32
is off while it runs all the same. k-NN is an exact sort of squared
distances taken as sums of squared differences; eigenpairs come from
``torch.linalg.eigh``, solves from ``torch.linalg.solve``. torch has
neither for bfloat16, so a bfloat16 run solves them in float32 and
rounds back. It departs from the node in nothing beyond the precision.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple

import torch

from portbench.reference import voxel


class Settings(NamedTuple):
    n_rings: int
    vertical_fov_deg: tuple
    n_sectors: int
    edge_per_sector: int
    surf_per_sector: int
    edge_threshold: float
    surf_threshold: float
    adaptive_thresholds: bool
    adaptive_min_points: int
    max_edge_features: int
    max_surf_features: int
    map_capacity_edge: int
    map_capacity_surf: int
    map_leaf_edge: float
    map_leaf_surf: float
    nn_k: int
    max_nn_sqdist: float
    optimization_iterations: int
    system_noise: float
    max_corr_dist: float
    keyframe_dist: float
    keyframe_angle: float
    keyframe_interval: int
    forced_motion_frames: int
    min_range: float
    max_range: float


class State(NamedTuple):
    """What a step needs of the scans before it: the maps (valid points
    only, world frame), the previous pose, the motion since the one
    before, the last keyframe's pose, the near-static frame count and the
    last scan's index."""

    edge_map: torch.Tensor  # [me, 3]
    surf_map: torch.Tensor  # [ms, 3]
    q_prev: torch.Tensor  # [4] (w, x, y, z)
    t_prev: torch.Tensor  # [3]
    q_delta: torch.Tensor
    t_delta: torch.Tensor
    last_kf_q: torch.Tensor
    last_kf_t: torch.Tensor
    static_frames: int
    frame: int


class Step(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    is_kf: bool
    features: int  # edge plus surface picks


@contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _hi(x):
    return x.float() if x.dtype == torch.bfloat16 else x


# -- quaternions (w, x, y, z) -------------------------------------------


def q_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw])


def q_conj(q):
    return torch.stack([q[0], -q[1], -q[2], -q[3]])


def q_unit(q):
    return q / torch.sqrt((q * q).sum())


def q_rot(q):
    """The rotation matrix of a unit quaternion."""
    w, x, y, z = q
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)])])


def apply(R, t, p):
    """``R p + t`` of points ``p [n, 3]`` as elementwise products."""
    return (p[:, 0:1] * R[:, 0] + p[:, 1:2] * R[:, 1] + p[:, 2:3] * R[:, 2]
            + t)


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


# -- features ---------------------------------------------------------------


def features(xyz: torch.Tensor, mask: torch.Tensor, s: Settings):
    """The edge and surface picks ``([fe, 3], [fs, 3])`` of one scan's
    points ``xyz [n, 3]`` (``mask``: the sensor's valid returns)."""
    dt, dev = xyz.dtype, xyz.device
    x, y, z = xyz.unbind(1)
    r = torch.sqrt(x * x + y * y + z * z)
    keep = mask & (r > s.min_range) & (r < s.max_range)
    lo, hi = s.vertical_fov_deg
    elev = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    ring = torch.round((elev - lo) / (hi - lo) * (s.n_rings - 1)).clamp(
        0, s.n_rings - 1).long()
    azim = torch.atan2(y, x)
    # Ring, then azimuth; the dropped points go last.
    key = torch.where(keep, ring.to(dt) * 8.0
                      + (azim + math.pi) / (2 * math.pi) * 7.9,
                      torch.full_like(azim, 1e6))
    order = torch.argsort(key, stable=True)
    p, ring, keep = xyz[order], ring[order], keep[order]
    n = len(p)

    # The 11-point stencil; a window that leaves the array is undefined.
    pad = 5
    pp = torch.cat([p.new_zeros(pad, 3), p, p.new_zeros(pad, 3)])
    kk = torch.cat([keep.new_zeros(pad), keep, keep.new_zeros(pad)])
    rr = torch.cat([ring.new_full((pad,), -1), ring, ring.new_full((pad,),
                                                                   -1)])
    acc = -10.0 * p
    defined = keep.clone()
    for off in range(1, pad + 1):
        acc = acc + pp[pad + off:pad + off + n] + pp[pad - off:pad - off + n]
        for sl in (slice(pad + off, pad + off + n),
                   slice(pad - off, pad - off + n)):
            defined &= kk[sl] & (rr[sl] == ring)
    curv = (acc * acc).sum(1)

    edge_gate = torch.full((n,), s.edge_threshold, dtype=dt, device=dev)
    surf_gate = torch.full((n,), s.surf_threshold, dtype=dt, device=dev)
    if s.adaptive_thresholds:
        for k in range(s.n_rings):
            c = torch.sort(curv[defined & (ring == k)]).values
            if len(c) < s.adaptive_min_points:
                continue
            on = ring == k
            edge_gate[on] = torch.clamp(c[len(c) * 9 // 10] * 0.5,
                                        min=s.edge_threshold)
            surf_gate[on] = torch.clamp(c[len(c) // 10] * 2.0,
                                        min=s.surf_threshold)

    sector = ((torch.atan2(p[:, 1], p[:, 0]) + math.pi) / (2 * math.pi)
              * s.n_sectors).long().clamp(0, s.n_sectors - 1)
    seg = ring * s.n_sectors + sector

    def pick(score, gate, per_sector, cap):
        # Within each (ring, sector): the highest scores first, the
        # earlier point first among equal ones.
        idx = torch.nonzero(gate)[:, 0]
        o = torch.argsort(-score[idx], stable=True)
        idx = idx[o]
        idx = idx[torch.argsort(seg[idx], stable=True)]
        sg = seg[idx]
        first = torch.ones_like(sg, dtype=torch.bool)
        first[1:] = sg[1:] != sg[:-1]
        start = torch.cummax(torch.where(
            first, torch.arange(len(sg), device=dev), 0), 0).values
        rank = torch.arange(len(sg), device=dev) - start
        chosen = torch.sort(idx[rank < per_sector]).values[:cap]
        return p[chosen]

    edges = pick(curv, defined & (curv > edge_gate), s.edge_per_sector,
                 s.max_edge_features)
    surfs = pick(-curv, defined & (curv < surf_gate), s.surf_per_sector,
                 s.max_surf_features)
    return edges, surfs


# -- scan to map ------------------------------------------------------------


def _neighbours(pts, ref, s: Settings, chunk=256):
    """For each point: whether its ``nn_k`` exact nearest map points make
    a neighbourhood, their centroid, and the eigenpairs of their scatter
    (ascending)."""
    k = s.nn_k
    if len(ref) < k:
        z = pts.new_zeros(len(pts), 3)
        return (torch.zeros(len(pts), dtype=torch.bool, device=pts.device),
                z, pts.new_ones(len(pts), 3),
                torch.eye(3, dtype=pts.dtype, device=pts.device).expand(
                    len(pts), 3, 3))
    idx, far = [], []
    for a in range(0, len(pts), chunk):
        d = pts[a:a + chunk, None, :] - ref[None, :, :]
        d = (d * d).sum(-1)
        o = torch.argsort(d, dim=1, stable=True)[:, :k]
        idx.append(o)
        far.append(torch.gather(d, 1, o[:, -1:])[:, 0])
    idx, far = torch.cat(idx), torch.cat(far)
    nb = ref[idx]  # [F, k, 3]
    ok = (far >= 0.01) & (far <= s.max_nn_sqdist)
    centroid = nb.mean(1)
    c = nb - centroid[:, None, :]
    cov = (c[:, :, :, None] * c[:, :, None, :]).sum(1)
    evals, evecs = torch.linalg.eigh(_hi(cov))
    return ok, centroid, evals.to(pts.dtype), evecs.to(pts.dtype)


def _normal_equations(J, r, w, ok):
    w = torch.where(ok, w, torch.zeros_like(w))
    Jw = J * w[:, None]
    A = (Jw[:, :, None] * J[:, None, :]).sum(0)
    return A, (Jw * r[:, None]).sum(0), int(ok.sum())


def _edge_factors(local, R, t, edge_map, s: Settings):
    world = apply(R, t, local)
    ok, centroid, ev, vec = _neighbours(world, edge_map, s)
    u = vec[:, :, 2]  # the line's direction
    dp = world - centroid
    foot = centroid + u * (u * dp).sum(1, keepdim=True)
    off = world - foot
    d = torch.sqrt((off * off).sum(1))
    ok = ok & (ev[:, 2] >= 3.0 * ev[:, 0]) & (d <= s.max_corr_dist) & (
        d > 1e-9)
    dsafe = torch.clamp(d, min=1e-9)
    unit = off / dsafe[:, None]
    J = torch.cat([unit, _cross(apply(R, torch.zeros_like(t), local), unit)],
                  1)
    w = torch.where(d > 0.1, 0.1 / dsafe, torch.ones_like(d))
    return _normal_equations(J, d, w, ok)


def _surf_factors(local, R, t, surf_map, s: Settings):
    world = apply(R, t, local)
    ok, centroid, ev, vec = _neighbours(world, surf_map, s)
    nrm = vec[:, :, 0]
    nrm = torch.where(((nrm * centroid).sum(1) < 0)[:, None], -nrm, nrm)
    d = (nrm * world).sum(1) - (nrm * centroid).sum(1)
    ok = ok & (ev[:, 0] <= 0.02 * ev[:, 2]) & (d.abs() <= s.max_corr_dist)
    J = torch.cat([nrm, _cross(apply(R, torch.zeros_like(t), local), nrm)],
                  1)
    ad = d.abs()
    w = torch.where(ad > 0.1, 0.1 / torch.clamp(ad, min=1e-9),
                    torch.ones_like(ad))
    return _normal_equations(J, d, w, ok)


def solve_pose(edges, surfs, edge_map, surf_map, q, t, s: Settings):
    """The Gauss-Newton pose of the picks against the maps from ``(q,
    t)``."""
    damp = torch.eye(6, dtype=q.dtype, device=q.device) * (
        s.system_noise * 1000.0)
    for it in range(s.optimization_iterations):
        R = q_rot(q)
        A1, b1, n1 = _edge_factors(edges, R, t, edge_map, s)
        A2, b2, n2 = _surf_factors(surfs, R, t, surf_map, s)
        A, b = A1 + A2 + damp, b1 + b2
        dx = torch.linalg.solve_ex(_hi(A), -_hi(b))[0].to(q.dtype)
        if n1 + n2 < 50 or not bool(torch.isfinite(dx).all()):
            continue
        t = t + dx[:3]
        q = q_unit(q_mul(q, torch.cat([q.new_ones(1), dx[3:] / 2])))
        if it % 4 == 0 and float(torch.sqrt((dx * dx).sum())) < 1e-6:
            break
    return q, t


# -- the odometry -----------------------------------------------------------


def _merge(the_map, local, R, t, leaf, cap):
    pts = torch.cat([the_map, apply(R, t, local)])
    if len(pts) == 0:
        return pts
    xyzi = torch.cat([pts, torch.zeros_like(pts[:, :1])], 1)
    ds = voxel.downsample(xyzi, torch.ones(len(pts), dtype=torch.bool,
                                           device=pts.device), leaf,
                          pts.dtype)
    return ds[:cap, :3]


def init(xyz, mask, s: Settings, dtype=torch.float64):
    """The state after the first scan ``xyz [n, 3]`` and its feature
    count."""
    e, f = features(xyz.to(dtype), mask, s)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=xyz.device)
    t = q.new_zeros(3)
    R = q_rot(q)
    emap = _merge(q.new_zeros(0, 3), e, R, t, s.map_leaf_edge,
                  s.map_capacity_edge)
    smap = _merge(q.new_zeros(0, 3), f, R, t, s.map_leaf_surf,
                  s.map_capacity_surf)
    return State(emap, smap, q, t, q, t, q, t, 0, 0), len(e) + len(f)


def step(state: State, xyz, mask, s: Settings):
    """One further scan from ``state`` (in the state's dtype): the new
    state and the step's ``Step``."""
    st = state
    dt, dev = st.q_prev.dtype, st.q_prev.device
    frame = st.frame + 1
    e, f = features(xyz.to(dt), mask, s)
    move = st.t_delta
    if (st.static_frames > s.forced_motion_frames
            and float(torch.sqrt((move * move).sum())) < 0.02):
        move = move + torch.tensor([0.05, 0.01 * (frame % 3 - 1), 0.0],
                                   dtype=dt, device=dev)
    Rp = q_rot(st.q_prev)
    q0 = q_unit(q_mul(st.q_prev, st.q_delta))
    t0 = st.t_prev + (Rp * move).sum(1)
    q, t = solve_pose(e, f, st.edge_map, st.surf_map, q0, t0, s)
    q_delta = q_mul(q_conj(st.q_prev), q)
    t_delta = (Rp * (t - st.t_prev)[:, None]).sum(0)  # R^T (t - t_prev)
    still = float(torch.sqrt((t_delta * t_delta).sum())) < 0.02
    dq = q_mul(q_conj(st.last_kf_q), q)
    angle = 2.0 * math.acos(min(max(abs(float(dq[0])), 0.0), 1.0))
    gap = t - st.last_kf_t
    dist = float(torch.sqrt((gap * gap).sum()))
    is_kf = (dist > s.keyframe_dist or angle > s.keyframe_angle
             or frame % s.keyframe_interval == 0)
    emap, smap, kq, kt = st.edge_map, st.surf_map, st.last_kf_q, st.last_kf_t
    if is_kf:
        R = q_rot(q)
        emap = _merge(emap, e, R, t, s.map_leaf_edge, s.map_capacity_edge)
        smap = _merge(smap, f, R, t, s.map_leaf_surf, s.map_capacity_surf)
        kq, kt = q, t
    new = State(emap, smap, q, t, q_delta, t_delta, kq, kt,
                st.static_frames + 1 if still else 0, frame)
    return new, Step(q, t, is_kf, len(e) + len(f))


def run_log(xyz, mask, s: Settings, dtype=torch.float64):
    """The whole log ``xyz [S, n, 3]`` as one chain: the state before each
    further scan, each further scan's ``Step``, and the last state."""
    with no_tf32():
        state, _ = init(xyz[0], mask[0], s, dtype)
        before, steps = [], []
        for i in range(1, len(xyz)):
            before.append(state)
            state, out = step(state, xyz[i], mask[i], s)
            steps.append(out)
    return before, steps, state


def steps_from(states, xyz, mask, s: Settings):
    """Scan ``i + 1``'s ``Step`` from ``states[i]`` for each given state
    (each in its own dtype)."""
    with no_tf32():
        return [step(st, xyz[i + 1], mask[i + 1], s)[1]
                for i, st in enumerate(states)]
