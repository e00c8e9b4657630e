"""LOAM-style feature odometry (port of ``toyslam_tpu/pipelines/loam.py``).

After ``lidar_subscriber/src/loam_mapping_node.cpp``: points sorted once
by a (ring, azimuth) key, the 11-point curvature stencil along the sorted
array (``:768-801``), FLOAM's per-ring percentile thresholds
(``:744-766``), sharp and flat picks as per-(ring, sector) quotas of
segment argmax rounds, 5-NN point-to-line and point-to-plane factors with
the reference's eigenvalue gates and 0.1/d weights (``:1225-1421``), an
LM-damped Gauss-Newton on the pose (``:1111-1193``), and keyframed
bounded maps refiltered through the voxel downsample (``:1626+``).

Every function runs where its tensors lie and makes no host
synchronisation: JAX's ``lax.while_loop`` is the fixed iteration count
with a device-side ``done`` flag that freezes the pose once it converged,
its ``lax.scan`` over scans a host loop, the keyframe choice a
``torch.where``. ``_knn`` ranks with ``torch.topk``, the exact
counterpart of ``approx_max_k`` on the JAX package's CPU (its fallback
there is exact; on a TPU it ranked at a recall of 0.95).

The streaming form takes one scan a call, as the reference node's
``TASLO::processCloud`` does: ``loam_init`` on the first scan, then
``loam_step`` on each further one, carrying a ``LoamState``;
``loam_odometry`` is that loop over a stack of scans. A step's spans
(``utils/profiling.span``): ``loam.step`` holding ``loam.extract``,
``loam.optimize`` (two ``loam.factors`` and one ``loam.solve`` an
iteration) and ``loam.update_maps``; ``loam.init`` holds the first scan's
extract and map update.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.core.pointcloud import PointCloud, voxel_downsample
from toyslam_tpu_torch.ops.eigh3 import eigh3_soa
from toyslam_tpu_torch.utils.profiling import span

_BIG = 1.0e9
_INT_MAX = 2**31 - 1


class LoamConfig(NamedTuple):
    n_rings: int = 32  # HDL-32E (loam_mapping_node.cpp:44 region)
    vertical_fov_deg: tuple = (-30.67, 10.67)  # HDL-32E
    n_sectors: int = 6  # feature spread sectors per ring
    edge_per_sector: int = 2
    surf_per_sector: int = 4
    edge_threshold: float = 1.0  # curvature gates (node params)
    surf_threshold: float = 0.1
    # FLOAM's adaptive per-line thresholds (``:744-766``): edge = max(base,
    # p90 / 2), surf = max(base, 2 p10), for rings of >= 20 valid points.
    adaptive_thresholds: bool = True
    adaptive_min_points: int = 20
    max_edge_features: int = 384
    max_surf_features: int = 768
    map_capacity_edge: int = 4096
    map_capacity_surf: int = 8192
    map_leaf_edge: float = 0.4
    map_leaf_surf: float = 0.8
    nn_k: int = 5
    # 5th-neighbour gates: not degenerate-close (sq dist >= 0.01,
    # ``:1239,:1337``), not too far to define a line or plane.
    max_nn_sqdist: float = 2.0
    optimization_iterations: int = 10
    system_noise: float = 1e-4  # LM damping base (A += noise*1000, :1160)
    max_corr_dist: float = 1.0  # residual gate (:1288,:1390)
    keyframe_dist: float = 1.0  # keyframing thresholds (:1626+)
    keyframe_angle: float = 0.15
    # Every Nth frame is a keyframe (``keyframe_time_interval``, ``:1636``)
    keyframe_interval: int = 10
    # Forced-motion injection (``predictMotion``, ``:630-656``) after N
    # consecutive near-static frames.
    forced_motion_frames: int = 5
    min_range: float = 2.0
    max_range: float = 80.0  # sensor range (:44)


class FeatureScan(NamedTuple):
    """Extracted features, fixed-shape; unpicked rows hold 1e9."""

    edge_xyz: torch.Tensor  # [Fe, 3]
    edge_mask: torch.Tensor  # [Fe]
    surf_xyz: torch.Tensor  # [Fs, 3]
    surf_mask: torch.Tensor  # [Fs]


class OrganizedScan(NamedTuple):
    """The sorted scan and its per-point curvature and gates
    (``tests/golden_loam.py`` holds these against an f64 line-by-line port
    of the reference's extraction)."""

    xyz: torch.Tensor  # [n, 3] sorted ring-major, azimuth-minor
    ring: torch.Tensor  # [n] int32
    ok: torch.Tensor  # [n] range- and mask-valid
    curvature: torch.Tensor  # [n] 11-point stencil value
    cur_ok: torch.Tensor  # [n] stencil window valid and in one ring
    edge_thr: torch.Tensor  # [n] the point's ring's edge gate
    surf_thr: torch.Tensor  # [n] the point's ring's surf gate


def _roll(x, shift):
    return torch.roll(x, shift, 0)


def organize_scan(cloud: PointCloud, cfg: LoamConfig) -> OrganizedScan:
    """Ring/azimuth sort, 11-point curvature and adaptive thresholds
    (``organizeByScanAngles`` ``:1040-1088``, ``:744-801``)."""
    dtype = cloud.xyzi.dtype
    xyz = cloud.xyzi[:, :3]
    x, y, z = xyz.unbind(-1)
    rng = torch.sqrt(x * x + y * y + z * z)
    range_ok = (rng > cfg.min_range) & (rng < cfg.max_range) & cloud.mask

    # Ring from the elevation angle (:1040-1088)
    elev = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    lo, hi = cfg.vertical_fov_deg
    ring = torch.clamp(torch.round((elev - lo) / (hi - lo)
                                   * (cfg.n_rings - 1)),
                       0, cfg.n_rings - 1).to(torch.int32)
    azim = torch.atan2(y, x)

    # Ring-major, azimuth-minor; invalid lanes sort last. JAX's argsort is
    # stable, and so is this one.
    key = torch.where(range_ok,
                      ring.to(dtype) * 8.0 + (azim + math.pi)
                      / (2 * math.pi) * 7.9,
                      torch.full_like(azim, 1e6))
    order = torch.argsort(key, stable=True)
    xs = xyz[order]
    ring_s = ring[order]
    ok_s = range_ok[order]

    # 11-point stencil (:768-801), masked where the window leaves the ring
    # or touches an invalid point.
    n = xs.shape[0]
    acc = -10.0 * xs
    ok_win = ok_s
    same_ring = torch.ones_like(ok_s)
    for off in range(1, 6):
        acc = acc + _roll(xs, off) + _roll(xs, -off)
        ok_win = ok_win & _roll(ok_s, off) & _roll(ok_s, -off)
        same_ring = (same_ring & (_roll(ring_s, off) == ring_s)
                     & (_roll(ring_s, -off) == ring_s))
    curvature = torch.sum(acc * acc, -1)
    cur_ok = ok_win & same_ring

    if cfg.adaptive_thresholds:
        # p90 and p10 of each ring's valid curvatures from one sort keyed
        # (ring, curvature / (curvature + 1)), stable as JAX's lax.sort.
        zero = torch.zeros_like(curvature)
        curv_key = torch.where(cur_ok, curvature / (curvature + 1.0),
                               zero + 2.0)
        ring_key = torch.where(cur_ok, ring_s.to(dtype),
                               zero + (cfg.n_rings + 1.0))
        perm = torch.argsort(ring_key * 4.0 + curv_key, stable=True)
        curv_sorted = torch.where(cur_ok, curvature, zero)[perm]
        cnt = torch.zeros(cfg.n_rings, dtype=torch.int64,
                          device=xs.device).index_add_(
            0, ring_s.long(), cur_ok.long())
        start = torch.cumsum(cnt, 0) - cnt
        idx90 = torch.clamp(start + (cnt * 9) // 10, 0, n - 1)
        idx10 = torch.clamp(start + cnt // 10, 0, n - 1)
        p90 = curv_sorted[idx90]
        p10 = curv_sorted[idx10]
        enough = cnt >= cfg.adaptive_min_points
        base_e = torch.full_like(p90, cfg.edge_threshold)
        base_s = torch.full_like(p10, cfg.surf_threshold)
        edge_thr = torch.where(enough, torch.maximum(base_e, p90 * 0.5),
                               base_e)[ring_s.long()]
        surf_thr = torch.where(enough, torch.maximum(base_s, p10 * 2.0),
                               base_s)[ring_s.long()]
    else:
        edge_thr = torch.full((n,), cfg.edge_threshold, dtype=dtype,
                              device=xs.device)
        surf_thr = torch.full((n,), cfg.surf_threshold, dtype=dtype,
                              device=xs.device)

    return OrganizedScan(xyz=xs, ring=ring_s, ok=ok_s, curvature=curvature,
                         cur_ok=cur_ok, edge_thr=edge_thr, surf_thr=surf_thr)


def organize_and_extract(cloud: PointCloud, cfg: LoamConfig) -> FeatureScan:
    """Ring/azimuth sort -> curvature -> sector-quota feature picks."""
    org = organize_scan(cloud, cfg)
    xs, ring_s = org.xyz, org.ring
    n = xs.shape[0]
    dev = xs.device

    azim_s = torch.atan2(xs[:, 1], xs[:, 0])
    sector = torch.clamp(((azim_s + math.pi) / (2 * math.pi)
                          * cfg.n_sectors).to(torch.int32),
                         0, cfg.n_sectors - 1)
    seg = (ring_s * cfg.n_sectors + sector).long()  # [n] in [0, R*S)
    n_seg = cfg.n_rings * cfg.n_sectors
    idx_arr = torch.arange(n, dtype=torch.int64, device=dev)

    def pick_rounds(score, gate, rounds, cap):
        """Per-segment argmax ``rounds`` times -> (xyz [cap, 3], mask)."""
        score = torch.where(gate, score, torch.full_like(score, -_BIG))
        mask_all = torch.zeros(n, dtype=torch.bool, device=dev)
        for _ in range(rounds):
            # JAX's segment_max of an empty segment is -inf, its
            # segment_min INT32_MAX.
            seg_max = torch.full((n_seg,), -math.inf, dtype=score.dtype,
                                 device=dev).scatter_reduce(
                0, seg, score, "amax", include_self=False)
            is_max = (score == seg_max[seg]) & (score > -_BIG)
            # the lowest index of each segment's max wins
            cand = torch.where(is_max, idx_arr, n)
            seg_win = torch.full((n_seg,), _INT_MAX, dtype=torch.int64,
                                 device=dev).scatter_reduce(
                0, seg, cand, "amin", include_self=False)
            # Segments without a winner point at row n, a sink sliced off
            # (JAX drops the out-of-range writes).
            win = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill_(
                0, seg_win.clamp(max=n), True)[:n]
            mask_all = mask_all | win
            score = torch.where(win, torch.full_like(score, -_BIG), score)
        prio = torch.where(mask_all, idx_arr, n)
        order2 = torch.argsort(prio, stable=True)[:cap]
        sel_mask = mask_all[order2]
        sel_xyz = torch.where(sel_mask[:, None], xs[order2],
                              torch.full_like(xs[order2], _BIG))
        return sel_xyz, sel_mask

    curvature, cur_ok = org.curvature, org.cur_ok
    edge_xyz, edge_mask = pick_rounds(
        curvature, cur_ok & (curvature > org.edge_thr),
        cfg.edge_per_sector, cfg.max_edge_features)
    surf_xyz, surf_mask = pick_rounds(
        -curvature, cur_ok & (curvature < org.surf_thr),
        cfg.surf_per_sector, cfg.max_surf_features)
    return FeatureScan(edge_xyz, edge_mask, surf_xyz, surf_mask)


def _knn(query, query_mask, ref, ref_mask, k):
    """Brute-force k-NN: query [F, 3] vs ref [M, 3] -> (idx [F, k], squared
    distances [F, k] ascending, valid [F, k]). The distances are f32 (or
    f64) matrix products: a TF32 product would rank other neighbours."""
    d = ((query * query).sum(1)[:, None] - 2.0 * (query @ ref.T)
         + (ref * ref).sum(1)[None, :])
    d = torch.where(ref_mask[None, :], d, torch.full_like(d, _BIG))
    neg_d, idx = torch.topk(-d, k, dim=1, largest=True, sorted=True)
    sqd = torch.clamp(-neg_d, min=0.0)
    valid = (sqd < _BIG * 0.5) & query_mask[:, None]
    return idx, sqd, valid


def _neighbourhood(world_pts, mask, map_xyz, map_mask, cfg: LoamConfig):
    """The 5-NN of each point: (ok [F], centroid [F, 3], eigenvalues
    (l0, l1, l2), eigenvector components (9-tuple) of the neighbours'
    scatter)."""
    idx, sqd, valid = _knn(world_pts, mask, map_xyz, map_mask, cfg.nn_k)
    nn = map_xyz[idx]  # [F, k, 3]
    ok = (valid.all(1) & (sqd[:, -1] >= 0.01)
          & (sqd[:, -1] <= cfg.max_nn_sqdist))
    centroid = nn.mean(1)
    c = nn - centroid[:, None, :]
    cov = torch.einsum("fki,fkj->fij", c, c)
    evals, vec = eigh3_soa(cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                           cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2])
    return ok, centroid, evals, vec


def _normal_equations(J, dist, w, ok):
    """(A [6, 6], b [6], count) of the weighted factors."""
    w = w * ok.to(J.dtype)
    Jw = J * w[:, None]
    return Jw.T @ J, Jw.T @ dist, ok.sum()


def _accumulate_edge_factors(world_pts, mask, R_cur, local_pts, map_xyz,
                             map_mask, cfg: LoamConfig):
    """Point-to-line factors (``findEdgeFactorsALOAM``, ``:1225-1322``)
    reduced to (A [6, 6], b [6], count)."""
    ok, centroid, (l0, _l1, l2), vec = _neighbourhood(
        world_pts, mask, map_xyz, map_mask, cfg)
    is_line = l2 >= 3.0 * l0  # (:1269)
    line_dir = torch.stack([vec[2], vec[5], vec[8]], -1)  # eigvec of l2

    dp = world_pts - centroid
    proj = centroid + line_dir * (line_dir * dp).sum(-1, keepdim=True)
    dist_vec = world_pts - proj
    dist = torch.linalg.norm(dist_vec, dim=-1)
    ok = ok & is_line & (dist <= cfg.max_corr_dist) & (dist > 1e-9)

    safe = torch.clamp(dist, min=1e-9)
    unit = dist_vec / safe[:, None]
    # Residual rows unit^T [I | -[R p]x]: the rotation part is Rp x unit.
    Rp = local_pts @ R_cur.T
    J = torch.cat([unit, torch.linalg.cross(Rp, unit)], 1)  # [F, 6]
    w = torch.where(dist > 0.1, 0.1 / safe, torch.ones_like(dist))
    return _normal_equations(J, dist, w, ok)


def _accumulate_surf_factors(world_pts, mask, R_cur, local_pts, map_xyz,
                             map_mask, cfg: LoamConfig):
    """Point-to-plane factors (``findSurfFactorsALOAM``, ``:1324-1421``)."""
    ok, centroid, (l0, _l1, l2), vec = _neighbourhood(
        world_pts, mask, map_xyz, map_mask, cfg)
    is_plane = l0 <= 0.02 * l2  # (:1368)
    normal = torch.stack([vec[0], vec[3], vec[6]], -1)  # eigvec of l0
    flip = (normal * centroid).sum(-1) < 0  # orient outward (:1377)
    normal = torch.where(flip[:, None], -normal, normal)

    d_plane = -(normal * centroid).sum(-1)
    dist = (normal * world_pts).sum(-1) + d_plane  # signed
    ok = ok & is_plane & (torch.abs(dist) <= cfg.max_corr_dist)

    Rp = local_pts @ R_cur.T
    J = torch.cat([normal, torch.linalg.cross(Rp, normal)], 1)
    absd = torch.abs(dist)
    w = torch.where(absd > 0.1, 0.1 / torch.clamp(absd, min=1e-9),
                    torch.ones_like(absd))
    return _normal_equations(J, dist, w, ok)


class LoamMaps(NamedTuple):
    edge_xyz: torch.Tensor  # [Me, 3] world frame
    edge_mask: torch.Tensor
    surf_xyz: torch.Tensor  # [Ms, 3]
    surf_mask: torch.Tensor


def optimize_pose(features: FeatureScan, maps: LoamMaps, q_init, t_init,
                  cfg: LoamConfig):
    """Scan-to-map Gauss-Newton (``optimizeOdometry``, ``:1111-1193``).

    As the reference, it tests convergence on every 4th iteration only
    (``iter % 4 == 0``), after applying that iteration's step, and stops
    once ``|dx| < 1e-6`` (``:1197-1211``). Here every one of
    ``optimization_iterations`` runs, and a device-side flag keeps the
    pose of the iteration that converged."""
    q, t, _, _ = _optimize(features, maps, q_init, t_init, cfg)
    return q, t


def _optimize(features: FeatureScan, maps: LoamMaps, q_init, t_init,
              cfg: LoamConfig):
    """``optimize_pose`` with its two counters, 0-d int tensors on the
    device: ``(q, t, gn_iterations, factors)``. ``gn_iterations`` is the
    iteration (from 1) whose pose the done flag kept, or
    ``optimization_iterations`` when it never fired; ``factors`` the edge
    and surface factors that passed the gates in the last iteration."""
    dtype, dev = features.edge_xyz.dtype, features.edge_xyz.device
    damp = torch.eye(6, dtype=dtype, device=dev) * (cfg.system_noise
                                                    * 1000.0)
    q, t = q_init, t_init
    done = torch.zeros((), dtype=torch.bool, device=dev)
    kept = torch.full((), cfg.optimization_iterations, dtype=torch.int32,
                      device=dev)
    factors = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(cfg.optimization_iterations):
        R = se3.quat_to_rot(q)
        edge_w = features.edge_xyz @ R.T + t
        surf_w = features.surf_xyz @ R.T + t
        with span("loam.factors"):
            A1, b1, n1 = _accumulate_edge_factors(
                edge_w, features.edge_mask, R, features.edge_xyz,
                maps.edge_xyz, maps.edge_mask, cfg)
        with span("loam.factors"):
            A2, b2, n2 = _accumulate_surf_factors(
                surf_w, features.surf_mask, R, features.surf_xyz,
                maps.surf_xyz, maps.surf_mask, cfg)
        with span("loam.solve"):
            A = A1 + A2 + damp
            b = b1 + b2
            factors = n1 + n2
            enough = factors >= 50  # (:1152)
            # solve_ex checks nothing on the host; a non-finite step is
            # skipped, as the reference `continue`s.
            dx = torch.linalg.solve_ex(A, -b)[0]
            do = enough & torch.isfinite(dx).all()
            t_new = torch.where(do, t + dx[:3], t)
            # axis-angle right update (:1178-1191) == boxplus for small dx
            q_new = se3.quat_normalize(torch.where(
                do, se3.quat_boxplus(q, dx[3:6]), q))
            q = torch.where(done, q, q_new)
            t = torch.where(done, t, t_new)
            if it % 4 == 0:
                fired = do & (torch.linalg.norm(dx) < 1e-6)
                kept = torch.where(fired & ~done, it + 1, kept)
                done = done | fired
    return q, t, kept, factors


def update_maps(maps: LoamMaps, features: FeatureScan, q, t,
                cfg: LoamConfig) -> LoamMaps:
    """Merge a keyframe's features into the bounded world maps with voxel
    refiltering (``updateLocalMap``, ``:1646+``)."""
    R = se3.quat_to_rot(q)

    def merge(map_xyz, map_mask, feat_xyz, feat_mask, leaf, cap):
        world = feat_xyz @ R.T + t
        world = torch.where(feat_mask[:, None], world,
                            torch.full_like(world, _BIG))
        pts = torch.cat([map_xyz, world], 0)
        merged = PointCloud(torch.cat([pts, torch.zeros_like(pts[:, :1])], 1),
                            torch.cat([map_mask, feat_mask], 0))
        ds = voxel_downsample(merged, leaf)
        return ds.xyzi[:cap, :3], ds.mask[:cap]

    e_xyz, e_mask = merge(maps.edge_xyz, maps.edge_mask, features.edge_xyz,
                          features.edge_mask, cfg.map_leaf_edge,
                          cfg.map_capacity_edge)
    s_xyz, s_mask = merge(maps.surf_xyz, maps.surf_mask, features.surf_xyz,
                          features.surf_mask, cfg.map_leaf_surf,
                          cfg.map_capacity_surf)
    return LoamMaps(e_xyz, e_mask, s_xyz, s_mask)


def empty_maps(cfg: LoamConfig, dtype, device) -> LoamMaps:
    def side(cap):
        return (torch.full((cap, 3), _BIG, dtype=dtype, device=device),
                torch.zeros(cap, dtype=torch.bool, device=device))

    return LoamMaps(*side(cfg.map_capacity_edge), *side(cfg.map_capacity_surf))


class LoamState(NamedTuple):
    """What the odometry carries from one scan to the next: the maps, the
    previous pose, the motion delta in the previous body frame, the last
    keyframe's pose, the keyframe and near-static frame counts (0-d int32
    on the device) and the index of the last scan (a host int: every
    ``keyframe_interval``-th scan is a keyframe, decided on the host)."""

    maps: LoamMaps
    q_prev: torch.Tensor  # [4]
    t_prev: torch.Tensor  # [3]
    q_delta: torch.Tensor
    t_delta: torch.Tensor
    last_kf_q: torch.Tensor
    last_kf_t: torch.Tensor
    n_keyframes: torch.Tensor
    static_frames: torch.Tensor
    frame: int


class LoamStepOut(NamedTuple):
    """One step's pose, keyframe flag and counters, all on the device."""

    q: torch.Tensor  # [4]
    t: torch.Tensor  # [3]
    is_kf: torch.Tensor  # 0-d bool
    gn_iterations: torch.Tensor  # 0-d int32, see ``_optimize``
    factors: torch.Tensor  # 0-d int64


def loam_init(cloud: PointCloud, cfg: LoamConfig = LoamConfig()
              ) -> LoamState:
    """The state after the first scan: its features make the maps at the
    identity pose, which is the first keyframe."""
    with span("loam.init"):
        dtype, dev = cloud.xyzi.dtype, cloud.xyzi.device
        ident = se3.quat_identity(dtype, dev)
        zero3 = torch.zeros(3, dtype=dtype, device=dev)
        izero = torch.zeros((), dtype=torch.int32, device=dev)
        with span("loam.extract"):
            feats = organize_and_extract(cloud, cfg)
        with span("loam.update_maps"):
            maps = update_maps(empty_maps(cfg, dtype, dev), feats, ident,
                               zero3, cfg)
        return LoamState(maps, ident, zero3, ident, zero3, ident, zero3,
                         izero + 1, izero, 0)


def loam_step(state: LoamState, cloud: PointCloud,
              cfg: LoamConfig = LoamConfig()):
    """One further scan: constant-velocity prediction (``predictMotion``,
    ``:630-656``), scan-to-map Gauss-Newton and the keyframed map update.
    Returns ``(LoamState, LoamStepOut)``; makes no host
    synchronisation."""
    with span("loam.step"):
        s = state
        dtype, dev = cloud.xyzi.dtype, cloud.xyzi.device
        frame = s.frame + 1
        with span("loam.extract"):
            feats = organize_and_extract(cloud, cfg)

        # Constant-velocity prediction with the forced-motion nudge after
        # near-static frames (:639-651): 5 cm forward plus the reference's
        # (frame % 3 - 1) cm lateral.
        inject = ((s.static_frames > cfg.forced_motion_frames)
                  & (torch.linalg.norm(s.t_delta) < 0.02))
        nudge = torch.eye(3, dtype=dtype, device=dev)
        nudge = nudge[0] * 0.05 + nudge[1] * (0.01 * (frame % 3 - 1))
        t_delta_eff = torch.where(inject, s.t_delta + nudge, s.t_delta)
        q_pred = se3.quat_normalize(se3.quat_multiply(s.q_prev, s.q_delta))
        t_pred = s.t_prev + se3.quat_rotate(s.q_prev, t_delta_eff)

        with span("loam.optimize"):
            q_new, t_new, gn_iterations, factors = _optimize(
                feats, s.maps, q_pred, t_pred, cfg)

        # Motion delta in the previous body frame
        q_prev_inv = se3.quat_conjugate(s.q_prev)
        q_delta = se3.quat_multiply(q_prev_inv, q_new)
        t_delta = se3.quat_rotate(q_prev_inv, t_new - s.t_prev)
        static_frames = torch.where(torch.linalg.norm(t_delta) < 0.02,
                                    s.static_frames + 1,
                                    torch.zeros_like(s.static_frames))

        # Keyframe (:1626-1644): distance or rotation since the last
        # keyframe, or every keyframe_interval-th frame.
        dq = se3.quat_multiply(se3.quat_conjugate(s.last_kf_q), q_new)
        angle = 2.0 * torch.arccos(torch.clamp(torch.abs(dq[0]), 0.0, 1.0))
        dist = torch.linalg.norm(t_new - s.last_kf_t)
        is_kf = (dist > cfg.keyframe_dist) | (angle > cfg.keyframe_angle)
        if frame % cfg.keyframe_interval == 0:
            is_kf = torch.ones_like(is_kf)

        with span("loam.update_maps"):
            maps_new = update_maps(s.maps, feats, q_new, t_new, cfg)
            maps = LoamMaps(*(torch.where(is_kf, new, old)
                              for new, old in zip(maps_new, s.maps)))
        new_state = LoamState(
            maps, q_new, t_new, q_delta, t_delta,
            torch.where(is_kf, q_new, s.last_kf_q),
            torch.where(is_kf, t_new, s.last_kf_t),
            s.n_keyframes + is_kf.to(torch.int32), static_frames, frame)
        return new_state, LoamStepOut(q_new, t_new, is_kf, gn_iterations,
                                      factors)


class LoamOutput(NamedTuple):
    positions: torch.Tensor  # [S, 3]
    quaternions: torch.Tensor  # [S, 4]
    n_keyframes: torch.Tensor


def loam_odometry(scans_xyzi, scans_mask, cfg: LoamConfig = LoamConfig()):
    """The whole pipeline over ``scans_xyzi [S, N, 4]`` and ``scans_mask
    [S, N]``: ``loam_init`` on the first scan, ``loam_step`` on each
    further one. Runs where the scans lie and makes no host
    synchronisation."""
    state = loam_init(PointCloud(scans_xyzi[0], scans_mask[0]), cfg)
    ts, qs = [state.t_prev], [state.q_prev]
    for frame in range(1, scans_xyzi.shape[0]):
        state, out = loam_step(
            state, PointCloud(scans_xyzi[frame], scans_mask[frame]), cfg)
        ts.append(out.t)
        qs.append(out.q)
    return LoamOutput(torch.stack(ts), torch.stack(qs), state.n_keyframes)
