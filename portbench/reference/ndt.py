"""Plain NDT registration for the reference: Magnusson 2009 (eqs. 6.8-6.13,
6.18-6.21) with the More-Thuente line search, as
``pclomp::NormalDistributionsTransform`` and its deployment settings define
it.

Written from the equations in plain torch (the per-point work, on any
device and in any float dtype) and numpy float64 (the 6-dof Newton step
and the line search's scalars). The settings it follows are the
configuration's:

- the map: voxels of ``resolution`` over the target's bounding grid, the
  first ``map_capacity`` voxels in ascending id kept, at least
  ``min_points_per_voxel`` points, covariance ``(n - 1) / n^2 sum e e^T``
  with eigenvalues below ``min_covar_eigvalue_mult * lambda_max`` raised to
  it; a voxel is looked up through a table of ``grid_capacity`` slots
  (``id & (grid_capacity - 1)``), so two kept voxels that share a slot are
  both unreachable;
- DIRECT7 neighbourhoods; a neighbour counts when its voxel is in the map
  and ``0 <= d2 exp(-d2 q'Cq / 2) <= 1``;
- ``frozen_linesearch`` with ``regather_iterations``: the neighbourhoods
  are gathered at the start pose and, for the first
  ``regather_iterations`` Newton iterations, again at each iteration's
  first trial point; every evaluation uses the last gathered ones;
- Newton steps by an SVD solve (singular values under ``6 eps s_max``
  dropped), stopping when a step is shorter than
  ``transformation_epsilon`` (never on the first) or after
  ``max_iterations``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

OFFSETS7 = [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
            [0, 0, 1], [0, 0, -1]]


class Settings(NamedTuple):
    resolution: float
    step_size: float
    outlier_ratio: float
    transformation_epsilon: float
    max_iterations: int
    min_points_per_voxel: int
    max_step_iterations: int
    min_covar_eigvalue_mult: float
    grid_capacity: int
    map_capacity: int
    frozen_linesearch: bool
    regather_iterations: int


class Map(NamedTuple):
    ids: torch.Tensor  # [V] int64, ascending, the reachable voxels
    mean: torch.Tensor  # [V, 3]
    icov: torch.Tensor  # [V, 3, 3]
    lo: torch.Tensor  # [3] int64, grid origin in voxels
    div: torch.Tensor  # [3] int64, grid size in voxels
    voxels: int  # occupied voxels before any cut


def _f32_if_low(x):
    """torch's eigh and inverse take no bfloat16: such inputs are solved in
    float32 and the result rounded back."""
    return x.float() if x.dtype == torch.bfloat16 else x


def build_map(xyz: torch.Tensor, s: Settings) -> Map:
    """The voxel-Gaussian map of target points ``xyz [n, 3]`` (all
    valid)."""
    dt, dev = xyz.dtype, xyz.device
    ijk = torch.floor(xyz / s.resolution).to(torch.int64)
    lo = ijk.amin(0)
    div = ijk.amax(0) - lo + 1
    rel = ijk - lo
    vid = rel[:, 0] + rel[:, 1] * div[0] + rel[:, 2] * div[0] * div[1]
    uniq, inv = torch.unique(vid, sorted=True, return_inverse=True)
    n_vox = len(uniq)
    keep_pt = inv < s.map_capacity
    uniq, inv, xyz = uniq[:s.map_capacity], inv[keep_pt], xyz[keep_pt]
    V = len(uniq)
    cnt = torch.zeros(V, dtype=dt, device=dev).index_add_(
        0, inv, torch.ones(len(inv), dtype=dt, device=dev))
    mean = torch.zeros((V, 3), dtype=dt, device=dev).index_add_(
        0, inv, xyz) / cnt[:, None]
    e = xyz - mean[inv]
    outer = (e[:, :, None] * e[:, None, :]).reshape(-1, 9)
    cov = torch.zeros((V, 9), dtype=dt, device=dev).index_add_(
        0, inv, outer).reshape(V, 3, 3)
    cov = cov * ((cnt - 1.0) / (cnt * cnt))[:, None, None]

    w, vec = torch.linalg.eigh(_f32_if_low(cov))
    tol = 1e-5 * w[:, 2].clamp(min=0.0)
    eig_ok = (w[:, 0] >= -tol) & (w[:, 1] >= -tol) & (w[:, 2] > 0)
    w = w.clamp(min=0.0)
    min_ev = s.min_covar_eigvalue_mult * w[:, 2:3]
    raised = torch.cat([torch.maximum(w[:, :2], min_ev), w[:, 2:]], 1)
    inflate = (w[:, 0:1] < min_ev)[..., None]
    cov_i = torch.where(inflate, vec @ torch.diag_embed(raised)
                        @ vec.transpose(1, 2), _f32_if_low(cov))
    icov, info = torch.linalg.inv_ex(cov_i)
    ok = ((cnt >= s.min_points_per_voxel) & eig_ok & (info == 0)
          & torch.isfinite(icov).all(-1).all(-1)
          & (torch.linalg.det(cov_i).abs() > 0))
    # Kept voxels that share a table slot are both unreachable.
    slot = uniq & (s.grid_capacity - 1)
    per_slot = torch.zeros(s.grid_capacity, dtype=torch.int64,
                           device=dev).index_add_(0, slot[ok],
                                                  torch.ones_like(slot[ok]))
    ok = ok & (per_slot[slot] == 1)
    return Map(uniq[ok], mean[ok], icov[ok].to(dt), lo, div, n_vox)


def gauss_coefficients(resolution, outlier_ratio):
    """d1, d2 of eq. 6.8."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / resolution ** 3
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


def pose_matrix(p) -> np.ndarray:
    """pose6 ``[tx, ty, tz, roll, pitch, yaw]`` -> 4x4, R = Rx Ry Rz."""
    a, b, c = p[3:6]
    Rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)],
                   [0, math.sin(a), math.cos(a)]])
    Ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0],
                   [-math.sin(b), 0, math.cos(b)]])
    Rz = np.array([[math.cos(c), -math.sin(c), 0],
                   [math.sin(c), math.cos(c), 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rx @ Ry @ Rz
    T[:3, 3] = p[:3]
    return T


def pose6(T: np.ndarray) -> np.ndarray:
    """Inverse of ``pose_matrix`` on Eigen's ``eulerAngles(0, 1, 2)``
    branch, as pclomp decomposes its guess."""
    R = T[:3, :3]
    c2 = math.hypot(R[0, 0], R[0, 1])
    r0 = math.atan2(R[1, 2], R[2, 2])
    if r0 > 0:
        a0, a1 = r0 - math.pi, math.atan2(-R[0, 2], -c2)
    else:
        a0, a1 = r0, math.atan2(-R[0, 2], c2)
    s1, c1 = math.sin(a0), math.cos(a0)
    a2 = math.atan2(s1 * R[2, 0] - c1 * R[1, 0], c1 * R[1, 1] - s1 * R[2, 1])
    return np.array([T[0, 3], T[1, 3], T[2, 3], -a0, -a1, -a2])


def _angle_tables(p):
    """Eq. 6.19 (j, [8, 3]) and eq. 6.21 (h, [15, 3]) terms; angles under
    1e-4 rad take cos 1 and sin 0, as pclomp does."""
    def cs(a):
        return (1.0, 0.0) if abs(a) < 10e-5 else (math.cos(a), math.sin(a))

    cx, sx = cs(p[3])
    cy, sy = cs(p[4])
    cz, sz = cs(p[5])
    j = [[-sx * sz + cx * sy * cz, -sx * cz - cx * sy * sz, -cx * cy],
         [cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy],
         [-sy * cz, sy * sz, cy],
         [sx * cy * cz, -sx * cy * sz, sx * sy],
         [-cx * cy * cz, cx * cy * sz, -cx * sy],
         [-cy * sz, -cy * cz, 0],
         [cx * cz - sx * sy * sz, -cx * sz - sx * sy * cz, 0],
         [sx * cz + cx * sy * sz, cx * sy * cz - sx * sz, 0]]
    h = [[-cx * sz - sx * sy * cz, -cx * cz + sx * sy * sz, sx * cy],
         [-sx * sz + cx * sy * cz, -cx * sy * sz - sx * cz, -cx * cy],
         [cx * cy * cz, -cx * cy * sz, cx * sy],
         [sx * cy * cz, -sx * cy * sz, sx * sy],
         [-sx * cz - cx * sy * sz, sx * sz - cx * sy * cz, 0],
         [cx * cz - sx * sy * sz, -sx * sy * cz - cx * sz, 0],
         [-cy * cz, cy * sz, -sy],
         [-sx * sy * cz, sx * sy * sz, sx * cy],
         [cx * sy * cz, -cx * sy * sz, -cx * cy],
         [sy * sz, sy * cz, 0],
         [-sx * cy * sz, -sx * cy * cz, 0],
         [cx * cy * sz, cx * cy * cz, 0],
         [-cy * cz, cy * sz, 0],
         [-cx * sz - sx * sy * cz, -cx * cz + sx * sy * sz, 0],
         [-sx * sz + cx * sy * cz, -cx * sy * sz - sx * cz, 0]]
    return np.array(j), np.array(h)


class _Problem:
    """The source points and the map on the device, and the evaluations
    of one align."""

    def __init__(self, m: Map, src: torch.Tensor, s: Settings):
        self.m, self.src, self.s = m, src, s
        self.dt, self.dev = src.dtype, src.device
        self.d1, self.d2 = gauss_coefficients(s.resolution, s.outlier_ratio)
        self.off = torch.tensor(OFFSETS7, dtype=torch.int64, device=self.dev)
        self.evaluations = 0

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dt, device=self.dev)

    def moved(self, p):
        T = self._t(pose_matrix(p))
        s = self.src
        return (s[:, 0:1] * T[:3, 0] + s[:, 1:2] * T[:3, 1]
                + s[:, 2:3] * T[:3, 2] + T[:3, 3])

    def gather(self, p):
        """Map rows of each point's seven neighbour voxels at pose p:
        ``(row [n, 7], found [n, 7])``."""
        m = self.m
        ijk = torch.floor(self.moved(p) / self.s.resolution).to(torch.int64)
        nijk = ijk[:, None, :] + self.off[None]
        rel = nijk - m.lo
        inside = ((rel >= 0) & (rel < m.div)).all(-1)
        vid = rel[..., 0] + rel[..., 1] * m.div[0] + rel[..., 2] * (
            m.div[0] * m.div[1])
        if len(m.ids) == 0:
            return torch.zeros_like(vid), torch.zeros_like(inside)
        row = torch.searchsorted(m.ids, vid).clamp(max=len(m.ids) - 1)
        return row, inside & (m.ids[row] == vid)

    def derivatives(self, p, nb):
        """Score, gradient [6] and Hessian [6, 6] (numpy f64) at pose p
        against the neighbourhood ``nb``."""
        self.evaluations += 1
        row, found = nb
        j_tab, h_tab = (self._t(a) for a in _angle_tables(p))
        src = self.src
        xj = (src[:, None, :] * j_tab[None]).sum(-1)  # [n, 8]
        xh = (src[:, None, :] * h_tab[None]).sum(-1)  # [n, 15]
        zero = torch.zeros(len(src), dtype=self.dt, device=self.dev)
        # Point Jacobian's angular columns (eq. 6.18): [n, 3, 3].
        Ja = torch.stack([
            torch.stack([zero, xj[:, 2], xj[:, 5]], -1),
            torch.stack([xj[:, 0], xj[:, 3], xj[:, 6]], -1),
            torch.stack([xj[:, 1], xj[:, 4], xj[:, 7]], -1)], 1)
        a = torch.stack([zero, xh[:, 0], xh[:, 1]], -1)
        b = torch.stack([zero, xh[:, 2], xh[:, 3]], -1)
        c = torch.stack([zero, xh[:, 4], xh[:, 5]], -1)
        d = xh[:, 6:9]
        e = xh[:, 9:12]
        f = xh[:, 12:15]
        Hrr = torch.stack([torch.stack([a, b, c], 1),
                           torch.stack([b, d, e], 1),
                           torch.stack([c, e, f], 1)], 1)  # [n, 3, 3, 3]

        m = self.m
        q = self.moved(p)[:, None, :] - m.mean[row]  # [n, 7, 3]
        icov = m.icov[row]  # [n, 7, 3, 3]
        Cq = (icov * q[:, :, None, :]).sum(-1)
        qCq = (q * Cq).sum(-1)
        ee = torch.exp(-0.5 * self.d2 * qCq)
        de = self.d2 * ee
        gate = found & (de >= 0) & (de <= 1)
        w = gate.to(self.dt)
        score = (-self.d1 * ee * w).sum()
        factor = self.d1 * self.d2 * ee * w  # [n, 7]
        CqJ = (Cq[..., :, None] * Ja[:, None]).sum(-2)  # [n, 7, 3]
        u = torch.cat([Cq, CqJ], -1)  # [n, 7, 6]
        fu = factor[..., None] * u
        grad = fu.sum((0, 1))
        hess = -self.d2 * (fu[..., :, None] * u[..., None, :]).sum((0, 1))
        fC = (factor[..., None, None] * icov).sum(1)  # [n, 3, 3]
        fCJ = (fC[:, :, :, None] * Ja[:, None, :, :]).sum(2)  # [n, 3, 3]
        JfCJ = (Ja[:, :, :, None] * fCJ[:, :, None, :]).sum(1)
        fCq = (factor[..., None] * Cq).sum(1)  # [n, 3]
        rr = (fCq[:, None, None, :] * Hrr).sum((0, -1))
        blk = torch.zeros((6, 6), dtype=self.dt, device=self.dev)
        blk[:3, :3] = fC.sum(0)
        blk[:3, 3:] = fCJ.sum(0)
        blk[3:, :3] = fCJ.sum(0).T
        blk[3:, 3:] = JfCJ.sum(0) + rr
        host = torch.cat([score[None], grad, (hess + blk).reshape(-1)]
                         ).double().cpu().numpy()
        return host[0], host[1:7], host[7:].reshape(6, 6)


def _nz(x):
    return x if x != 0 else 1e-300


def _cubic(al, fl, gl, at, ft, gt):
    z = 3 * (ft - fl) / _nz(at - al) - gt - gl
    w = math.sqrt(max(z * z - gt * gl, 0.0))
    return al + (at - al) * (w - gl - z) / _nz(gt - gl + 2 * w)


def _trial(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """More-Thuente trial value selection (its four cases)."""
    if f_t > f_l:
        a_c = _cubic(a_l, f_l, g_l, a_t, f_t, g_t)
        a_q = a_l - 0.5 * (a_l - a_t) * g_l / _nz(
            g_l - (f_l - f_t) / _nz(a_l - a_t))
        return a_c if abs(a_c - a_l) < abs(a_q - a_l) else 0.5 * (a_q + a_c)
    a_s = a_l - (a_l - a_t) / _nz(g_l - g_t) * g_l
    if g_t * g_l < 0:
        a_c = _cubic(a_l, f_l, g_l, a_t, f_t, g_t)
        return a_c if abs(a_c - a_t) >= abs(a_s - a_t) else a_s
    if abs(g_t) <= abs(g_l):
        a_c = _cubic(a_l, f_l, g_l, a_t, f_t, g_t)
        a_n = a_c if abs(a_c - a_t) < abs(a_s - a_t) else a_s
        bound = a_t + 0.66 * (a_u - a_t)
        return min(bound, a_n) if a_t > a_l else max(bound, a_n)
    return _cubic(a_u, f_u, g_u, a_t, f_t, g_t)


def _update(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """More-Thuente interval update: new ends and whether it converged."""
    if f_t > f_l:
        return a_l, f_l, g_l, a_t, f_t, g_t, False
    if g_t * (a_l - a_t) > 0:
        return a_t, f_t, g_t, a_u, f_u, g_u, False
    if g_t * (a_l - a_t) < 0:
        return a_t, f_t, g_t, a_l, f_l, g_l, False
    return a_l, f_l, g_l, a_u, f_u, g_u, True


def _newton_direction(hess, grad, dtype):
    """SVD solve of hess x = -grad in ``dtype`` (float32 for a bfloat16
    control), singular values under 6 eps s_max dropped."""
    H = hess.astype(dtype)
    u, sv, vt = np.linalg.svd(H)
    cut = np.finfo(dtype).eps * 6 * sv.max()
    sinv = np.where(sv > cut, 1 / np.where(sv > cut, sv, 1), 0)
    return (vt.T @ (sinv * (u.T @ (-grad.astype(dtype))))).astype(np.float64)


def align(m: Map, src: torch.Tensor, guess: np.ndarray, s: Settings):
    """Align source points ``src [n, 3]`` to the map from ``guess`` [4, 4]:
    ``(T [4, 4] numpy, converged, iterations, evaluations)``."""
    prob = _Problem(m, src, s)
    host_dt = np.float64 if src.dtype == torch.float64 else np.float32
    eps, step_max = s.transformation_epsilon, s.step_size
    step_min = eps / 2.0
    mu, nu = 1e-4, 0.9
    frozen = s.frozen_linesearch

    def clip(a):
        return min(max(a, step_min), step_max)

    p = pose6(guess)
    nb = prob.gather(p)
    score, grad, hess = prob.derivatives(p, nb)
    it, converged, failed = 0, False, False
    while not converged:
        if np.isfinite(hess).all() and np.isfinite(grad).all():
            delta = _newton_direction(hess, grad, host_dt)
        else:
            delta = np.full(6, np.nan)
        norm = float(np.linalg.norm(delta))
        degenerate = norm == 0 or not math.isfinite(norm)
        step_dir = delta / (1.0 if degenerate else norm)
        phi_0 = -score
        d_phi_0 = -float(grad @ step_dir)
        if d_phi_0 > 0:
            step_dir, d_phi_0 = -step_dir, -d_phi_0
        zero_dir = d_phi_0 == 0
        a_t = clip(norm) if math.isfinite(norm) else step_max
        if frozen and it < s.regather_iterations:
            nb = prob.gather(p + step_dir * a_t)
        elif not frozen:
            nb = None

        def ev(a):
            here = p + step_dir * a
            return prob.derivatives(here, nb if frozen
                                    else prob.gather(here))

        score_t, grad_t, hess_t = ev(a_t)
        phi_t, d_phi_t = -score_t, -float(grad_t @ step_dir)
        psi_t = phi_t - phi_0 - mu * d_phi_0 * a_t
        d_psi_t = d_phi_t - mu * d_phi_0
        a_l = a_u = f_l = f_u = 0.0
        g_l = g_u = (1.0 - mu) * d_phi_0
        open_, done, k = True, False, 0
        while (not done and k < s.max_step_iterations
               and not (psi_t <= 0 and d_phi_t <= -nu * d_phi_0)
               and not zero_dir):
            f_sel, g_sel = (psi_t, d_psi_t) if open_ else (phi_t, d_phi_t)
            a_t = clip(_trial(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_sel,
                              g_sel))
            score_t, grad_t, hess_t = ev(a_t)
            phi_t, d_phi_t = -score_t, -float(grad_t @ step_dir)
            psi_t = phi_t - phi_0 - mu * d_phi_0 * a_t
            d_psi_t = d_phi_t - mu * d_phi_0
            if open_ and psi_t <= 0 and d_psi_t >= 0:
                open_ = False
                f_l += phi_0 - mu * d_phi_0 * a_l
                g_l += mu * d_phi_0
                f_u += phi_0 - mu * d_phi_0 * a_u
                g_u += mu * d_phi_0
            f_upd, g_upd = (psi_t, d_psi_t) if open_ else (phi_t, d_phi_t)
            a_l, f_l, g_l, a_u, f_u, g_u, done = _update(
                a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_upd, g_upd)
            k += 1
        if zero_dir:
            a_t = 0.0
        if not degenerate:
            p = p + step_dir * a_t
            score, grad, hess = score_t, grad_t, hess_t
        converged = (degenerate or it > s.max_iterations
                     or (it >= 1 and abs(a_t) < eps))
        failed = failed or not math.isfinite(norm)
        it += 1
    return pose_matrix(p), not failed, it, prob.evaluations
