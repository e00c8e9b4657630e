"""Plain generalized ICP (plane to plane) for the reference, as the
deployment runs it: pclomp's ``GeneralizedIterativeClosestPoint`` settings
(``gicp_omp.h:119-127``: k = 20, epsilon 1e-3, 5 m correspondences) with
the damped Gauss-Newton inner loop that the system uses in place of BFGS.

- Covariances from the exact k nearest neighbours (the point itself
  included) with Segal's eigenvalues (epsilon, 1, 1).
- Each outer iteration matches every source point to its exact nearest
  target point, keeps pairs closer than the correspondence distance, fixes
  M = (C_t + R C_s R^T)^-1 at that pose, and takes ``inner_iterations``
  Gauss-Newton steps on sum w r'Mr, r = R s + t - q, with the rotation
  perturbed on the left (R <- exp(dtheta) R) and ``damping`` added to the
  normal matrix.
- It stops once an outer iteration moves no translation entry by
  ``transformation_epsilon`` or more and no rotation entry by
  ``rotation_epsilon`` or more, or after ``max_iterations``.

Plain torch in any float dtype; distances are sums of squared differences
and products are elementwise, so no precision setting changes them. torch
solves no bfloat16 system, so a bfloat16 run solves its 3x3 and 6x6
systems in float32 and rounds back (a 6x6 that rounds to a singular
matrix by its pseudo-inverse).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Settings(NamedTuple):
    k_correspondences: int
    gicp_epsilon: float
    max_correspondence_distance: float
    max_iterations: int
    inner_iterations: int
    transformation_epsilon: float
    rotation_epsilon: float
    damping: float


def _hi(x):
    return x.float() if x.dtype == torch.bfloat16 else x


def _sqdist(a, b):
    """[len(a), len(b)] squared distances as sums of squared differences."""
    d = a[:, None, :] - b[None, :, :]
    return (d * d).sum(-1)


def knn(query, points, k, block=256):
    """Indices ``[n, k]`` of the k nearest ``points`` of each query row."""
    out = []
    for s in range(0, len(query), block):
        d = _sqdist(query[s:s + block], points)
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out)


def nearest(query, points, block=256):
    """Squared distance and index of the nearest point of each query
    row."""
    best, idx = [], []
    for s in range(0, len(query), block):
        d, i = _sqdist(query[s:s + block], points).min(1)
        best.append(d)
        idx.append(i)
    return torch.cat(best), torch.cat(idx)


def covariances(xyz, s: Settings):
    """Segal-regularised covariances ``[n, 3, 3]``."""
    nn = xyz[knn(xyz, xyz, s.k_correspondences)]
    c = nn - nn.mean(1, keepdim=True)
    cov = (c[:, :, :, None] * c[:, :, None, :]).sum(1) / s.k_correspondences
    _, vec = torch.linalg.eigh(_hi(cov))
    ev = torch.tensor([s.gicp_epsilon, 1.0, 1.0], dtype=vec.dtype,
                      device=vec.device)
    C = (vec[:, :, None, :] * (ev * vec)[:, None, :, :]).sum(-1)
    return C.to(xyz.dtype)


def _mat(A, B):
    """Batched 3x3 product by elementwise sums."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def so3_exp(w):
    """Rodrigues' formula of a rotation vector ``[3]``."""
    th = torch.linalg.vector_norm(w)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    KK = _mat(K, K)
    if float(th) < 1e-7:
        return eye + K + 0.5 * KK
    return eye + torch.sin(th) / th * K + (1 - torch.cos(th)) / th ** 2 * KK


def _solve(A, b):
    """``A^-1 b`` by LU; the pseudo-inverse's least-squares answer where a
    low-precision ``A`` rounds to a singular matrix."""
    x, info = torch.linalg.solve_ex(A, b)
    return x if int(info) == 0 else torch.linalg.pinv(A) @ b


def align(src, tgt, guess, s: Settings):
    """Align source points ``src [n, 3]`` to target points ``tgt [m, 3]``
    from ``guess [4, 4]``: ``(T [4, 4], converged, iterations)``."""
    dt, dev = src.dtype, src.device
    C_s, C_t = covariances(src, s), covariances(tgt, s)
    T = guess.to(dev, dt)
    eye6 = s.damping * torch.eye(6, dtype=torch.float64 if dt ==
                                 torch.float64 else torch.float32,
                                 device=dev)
    it, converged = 0, False
    while not converged and it < s.max_iterations:
        R, t = T[:3, :3], T[:3, 3]
        moved = (src[:, None, :] * R[None]).sum(-1) + t
        d2, nn = nearest(moved, tgt)
        w = (d2 < s.max_correspondence_distance ** 2).to(dt)
        q = tgt[nn]
        RCR = _mat(_mat(R.expand(len(src), 3, 3), C_s),
                   R.T.expand(len(src), 3, 3))
        M = torch.linalg.inv_ex(_hi(C_t[nn] + RCR)).inverse.to(dt)
        for _ in range(s.inner_iterations):
            Rp = (src[:, None, :] * R[None]).sum(-1)
            r = Rp + t - q
            Mr = (M * r[:, None, :]).sum(-1)
            S = skew(Rp)
            MS = _mat(M, S.transpose(1, 2))  # M S^T
            SMS = _mat(S, MS)  # S M S^T
            g = torch.cat([(w[:, None] * Mr).sum(0),
                           (w[:, None] * torch.linalg.cross(Rp, Mr)).sum(0)])
            A = torch.zeros((6, 6), dtype=dt, device=dev)
            A[:3, :3] = (w[:, None, None] * M).sum(0)
            A[:3, 3:] = (w[:, None, None] * MS).sum(0)
            A[3:, :3] = A[:3, 3:].T
            A[3:, 3:] = (w[:, None, None] * SMS).sum(0)
            dx = -_solve(_hi(A) + eye6, _hi(g)).to(dt)
            R = _mat(so3_exp(dx[3:]), R)
            t = t + dx[:3]
        T_new = torch.eye(4, dtype=dt, device=dev)
        T_new[:3, :3], T_new[:3, 3] = R, t
        dT = (T_new - T).abs()
        converged = bool((dT[:3, 3].amax() < s.transformation_epsilon)
                         & (dT[:3, :3].amax() < s.rotation_epsilon))
        T = T_new
        it += 1
    return T, converged, it
