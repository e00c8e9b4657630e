"""Generalized ICP, plane to plane (port of
``toyslam_tpu/registration/gicp.py``).

As the JAX package does it, after ``pclomp::GeneralizedIterativeClosestPoint``
(``gicp_omp.h`` + ``gicp_omp_impl.hpp``):

- per-point covariances from k = 20 nearest neighbours with Segal's
  (epsilon, 1, 1) plane regularisation (``computeCovariances``,
  ``impl:48-124``);
- Mahalanobis-weighted correspondences M = (C_B + R C_A R^T)^-1
  (``impl:425-436``);
- a damped Gauss-Newton inner loop over the plane-to-plane objective in
  place of the reference's BFGS (the JAX package's deliberate departure).

Kernels: the covariance k-NN ranks on K5's bf16 operand
(``ops/nn_kernels.neg_dist_bf16``) for f32 clouds with ``exact_knn=False``,
the correspondences come from K4 (``nn_kernels.nearest_neighbor``) and the
GN sums from K6 (``ops/gicp_kernels.gicp_terms``); on CPU tensors each
runs its plain version. There is no other route: the TPU dispatch knobs
(``use_pallas_*``, ``nn_mode``) have no counterpart, and K4 ranks in full
f32 on the card. ``lax.approx_max_k`` becomes ``torch.topk``, an exact
top-k: on the CPU JAX's ``approx_max_k`` is exact too, while the TPU's has
a recall of ~0.95.

The outer loop runs on the host: each outer iteration ends in one
device-to-host copy of the convergence flag, the error and the pose
(``GICPResult.host_syncs`` counts them); the 8 inner GN steps stay on the
device, each K6 and ``gicp_kernels.gicp_update`` (the 6x6 solve and the
pose update): two launches on the card, and on the CPU the plain versions
(``torch.linalg.solve_ex`` in the source dtype). The inner loop carries
the pose as K6's params [12] (R row-major, t). The products use
``torch.matmul``, which is full f32 on the card while TF32 is off
(PyTorch's default).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.core.pointcloud import PointCloud
from toyslam_tpu_torch.ops import gicp_kernels, nn_kernels
from toyslam_tpu_torch.ops.eigh3 import eigh3_soa
from toyslam_tpu_torch.utils.profiling import span, spanned

_BIG = 1.0e9


class GICPConfig(NamedTuple):
    k_correspondences: int = 20  # gicp_omp.h:119
    gicp_epsilon: float = 0.001  # gicp_omp.h:123
    # False: f32 clouds rank the covariance neighbours on K5's bf16
    # operand; True: full-precision distances (f64 always ranks in full).
    exact_knn: bool = False
    max_correspondence_distance: float = 5.0  # pcl default
    max_iterations: int = 20  # outer loop
    inner_iterations: int = 8  # GN steps per correspondence set
    transformation_epsilon: float = 5e-4  # gicp_omp.h region
    rotation_epsilon: float = 2e-3
    damping: float = 1e-6


class GICPResult(NamedTuple):
    transform: torch.Tensor  # [4, 4] source -> target (host)
    converged: bool
    iterations: int
    error: torch.Tensor  # mean squared matched residual (host)
    # Device-to-host copies the align waited on (one per outer iteration).
    host_syncs: int = 0


@spanned("gicp.covariances")
def compute_covariances(xyz, mask, k: int, epsilon: float,
                        exact_knn: bool = False):
    """Segal regularised covariances ``[N, 3, 3]``: eigenvalues ->
    (epsilon, 1, 1) (``computeCovariances``, ``gicp_omp_impl.hpp:48-124``).

    The k neighbours (the point itself included) come from ``torch.topk``
    over the negated squared distances: K5's bf16 operand for f32 with
    ``exact_knn=False``, else full-precision distances. Points with fewer
    than k real neighbours (sparse clouds select padded sentinels) and
    masked points get the identity.
    """
    sq = (xyz * xyz).sum(1)
    if xyz.dtype == torch.float32 and not exact_knn:
        tgt_t, tsq = nn_kernels.target_operands(xyz, mask, _BIG)
        negd, idx = torch.topk(
            nn_kernels.neg_dist_bf16(xyz.contiguous(), sq, tgt_t, tsq), k)
        negd = negd.to(xyz.dtype)
    else:
        d = sq[:, None] - 2.0 * (xyz @ xyz.T) + sq[None, :]
        negd, idx = torch.topk(-torch.where(mask[None, :], d, _BIG), k)
    has_k_real = -negd[:, -1] < _BIG / 2
    nn = xyz[idx]  # [N, k, 3]
    c = nn - nn.mean(1, keepdim=True)
    cov = c.transpose(1, 2) @ c / k

    _, vec = eigh3_soa(cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                       cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2])

    def recompose(i, j):  # eigenvalues (epsilon, 1, 1), ascending
        return (epsilon * vec[i * 3] * vec[j * 3]
                + vec[i * 3 + 1] * vec[j * 3 + 1]
                + vec[i * 3 + 2] * vec[j * 3 + 2])

    C = torch.stack([
        torch.stack([recompose(0, 0), recompose(0, 1), recompose(0, 2)], -1),
        torch.stack([recompose(0, 1), recompose(1, 1), recompose(1, 2)], -1),
        torch.stack([recompose(0, 2), recompose(1, 2), recompose(2, 2)], -1),
    ], -2)
    ok = (mask & has_k_real)[:, None, None]
    return torch.where(ok, C, torch.eye(3, dtype=xyz.dtype, device=xyz.device))


def inverse3(M):
    """Inverse of symmetric 3x3 matrices ``[..., 3, 3]`` by the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, f = M[..., 1, 1], M[..., 1, 2]
    i = M[..., 2, 2]
    A = e * i - f * f
    B = -(b * i - f * c)
    C = b * f - e * c
    inv = 1.0 / (a * A + b * B + c * C)
    out = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([B, a * i - c * c, -(a * f - b * c)], -1),
        torch.stack([C, -(a * f - b * c), a * e - b * b], -1),
    ], -2)
    return out * inv[..., None, None]


class _Problem(NamedTuple):
    """Per-align device constants."""

    src: torch.Tensor  # [N, 3]
    xyz: torch.Tensor  # [3, N], K6's layout
    mask: torch.Tensor  # [N]
    tgt_t: torch.Tensor  # [3, M] invalid columns zeroed (K4's layout)
    tsq: torch.Tensor  # [M] |t|^2 or the 1e9 sentinel
    C_src: torch.Tensor  # [N, 3, 3]
    C_tgt: torch.Tensor  # [M, 3, 3]
    max_d2: float


def _problem(source: PointCloud, target: PointCloud,
             config: GICPConfig) -> _Problem:
    src = source.xyzi[:, :3].contiguous()
    tgt = target.xyzi[:, :3]
    k, eps, exact = (config.k_correspondences, config.gicp_epsilon,
                     config.exact_knn)
    return _Problem(src, src.T.contiguous(), source.mask,
                    *nn_kernels.target_operands(tgt, target.mask, _BIG),
                    compute_covariances(src, source.mask, k, eps, exact),
                    compute_covariances(tgt, target.mask, k, eps, exact),
                    config.max_correspondence_distance ** 2)


@spanned("gicp.correspondences")
def _correspondences(prob: _Problem, R, t):
    """K6's operands at pose (R, t): matched targets ``q [3, N]``, packed
    Mahalanobis ``m6 [6, N]`` and weights ``w [N]`` (``impl:425-436``)."""
    moved = prob.src @ R.T + t
    part, nn_i = nn_kernels.nearest_neighbor(moved, prob.tgt_t, prob.tsq)
    corr_ok = prob.mask & (part + (moved * moved).sum(1) < prob.max_d2)
    nn_i = nn_i.long()
    M = inverse3(prob.C_tgt[nn_i] + R @ prob.C_src @ R.T)
    m6 = torch.stack([M[:, 0, 0], M[:, 0, 1], M[:, 0, 2], M[:, 1, 1],
                      M[:, 1, 2], M[:, 2, 2]])
    return (prob.tgt_t[:, nn_i].contiguous(), m6,
            corr_ok.to(prob.src.dtype))


@spanned("gicp.gn_step")
def _gn_step(xyz, q, m6, w, params, damping: float):
    """One damped Gauss-Newton step from the pose ``params`` [12] to the
    next: K6's 27 sums, then the solve and the left-perturbation update
    ``R <- exp(dtheta) R``, ``t <- t + dt`` (``gicp_kernels.gicp_update``).
    Both are looked up on the module at each call."""
    s27 = gicp_kernels.gicp_terms(params, xyz, q, m6, w)
    return gicp_kernels.gicp_update(s27, params, damping)


@spanned("gicp.align")
def gicp_align(source: PointCloud, target: PointCloud, guess=None,
               config: GICPConfig = GICPConfig()) -> GICPResult:
    """Align ``source`` to ``target``; returns the source -> target
    transform."""
    dtype = source.xyzi.dtype
    dev = source.xyzi.device
    T_host = torch.eye(4, dtype=dtype) if guess is None else (
        torch.as_tensor(guess).detach().to("cpu", dtype))
    T = T_host.to(dev, non_blocking=True)
    prob = _problem(source, target, config)

    err = torch.tensor(float("inf"), dtype=dtype)
    it = 0
    converged = False
    while not converged and it < config.max_iterations:
        q, m6, w = _correspondences(prob, T[:3, :3], T[:3, 3])
        params = torch.cat([T[:3, :3].reshape(-1), T[:3, 3]])
        for _ in range(config.inner_iterations):
            params = _gn_step(prob.xyz, q, m6, w, params, config.damping)
        R, t = params[:9].view(3, 3), params[9:]
        with span("gicp.converge"):
            T_new = se3.make_transform(R, t)
            # Convergence on the transform change (transformation_epsilon)
            dT = (T_new - T).abs()
            conv = ((dT[:3, 3].amax() < config.transformation_epsilon)
                    & (dT[:3, :3].amax() < config.rotation_epsilon))
            r = prob.src @ R.T + t - q.T
            err_d = ((r * r).sum(1) * w).sum() / w.sum().clamp(min=1.0)
            host = torch.cat([conv.to(dtype)[None], err_d[None],
                              T_new.reshape(-1)])
            with span("gicp.sync"):  # the iteration's sync
                host = host.cpu()
            converged = bool(host[0])
            err = host[1]
            T_host = host[2:].reshape(4, 4)
            T = T_new
            it += 1
    return GICPResult(transform=T_host, converged=converged, iterations=it,
                      error=err, host_syncs=it)
