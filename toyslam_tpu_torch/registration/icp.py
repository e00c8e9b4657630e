"""Point-to-point ICP with SVD (Kabsch) motion estimation (port of
``toyslam_tpu/registration/icp.py``).

As the JAX package does it: brute-force nearest-neighbour association,
Kabsch motion estimation, homogeneous chaining, with the reference's
EPS=1e-4 / MAX_ITER=100 loop semantics. Padded lanes are masked out of the
association and of the Kabsch sums.

The association always goes through K4, ``ops/nn_kernels.nearest_neighbor``
(CUDA on the card, its plain version on CPU tensors), with invalid target
points zeroed and given a 1e30 ``|t|^2`` sentinel: the JAX package's kernel
route. It ranks in full f32 on the card, the ``nn_mode="highest"``
contract; the TPU ranking modes have no counterpart.

The loop runs on the host. JAX runs it in ``lax.while_loop``; here each
iteration's device work ends in one device-to-host copy of the matching
error, the 3x3 cross-covariance and the two centroids (``ICPResult.
host_syncs`` counts these copies). The 3x3 SVD, the pose update and the
``|d_err| < eps`` test run on the host in the source dtype, and the pose is
copied back for the next iteration. The small products use
``torch.matmul``, which is full f32 on the card while TF32 is off
(PyTorch's default).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.core.pointcloud import PointCloud
from toyslam_tpu_torch.ops import nn_kernels

_SENTINEL = 1.0e30  # |t|^2 of an invalid target point


class ICPConfig(NamedTuple):
    eps: float = 1.0e-4  # reference EPS (iterative_closest_point.py:12)
    max_iterations: int = 100  # reference MAX_ITER (:13)


class ICPResult(NamedTuple):
    transform: torch.Tensor  # [4, 4] source -> target (host)
    converged: bool
    iterations: int
    error: torch.Tensor  # final mean matched distance (host)
    # Device-to-host copies the align waited on (one per iteration).
    host_syncs: int = 0


def _associate(cur, src_mask, tgt_t, tsq):
    """Nearest target index and distance of every source point (0 for
    masked source points)."""
    part, idx = nn_kernels.nearest_neighbor(cur, tgt_t, tsq)
    dist = torch.sqrt((part + (cur * cur).sum(1)).clamp(min=0.0))
    return idx.long(), torch.where(src_mask, dist, 0.0)


def nearest_neighbor_association(src_xyz, src_mask, tgt_xyz, tgt_mask):
    """For each source point: index of the nearest valid target point and
    the distance to it (``iterative_closest_point.py:90-102``)."""
    tgt_t, tsq = nn_kernels.target_operands(tgt_xyz, tgt_mask, _SENTINEL)
    return _associate(src_xyz.contiguous(), src_mask, tgt_t, tsq)


def _centred_sums(src_xyz, matched_xyz, weights):
    """Weighted cross-covariance [3, 3] and the two weighted centroids."""
    w = weights[:, None]
    wsum = weights.sum().clamp(min=1.0)
    mu_s = (src_xyz * w).sum(0) / wsum
    mu_m = (matched_xyz * w).sum(0) / wsum
    return ((src_xyz - mu_s) * w).T @ (matched_xyz - mu_m), mu_s, mu_m


def _kabsch(W, mu_s, mu_m):
    """R, t from the centred sums, with the proper-rotation (det +1)
    correction."""
    u, _, vt = torch.linalg.svd(W)
    d = torch.linalg.det(vt.T @ u.T)
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = vt.T @ (D @ u.T)
    return R, mu_m - R @ mu_s


def svd_motion_estimation(src_xyz, matched_xyz, weights):
    """Kabsch: R, t minimising sum w ||R s + t - m||^2
    (``iterative_closest_point.py:105-118``)."""
    return _kabsch(*_centred_sums(src_xyz, matched_xyz, weights))


def icp_align(source: PointCloud, target: PointCloud, guess=None,
              config: ICPConfig = ICPConfig()) -> ICPResult:
    """Iteratively align ``source`` to ``target``; returns the cumulative
    transform."""
    dtype = source.xyzi.dtype
    dev = source.xyzi.device
    src = source.xyzi[:, :3]
    tgt = target.xyzi[:, :3]
    T = torch.eye(4, dtype=dtype) if guess is None else (
        torch.as_tensor(guess).detach().to("cpu", dtype))
    tgt_t, tsq = nn_kernels.target_operands(tgt, target.mask, _SENTINEL)
    w = source.mask.to(dtype)
    n_valid = w.sum().clamp(min=1.0)

    prev_err = torch.tensor(float("inf"), dtype=dtype)
    err = prev_err
    it = 0
    converged = False
    while not converged and it < config.max_iterations:
        Td = T.to(dev, non_blocking=True)
        cur = src @ Td[:3, :3].T + Td[:3, 3]
        idx, dist = _associate(cur, source.mask, tgt_t, tsq)
        W, mu_s, mu_m = _centred_sums(cur, tgt[idx], w)
        host = torch.cat([(dist.sum() / n_valid)[None], W.reshape(-1), mu_s,
                          mu_m]).cpu()  # the iteration's one sync
        err = host[0]
        R, t = _kabsch(host[1:10].reshape(3, 3), host[10:13], host[13:16])
        T = se3.make_transform(R, t) @ T
        converged = bool((prev_err - err).abs() < config.eps)
        prev_err = err
        it += 1
    return ICPResult(transform=T, converged=converged, iterations=it,
                     error=err, host_syncs=it)
