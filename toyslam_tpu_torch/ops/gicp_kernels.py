"""The GICP Gauss-Newton sums K6 and their plain PyTorch version (port of
``toyslam_tpu/ops/gicp_pallas.py``).

``gicp_terms`` takes CPU tensors to ``gicp_terms_plain`` and launches the
hand-written CUDA kernel (``csrc/gicp_kernels.cu``, sm_90a) for CUDA
tensors, at any N, or raises; there is no fallback. A call is one device
operation: the kernel writes the 27 sums itself. The kernel takes float32
only; the plain version is dtype-generic and is the jnp GN body of
``toyslam_tpu/registration/gicp.py:300-326`` written as the 27 sums.

Layouts: params [12] = R row-major, t; xyz, q [3, N] source and matched
target points; m6 [6, N] the symmetric Mahalanobis matrices (00 01 02 11 12
22); w [N] weights (0 for rejected pairs). The 27 sums
(``gicp_pallas.py:87-94``): gradient [sum w M r, sum w (R s) x (M r)] (6),
A_tt = sum w M upper (6), A_tr = sum w M S^T row-major (9), A_rr = sum w
S M S^T upper (6), with r = R s + t - q and S = skew(R s).
"""

from __future__ import annotations

import ctypes

import torch

from toyslam_tpu_torch.core import se3
from toyslam_tpu_torch.ops import _cuda

N_TERMS = 27
SLOTS = 28  # kSlots in csrc/gicp_kernels.cu: a partial row, whole float4s
THREADS = 128  # kThreads there
PER_THREAD = 2  # kPer there: correspondences a thread

# Kernel launches since the last reset; the wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"gicp_terms": 0}

SOURCE = _cuda.CSRC / "gicp_kernels.cu"
_lib = None
_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]  # m6 channel of M[i, j], row-major
_UPPER = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gicp_terms_plain(params, xyz, q, m6, w):
    """The 27 sums of the GN normal equations at pose ``params``."""
    R = params[:9].reshape(3, 3)
    Rp = (R @ xyz).T  # [N, 3]
    r = Rp + params[9:12] - q.T
    M = m6[_SYM].T.reshape(-1, 3, 3)
    Mr = (M @ r[:, :, None])[..., 0]
    S = se3.skew(Rp)
    MS = M @ S.transpose(1, 2)  # M S^T
    w3 = w[:, None, None]
    A_tt = (w3 * M).sum(0)
    A_tr = (w3 * MS).sum(0)
    A_rr = (w3 * (S @ M @ S.transpose(1, 2))).sum(0)
    return torch.cat([(Mr * w[:, None]).sum(0),
                      (torch.linalg.cross(Rp, Mr) * w[:, None]).sum(0),
                      A_tt[_UPPER], A_tr.reshape(-1), A_rr[_UPPER]])


def _library():
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        _lib = _cuda.load(SOURCE, {
            "gicp_terms": [p, p, p, p, p, p, p, p, i64, i64, p],
            "gicp_empty": [i64, p]})
    return _lib


def blocks(n):
    """K6's grid at ``n`` correspondences."""
    return -(-n // (THREADS * PER_THREAD))


def empty_launch(n, device):
    """Launches an empty kernel on K6's grid at ``n`` correspondences on
    ``device``'s current stream: the cost of a launch of that shape, for
    checks beside K6's device time. No path calls it, so it has no launch
    count."""
    _cuda.launch(_library().gicp_empty, blocks(n), device=device)


def gicp_terms(params, xyz, q, m6, w):
    """K6: the 27 GN sums (layout in the module docstring)."""
    if _cuda.on_cpu("GICP", params, xyz, q, m6, w):
        return gicp_terms_plain(params, xyz, q, m6, w)
    n = xyz.shape[-1]
    _cuda.check("params", params, torch.float32, (12,))
    _cuda.check("xyz", xyz, torch.float32, (3, n))
    _cuda.check("q", q, torch.float32, (3, n))
    _cuda.check("m6", m6, torch.float32, (6, n))
    _cuda.check("w", w, torch.float32, (n,))
    if n >= 2**31:
        raise ValueError(f"{n} pairs exceed the kernel's int32 indexing")
    if n == 0:
        return torch.zeros(N_TERMS, dtype=torch.float32, device=xyz.device)
    grid = blocks(n)
    out, partials, counter = _cuda.grid_sum_buffers(xyz.device, N_TERMS,
                                                    SLOTS, grid)
    _cuda.launch(_library().gicp_terms, params, xyz, q, m6, w, partials, out,
                 counter, n, grid)
    LAUNCHES["gicp_terms"] += 1
    return out
