"""The GICP Gauss-Newton sums K6 and the step's update after them, each
with its plain PyTorch version (K6 is the port of
``toyslam_tpu/ops/gicp_pallas.py``).

``gicp_terms`` takes CPU tensors to ``gicp_terms_plain`` and launches the
hand-written CUDA kernel (``csrc/gicp_kernels.cu``, sm_90a) for CUDA
tensors, at any N, or raises; there is no fallback. A call is one device
operation: the kernel writes the 27 sums itself. The kernel takes float32
only; the plain version is dtype-generic and is the jnp GN body of
``toyslam_tpu/registration/gicp.py:300-326`` written as the 27 sums.

``gicp_update`` takes the 27 sums and the step's params to the next
step's params (the damped 6x6 solve and the left-perturbation pose
update of ``gicp.py:327-330``) by the same rule: ``gicp_update_plain`` for
CPU tensors, one launch of ``gicp_update_kernel`` for CUDA float32
tensors. A GN step on the card is so two device operations.

Layouts: params [12] = R row-major, t; xyz, q [3, N] source and matched
target points; m6 [6, N] the symmetric Mahalanobis matrices (00 01 02 11 12
22); w [N] weights (0 for rejected pairs). The 27 sums
(``gicp_pallas.py:87-94``): gradient [sum w M r, sum w (R s) x (M r)] (6),
A_tt = sum w M upper (6), A_tr = sum w M S^T row-major (9), A_rr = sum w
S M S^T upper (6), with r = R s + t - q and S = skew(R s). ``A_INDEX``
picks the row-major 6x6 normal matrix [[A_tt, A_tr], [A_tr^T, A_rr]] out
of them.
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
LAUNCHES = {"gicp_terms": 0, "gicp_update": 0}

SOURCE = _cuda.CSRC / "gicp_kernels.cu"
_lib = None
_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]  # m6 channel of M[i, j], row-major
_UPPER = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])


def _a_index():
    upper = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}

    def at(i, j):
        if i < 3 and j < 3:
            return 6 + upper[min(i, j), max(i, j)]
        if i < 3:
            return 12 + 3 * i + (j - 3)  # A_tr[i, j - 3]
        if j < 3:
            return 12 + 3 * j + (i - 3)  # A_tr^T
        return 21 + upper[min(i, j) - 3, max(i, j) - 3]

    return [at(i, j) for i in range(6) for j in range(6)]


A_INDEX = _a_index()  # a_index in csrc/gicp_kernels.cu


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


def gicp_update_plain(s27, params, damping):
    """The next step's params from the 27 sums at ``params``: ``dx =
    -(A + damping I)^-1 g`` (``solve_ex`` makes no host check), ``R <-
    so3_exp(dx[3:6]) R``, ``t <- t + dx[:3]``."""
    A = s27[A_INDEX].reshape(6, 6) + damping * torch.eye(
        6, dtype=s27.dtype, device=s27.device)
    dx = -torch.linalg.solve_ex(A, s27[:6]).result
    R = se3.so3_exp(dx[3:6]) @ params[:9].reshape(3, 3)
    return torch.cat([R.reshape(-1), params[9:12] + dx[:3]])


def _library():
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        _lib = _cuda.load(SOURCE, {
            "gicp_terms": [p, p, p, p, p, p, p, p, i64, i64, p],
            "gicp_update": [p, p, ctypes.c_float, p, p],
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


def gicp_update(s27, params, damping):
    """The rest of a GN step after K6: the next params [12] from the 27
    sums at ``params`` and the damping (float)."""
    if _cuda.on_cpu("GICP", s27, params):
        return gicp_update_plain(s27, params, damping)
    _cuda.check("s27", s27, torch.float32, (N_TERMS,))
    _cuda.check("params", params, torch.float32, (12,))
    out = torch.empty(12, dtype=torch.float32, device=params.device)
    _cuda.launch(_library().gicp_update, s27, params, float(damping), out)
    LAUNCHES["gicp_update"] += 1
    return out
