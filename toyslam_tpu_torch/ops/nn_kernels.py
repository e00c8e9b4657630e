"""Nearest-neighbour kernels K4 and K5 and their plain PyTorch versions
(port of ``toyslam_tpu/ops/nn_pallas.py``).

Each wrapper takes CPU tensors to its ``*_plain`` version and launches its
hand-written CUDA kernel (``csrc/nn_kernels.cu``, sm_90a) for CUDA tensors,
at any shape, or raises; there is no fallback. The kernels take float32
only; the plain versions are dtype-generic.

Ranking is full f32 on the card. The TPU kernels rank under bf16 splits of
the MXU, chosen by ``nn_mode`` (``"highest"``/``"x6"``/``"x3"``); the port
has no such knob. Its kernels compute ``s.t`` in f32 with every product and
sum rounded on its own, in the plain versions' order, so on the card each
kernel equals its plain version bit for bit. That is the ``"highest"``
contract, and what JAX computes on the CPU whatever ``nn_mode`` says.

The target side comes in the layout of the JAX kernels:
``target_operands`` zeroes the coordinates of invalid target points and
gives them a ``|t|^2`` sentinel, so that they never win a minimum.
"""

from __future__ import annotations

import ctypes

import torch

from toyslam_tpu_torch.ops import _cuda

# Kernel launches since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"nearest_neighbor": 0, "neg_dist_bf16": 0}

SOURCE = _cuda.CSRC / "nn_kernels.cu"
_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def target_operands(xyz, mask, sentinel: float):
    """``xyz [M, 3]`` and ``mask [M]`` -> (``tgt_t [3, M]`` with invalid
    columns zeroed, ``tsq [M]`` = ``|t|^2`` or ``sentinel``)."""
    tgt_t = torch.where(mask[:, None], xyz, 0.0).T.contiguous()
    return tgt_t, torch.where(mask, (tgt_t * tgt_t).sum(0), sentinel)


# --------------------------------------------------------------------------
# Plain versions (any device, any float dtype)
# --------------------------------------------------------------------------


def _dot(src, tgt_t):
    """[N, M] ``s.t``, each product and sum rounded on its own."""
    return ((src[:, 0:1] * tgt_t[0] + src[:, 1:2] * tgt_t[1])
            + src[:, 2:3] * tgt_t[2])


def nearest_neighbor_plain(src, tgt_t, tsq):
    """Per source row: ``min_m (tsq_m - 2 s.t_m)`` and the first ``m`` that
    reaches it (``jnp.argmin``'s tie-break), as ([N], [N] int32)."""
    best, idx = (tsq - 2.0 * _dot(src, tgt_t)).min(1)
    return best, idx.to(torch.int32)


def neg_dist_bf16_plain(src, ssq, tgt_t, tsq):
    """``[N, M]`` bf16 negated squared distances ``(2 s.t - tsq) - ssq``."""
    return ((2.0 * _dot(src, tgt_t) - tsq) - ssq[:, None]).to(torch.bfloat16)


# --------------------------------------------------------------------------
# Launch
# --------------------------------------------------------------------------


def _library():
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        _lib = _cuda.load(SOURCE, {
            "nearest_neighbor": [p, p, p, p, p, i64, i64, p],
            "neg_dist_bf16": [p, p, p, p, p, i64, i64, p],
        })
    return _lib


def _check_operands(src, tgt_t, tsq):
    n, m = src.shape[0], tgt_t.shape[-1]
    _cuda.check("src", src, torch.float32, (n, 3))
    _cuda.check("tgt_t", tgt_t, torch.float32, (3, m))
    _cuda.check("tsq", tsq, torch.float32, (m,))
    if max(n, m) >= 2**31:
        raise ValueError(f"{n} x {m} exceeds the kernels' int32 indexing")
    return n, m


def nearest_neighbor(src, tgt_t, tsq):
    """K4: ``src [N, 3]``, ``tgt_t [3, M]``, ``tsq [M]`` -> (partial [N],
    idx [N] int32) with partial = ``min_m (tsq_m - 2 s.t_m)``; the squared
    distance is ``partial + |s|^2``."""
    if _cuda.on_cpu("nearest-neighbour", src, tgt_t, tsq):
        return nearest_neighbor_plain(src, tgt_t, tsq)
    n, m = _check_operands(src, tgt_t, tsq)
    if m == 0:
        raise ValueError("nearest_neighbor: no target points")
    best = torch.empty(n, dtype=torch.float32, device=src.device)
    idx = torch.empty(n, dtype=torch.int32, device=src.device)
    if n == 0:
        return best, idx
    _cuda.launch(_library().nearest_neighbor, src, tgt_t, tsq, best, idx, n, m)
    LAUNCHES["nearest_neighbor"] += 1
    return best, idx


def neg_dist_bf16(src, ssq, tgt_t, tsq):
    """K5: ``src [N, 3]``, ``ssq [N]`` = ``|s|^2``, ``tgt_t [3, M]``,
    ``tsq [M]`` -> ``[N, M]`` bf16 ``(2 s.t - tsq) - ssq``, the operand of
    the covariance top-k."""
    if _cuda.on_cpu("nearest-neighbour", src, ssq, tgt_t, tsq):
        return neg_dist_bf16_plain(src, ssq, tgt_t, tsq)
    n, m = _check_operands(src, tgt_t, tsq)
    _cuda.check("ssq", ssq, torch.float32, (n,))
    if -(-n // 32) * -(-m // 256) >= 2**31:  # kNDRows, kNDCols
        raise ValueError(f"{n} x {m} exceeds the kernel's grid")
    out = torch.empty((n, m), dtype=torch.bfloat16, device=src.device)
    if n == 0 or m == 0:
        return out
    _cuda.launch(_library().neg_dist_bf16, src, ssq, tgt_t, tsq, out, n, m)
    LAUNCHES["neg_dist_bf16"] += 1
    return out
