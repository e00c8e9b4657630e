"""Nearest-neighbour kernels K4 and K5 and their plain PyTorch versions
(port of ``toyslam_tpu/ops/nn_pallas.py``).

Each wrapper takes CPU tensors to its ``*_plain`` version and launches its
hand-written CUDA kernel (``csrc/nn_kernels.cu``, sm_90a) for CUDA tensors,
at any shape, or raises; there is no fallback. The kernels take float32
only; the plain versions are dtype-generic.

Ranking is full f32 on the card. The TPU kernels rank under bf16 splits of
the MXU, chosen by ``nn_mode`` (``"highest"``/``"x6"``/``"x3"``); the port
has no such knob. Every value its kernels return is ``s.t`` in f32 with
every product and sum rounded on its own, in the plain versions' order, so
on the card each kernel equals its plain version bit for bit. That is the
``"highest"`` contract, and what JAX computes on the CPU whatever
``nn_mode`` says. K4 gets there in two passes: a tensor-core screen (the
``x3`` split, ``screen_plain``) finds each row's screen minimum, and only
the columns within the rigorous limit ``screen_limit`` of it are rescored
in f32 (``csrc/nn_kernels.cu`` states the bound and why it is exact).

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


# K4's screen error budget, E_c = SCREEN_TSQ_REL |tsq_c| + SCREEN_DOT_REL
# P_c with P_c = sum_i |s_i| |t_ci|, and the kernel's candidate limit
# (csrc/nn_kernels.cu: kLimRel, kLimDot, kLimAbs, kNormSlack, kNormTight).
SCREEN_TSQ_REL = 2.0 ** -16
SCREEN_DOT_REL = 2.0 ** -12
LIMIT_REL = 2.0 ** -15
LIMIT_DOT = 1.25 * 2.0 ** -12
LIMIT_ABS = 2.0 ** -96
NORM_SLACK = 1.0 - 2.0 ** -21
NORM_TIGHT = 1.0 - 2.0 ** -20


def _bf16_parts(x, parts):
    """``parts`` exact bf16 parts of f32 ``x`` (hi, then the rest's), as
    f64."""
    out = []
    for _ in range(parts):
        p = x.to(torch.bfloat16).to(torch.float32)
        out.append(p.double())
        x = x - p
    return out


def screen_plain(src, tgt_t, tsq):
    """K4's tensor-core screen, emulated: ``[N, M]`` f32 ``tsq - 2 s.t``
    from the x3 split of ``u = -2 s`` and ``t`` and the 3-part split of
    ``tsq``, the exact products summed in f64 and rounded to f32 once."""
    u = _bf16_parts(-2.0 * src.float(), 2)
    t = _bf16_parts(tgt_t.float(), 2)
    q = _bf16_parts(tsq.float(), 3)
    acc = (q[0] + q[1] + q[2])[None].expand(src.shape[0], -1).clone()
    for a, b in ((u[0], t[0]), (u[0], t[1]), (u[1], t[0])):
        acc += a @ b
    return acc.float()


def screen_error_bound(src, tgt_t, tsq):
    """``[N, M]`` E_c: what the screen may miss the plain value by."""
    return (SCREEN_TSQ_REL * tsq.double().abs()[None]
            + SCREEN_DOT_REL * (src.double().abs() @ tgt_t.double().abs()))


def _limit(m, S):
    thr = m + LIMIT_REL * m.abs() + 2.0 * LIMIT_DOT * S + LIMIT_ABS
    return torch.where(thr >= 0, thr / (1.0 - LIMIT_REL),
                       thr / (1.0 + LIMIT_REL))


def screen_limit(src, tgt_t, tsq, screen_min):
    """Per row, the largest screen value that K4 rescores (f64; the kernel
    rounds each step up). With ``S = sum_i |s_i| max_c |t_ci|`` (NaN
    columns skipped, as the kernel's ``fmaxf`` skips them) it is ``g^-1(m
    + LIMIT_REL |m| + 2 LIMIT_DOT S + LIMIT_ABS)``, ``g(v) = v - LIMIT_REL
    |v|``. When every column has ``tsq >= NORM_SLACK |t|^2``, S shrinks to
    ``|s| R``, R the largest ``|t_c|`` that a column within that first
    limit can have."""
    t = tgt_t.double().abs()
    S = src.double().abs() @ torch.where(torch.isnan(t), 0.0, t).amax(1)
    m = screen_min.double()
    if bool((tsq.double() >= NORM_SLACK * (t * t).sum(0)).all()):
        vc = _limit(m, S)
        X = vc + LIMIT_REL * vc.abs() + LIMIT_DOT * S + LIMIT_ABS
        s2 = (src.double() ** 2).sum(1)
        R = ((s2.sqrt() + (s2 + NORM_TIGHT * X).clamp(min=0.0).sqrt())
             / NORM_TIGHT)
        S = torch.minimum(S, s2.sqrt() * R)
    return _limit(m, S)


def screen_counts(src, tgt_t, tsq):
    """Per row, the columns that K4's second pass rescores (``[N]`` int32),
    from the emulated screen."""
    screen = screen_plain(src, tgt_t, tsq)
    mn = torch.where(torch.isnan(screen), float("inf"), screen).amin(1)
    limit = screen_limit(src, tgt_t, tsq, mn)
    return (screen.double() <= limit[:, None]).sum(1).to(torch.int32)


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
            "nearest_neighbor": [p, p, p, p, p, p, i64, i64, p],
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


def nearest_neighbor(src, tgt_t, tsq, counts=False):
    """K4: ``src [N, 3]``, ``tgt_t [3, M]``, ``tsq [M]`` -> (partial [N],
    idx [N] int32) with partial = ``min_m (tsq_m - 2 s.t_m)``; the squared
    distance is ``partial + |s|^2``. With ``counts``, a third output: the
    columns rescored per row ([N] int32; on CPU tensors from
    ``screen_counts``)."""
    if _cuda.on_cpu("nearest-neighbour", src, tgt_t, tsq):
        out = nearest_neighbor_plain(src, tgt_t, tsq)
        return (*out, screen_counts(src, tgt_t, tsq)) if counts else out
    n, m = _check_operands(src, tgt_t, tsq)
    if m == 0:
        raise ValueError("nearest_neighbor: no target points")
    best = torch.empty(n, dtype=torch.float32, device=src.device)
    idx = torch.empty(n, dtype=torch.int32, device=src.device)
    cnt = (torch.empty(n, dtype=torch.int32, device=src.device) if counts
           else None)
    out = (best, idx, cnt) if counts else (best, idx)
    if n == 0:
        return out
    _cuda.launch(_library().nearest_neighbor, src, tgt_t, tsq, best, idx,
                 cnt, n, m)
    LAUNCHES["nearest_neighbor"] += 1
    return out


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
