"""The bf16-split ranking product D1 and its plain PyTorch version (port of
the Pallas kernel of ``benchmarks/diag_bf16_concat.py``).

``split_dot(s, t_t, mode)`` computes ``s @ t_t`` ([N, 3] x [3, M] -> [N, M]
float32) in one of ``MODES``: ``highest`` in f32; ``bf16`` as
``s_hi . t_hi``; ``3pass`` as the three products ``s_hi . t_hi``,
``s_hi . t_lo`` and ``s_lo . t_hi`` added in that order; ``concat6`` as one
depth-6 product ``[s_hi | s_lo] . [t_hi ; t_hi]`` (it drops the ``t_lo``
terms); ``concat9`` as one depth-9 product
``[s_hi | s_hi | s_lo] . [t_hi ; t_lo ; t_hi]``. ``split2`` gives the hi
and lo parts.

It takes CPU tensors to ``split_dot_plain`` and launches the hand-written
CUDA kernel (``csrc/ranking_kernels.cu``, sm_90a) for CUDA tensors, at any
shape, or raises; there is no fallback. The kernel runs the four split
modes on the tensor cores (``mma.sync`` m16n8k16, bf16 in, f32
accumulate): how the tensor core sums the exact bf16 products is what the
diagnostic ``toyslam_tpu_torch.diag.diag_bf16_concat`` measures. So only
``highest`` equals its plain version bit for bit; the others agree to the
rounding of a sum of exact products.
"""

from __future__ import annotations

import ctypes

import torch

from toyslam_tpu_torch.ops import _cuda

MODES = ("highest", "bf16", "3pass", "concat6", "concat9")

# Kernel launches since the last reset, by mode; the wrapper adds one where
# it launches its kernel and nowhere else.
LAUNCHES = {mode: 0 for mode in MODES}

SOURCE = _cuda.CSRC / "ranking_kernels.cu"
_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def split2(x):
    """(hi, lo) bf16 parts of float32 ``x``: ``hi = bf16(x)``,
    ``lo = bf16(x - f32(hi))`` (``toyslam_tpu/ops/nn_pallas._split2``)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def split_operands(s, t_t, mode):
    """The f32 operands of a split mode: a list of ``(A [N, K], B [K, M])``
    products whose results are added in order (three for ``3pass``, one for
    the others). Every entry is an exact bf16 value."""
    (sh, sl), (th, tl) = split2(s), split2(t_t)
    sh, sl, th, tl = (p.float() for p in (sh, sl, th, tl))
    if mode == "bf16":
        return [(sh, th)]
    if mode == "3pass":
        return [(sh, th), (sh, tl), (sl, th)]
    if mode == "concat6":
        return [(torch.cat([sh, sl], 1), torch.cat([th, th], 0))]
    if mode == "concat9":
        return [(torch.cat([sh, sh, sl], 1), torch.cat([th, tl, th], 0))]
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _sum_of_products(a, b):
    """``a @ b`` with the depth summed in order, each product and sum
    rounded on its own."""
    acc = a[:, 0:1] * b[0]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k]
    return acc


def split_dot_plain(s, t_t, mode):
    """D1's function on any device. ``highest`` rounds each f32 product and
    sum in the kernel's order; the split modes take the bf16 parts upcast to
    f32, whose products are exact, and sum them in depth order."""
    if mode == "highest":
        return _sum_of_products(s, t_t)
    st = None
    for a, b in split_operands(s, t_t, mode):
        p = _sum_of_products(a, b)
        st = p if st is None else st + p
    return st


def sum_error(got, s, t_t, mode):
    """How a split mode's result ``got`` misses the exact sum of its own
    bf16 products: ``[N, M]`` f64 ``|got - sum_k a_k b_k| / sum_k |a_k
    b_k|`` (the products are exact in f64 and their f64 sum misses by
    ~2^-52 of the magnitudes). On the card it is the tensor core's
    accumulation error, which K4's margin bounds (``csrc/nn_kernels.cu``)."""
    exact = mags = None
    for a, b in split_operands(s, t_t, mode):
        a, b = a.double(), b.double()
        e, g = a @ b, a.abs() @ b.abs()
        exact, mags = (e, g) if exact is None else (exact + e, mags + g)
    # 0 / 0 (no nonzero product, no error) is 0.
    return ((got.double() - exact).abs() / mags).nan_to_num(
        nan=0.0, posinf=float("inf"))


def _library():
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        _lib = _cuda.load(SOURCE, {
            "split_dot": [p, p, p, i64, i64, ctypes.c_int, p]})
    return _lib


def split_dot(s, t_t, mode):
    """D1: ``s [N, 3]``, ``t_t [3, M]`` float32 -> ``[N, M]`` float32
    ``s . t_t`` under ``mode`` (see the module docstring)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if _cuda.on_cpu("ranking", s, t_t):
        return split_dot_plain(s, t_t, mode)
    n, m = s.shape[0], t_t.shape[-1]
    _cuda.check("s", s, torch.float32, (n, 3))
    _cuda.check("t_t", t_t, torch.float32, (3, m))
    if -(-n // 64) * -(-m // 256) >= 2**31 or max(n, m) >= 2**31:
        raise ValueError(f"{n} x {m} exceeds the kernel's grid")
    out = torch.empty((n, m), dtype=torch.float32, device=s.device)
    if n == 0 or m == 0:
        return out
    _cuda.launch(_library().split_dot, s, t_t, out, n, m, MODES.index(mode))
    LAUNCHES[mode] += 1
    return out
