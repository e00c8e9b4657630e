"""The batched 3x3 eigensolver ``ops/eigh3.eigh3_soa`` as one launch of a
hand-written CUDA kernel (``csrc/eigh3_kernels.cu``, sm_90a).

``ops/eigh3.eigh3_soa`` takes CPU tensors to ``eigh3_soa_plain`` and CUDA
tensors here; there is no fallback. The kernel takes float32 and float64,
and gives the plain version's bits on the card, NaN and inf included. A
call is one device operation: the kernel writes one ``[12, *shape]``
tensor (the three eigenvalues, then the nine ``v[i][j]`` row-major) and
the returned tuples are views of its rows.

Each component is read at its own element stride, so the callers' strided
views (``cov[:, i, j]`` of a ``[N, 3, 3]`` tensor, ``unbind(-1)`` of a
``[B, V, 6]`` one) are not copied; a component whose elements lie at no
one stride in flattened order is copied first.
"""

from __future__ import annotations

import ctypes

import torch

from toyslam_tpu_torch.ops import _cuda

THREADS = 128  # kThreads in csrc/eigh3_kernels.cu

# Kernel launches since the last reset; the wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"eigh3": 0}

SOURCE = _cuda.CSRC / "eigh3_kernels.cu"
_ENTRY = {torch.float32: "eigh3_f32", torch.float64: "eigh3_f64"}
_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        sig = [p] * 6 + [i64] * 6 + [p, i64, ctypes.c_int, p]
        _lib = _cuda.load(SOURCE, {name: sig for name in _ENTRY.values()})
    return _lib


def flat_stride(t):
    """The element stride at which ``t``'s elements lie in flattened
    (row-major) order, or None when no one stride does."""
    stride = expect = None
    for size, st in zip(reversed(t.shape), reversed(t.stride())):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != expect:
            return None
        expect = st * size
    return 1 if stride is None else stride


def eigh3_soa_cuda(a00, a01, a02, a11, a12, a22, sweeps: int = 5):
    """``eigh3_soa`` on CUDA tensors of one float dtype (float32 or
    float64), broadcast together: one kernel launch."""
    comps = torch.broadcast_tensors(a00, a01, a02, a11, a12, a22)
    dtype = comps[0].dtype
    if dtype not in _ENTRY or any(c.dtype != dtype for c in comps):
        raise TypeError(f"eigh3: dtypes {[c.dtype for c in comps]}, the "
                        "kernel takes float32 or float64, all alike")
    shape = comps[0].shape
    n = comps[0].numel()
    if n >= 2**31:
        raise ValueError(f"{n} matrices exceed the kernel's int32 indexing")
    out = torch.empty((12, *shape), dtype=dtype, device=comps[0].device)
    if n:
        strides = [flat_stride(c) for c in comps]
        comps = [c if s is not None else c.contiguous()
                 for c, s in zip(comps, strides)]
        strides = [1 if s is None else s for s in strides]
        _cuda.launch(getattr(_library(), _ENTRY[dtype]), *comps, *strides,
                     out, n, int(sweeps))
        LAUNCHES["eigh3"] += 1
    return out[:3].unbind(0), out[3:].unbind(0)
