"""The per-lane row gather D2 and its plain PyTorch version (port of the
Pallas kernel of ``benchmarks/profile_gather_modes.py``).

``lane_row_sum(ids, table)``: per lane ``b``, ``out[b, ...] = sum_c
table[b, ids[b, ...], c]`` over the 16 columns of a row. Ids index as
JAX's ``t[ids]`` does: a negative id counts from the end, then every id is
clamped into ``[0, cap)``. The 16 floats are added in a fixed tree, the
same in the kernel and the plain version, so the two agree bit for bit.

It takes CPU tensors to ``lane_row_sum_plain`` and launches the
hand-written CUDA kernel (``csrc/gather_kernels.cu``, sm_90a) for CUDA
tensors, at any shape, or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from toyslam_tpu_torch.ops import _cuda

ROW = 16  # f32 columns of a table row

# Kernel launches since the last reset; the wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"lane_row_sum": 0}

SOURCE = _cuda.CSRC / "gather_kernels.cu"
_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _row_tree_sum(rows):
    """Sum over the last axis (16) in the kernel's fixed tree: adjacent
    pairs, then adjacent pairs of those, down to one."""
    while rows.shape[-1] > 1:
        rows = rows[..., 0::2] + rows[..., 1::2]
    return rows[..., 0]


def lane_row_sum_plain(ids, table):
    """D2's function on any device: ``ids [B, ...]`` int, ``table
    [B, cap, 16]`` -> ``[B, ...]`` row sums."""
    lanes, cap = table.shape[0], table.shape[1]
    flat = ids.reshape(lanes, -1).long()
    flat = torch.where(flat < 0, flat + cap, flat).clamp(0, cap - 1)
    rows = table[torch.arange(lanes, device=ids.device)[:, None], flat]
    return _row_tree_sum(rows).reshape(ids.shape)


def _library():
    global _lib
    if _lib is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        _lib = _cuda.load(SOURCE, {"lane_row_sum": [p, p, p, i64, i64, i64,
                                                    p]})
    return _lib


def lane_row_sum(ids, table):
    """D2: ``ids [B, ...]`` int32, ``table [B, cap, 16]`` float32 ->
    ``[B, ...]`` float32, per lane the row sums of the rows that ``ids``
    names."""
    if _cuda.on_cpu("gather", ids, table):
        return lane_row_sum_plain(ids, table)
    lanes, cap = table.shape[0], table.shape[1]
    nk = ids[0].numel() if lanes else 0
    _cuda.check("table", table, torch.float32, (lanes, cap, ROW))
    _cuda.check("ids", ids, torch.int32, (lanes, *ids.shape[1:]))
    if lanes >= 2**16 or -(-nk // 256) >= 2**31 or cap >= 2**31:
        raise ValueError(f"{lanes} lanes x {nk} ids, cap {cap}: exceeds the "
                         f"kernel's grid")
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    if lanes == 0 or nk == 0:
        return out
    if cap == 0:
        raise ValueError("lane_row_sum: empty tables")
    _cuda.launch(_library().lane_row_sum, ids, table, out, lanes, nk, cap)
    LAUNCHES["lane_row_sum"] += 1
    return out
