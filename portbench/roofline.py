"""Peaks of the card and the least time of the kernels the benchmark
rates.

The peaks are NVIDIA's published dense rates of one H100 SXM5 at its
700 W limit. A kernel's least time counts the work its inputs need, not
how a kernel does it, so that no redesign of the kernel can read over
100 %.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense (no sparsity).
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12, "fp8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12

# A nearest-neighbour pair: |s - t|^2 is 3 subtractions, 3 products and
# 2 additions.
NN_OPS_PER_PAIR = 8


def nearest_neighbor_ops(n_src_valid: int, n_tgt_valid: int) -> int:
    """Operations one nearest-neighbour search (K4) needs: every valid
    source point against every valid target point."""
    return NN_OPS_PER_PAIR * n_src_valid * n_tgt_valid


def nearest_neighbor_bytes(n_src: int, n_tgt: int) -> int:
    """Bytes it needs to move: f32 source [n, 3] and target [3, m] plus
    |t|^2 [m] read once, the f32 distance and int32 index [n] written
    once (padded rows included: the kernel is handed them)."""
    return 4 * (3 * n_src + 4 * n_tgt) + 8 * n_src


def nearest_neighbor_least_s(n_src_valid: int, n_tgt_valid: int,
                             n_src: int, n_tgt: int) -> float:
    """The least time of one search on the card: the larger of its
    operations at the bf16 tensor-core peak (the fastest rate any
    implementation could compute these products at) and its bytes at the
    memory peak."""
    return max(nearest_neighbor_ops(n_src_valid, n_tgt_valid)
               / PEAK_FLOPS["bf16"],
               nearest_neighbor_bytes(n_src, n_tgt) / PEAK_BYTES_PER_S)
