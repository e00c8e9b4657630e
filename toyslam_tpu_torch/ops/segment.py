"""Segment sums over sorted runs (port of what ``toyslam_tpu/ops/segtree.py``
computes).

The JAX module is a 128-lane two-level doubling tree that exists only to
avoid TPU scatters. Here a run of equal sorted keys is one segment of
``torch.segment_reduce``, which sums each segment sequentially in one
thread: the result does not depend on scheduling, so reruns and resumes
are bit-stable (no float ``index_add_``/``scatter_add_``). Summation order
differs from the JAX tree at the rounding level only.

Keys are int32, sorted ascending, with ``INT_MAX`` marking invalid lanes
(always the tail after a sort); invalid lanes belong to no segment.

The ``*_lanes`` forms take B independent rows of keys at once, [B, n]
(the fleet's lane axis; one cloud is B = 1): ``sort_lanes`` sorts each
row with one stable sort of lane-major int64 keys (of the int32 keys
themselves at B = 1), and one ``segment_reduce`` sums every row's runs.
Each row's sums are those of the same call on that row alone, bit for bit:
the same elements, added in the same order.
"""

from __future__ import annotations

import torch

INT_MAX = 2**31 - 1


def sort_lanes(keys):
    """Stable ascending sort of each row of ``keys [B, n]`` int32 in one
    sort: ``(sorted [B, n], order [B, n])`` with ``order`` indexing the
    flattened ``[B*n]`` input (row b's entries stay in row b). The int64
    key ``b * 2^32 + key`` keeps each row's signed order; one row sorts its
    int32 keys, half the radix passes, in the same order."""
    B = keys.shape[0]
    if B == 1:
        sorted_keys, order = torch.sort(keys.reshape(-1), stable=True)
        return sorted_keys.view(keys.shape), order.view(keys.shape)
    lane = torch.arange(B, dtype=torch.int64, device=keys.device)[:, None]
    _, order = torch.sort(((lane << 32) + keys.long()).reshape(-1),
                          stable=True)
    return keys.reshape(-1)[order].view(keys.shape), order.view(keys.shape)


def run_bookkeeping_lanes(keys):
    """Segment starts, per-element segment index and segment count of each
    row of sorted ``keys [B, n]``: ``(first [B, n] bool, pos [B, n] int64,
    n_unique [B] int64)``; ``pos`` of a row's invalid tail continues its
    last real segment's index (-1 in a row without one)."""
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    first &= keys != INT_MAX
    pos = torch.cumsum(first, 1) - 1
    n_unique = torch.clamp(pos[:, -1] + 1, min=0)
    return first, pos, n_unique


def seg_reduce_lanes(keys, vals, first, pos, num_segments: int):
    """Sums of ``vals [B, n, C]`` rows over the first ``num_segments`` runs
    of each row of sorted ``keys [B, n]``: ``(sums [B, S, C], starts [B, S]
    int64)``, ``starts`` indexing the flattened ``[B*n]`` elements. Runs
    that do not exist sum to zero and start at their row's first invalid
    element. No host synchronisation.

    One ``segment_reduce`` over all rows: row b owns segments b*(S+1) ..
    b*(S+1) + S, the last of them a gap that takes the row's runs beyond S
    and its invalid tail up to the next row's first element."""
    B, n = keys.shape
    S = num_segments
    dev = keys.device
    row0 = torch.arange(B, device=dev) * n
    n_valid = (keys != INT_MAX).sum(1)
    # starts[b, s] = flat index of run s of row b; S + 1 entries a row, the
    # last the start of the gap, then one dump slot for the runs beyond S
    # that ends up holding B*n, the end of the last gap.
    starts = (row0 + n_valid)[:, None].expand(B, S + 1).reshape(-1)
    starts = torch.cat([starts, starts[:1]])
    slot = torch.arange(B, device=dev)[:, None] * (S + 1) + pos
    idx = torch.where(first & (pos <= S), slot, B * (S + 1))
    starts.scatter_(0, idx.reshape(-1), torch.arange(B * n, device=dev))
    starts[B * (S + 1):].fill_(B * n)  # a fill, not a copy from the host
    sums = torch.segment_reduce(vals.reshape(B * n, -1).contiguous(), "sum",
                                offsets=starts, axis=0, unsafe=True)
    return (sums.view(B, S + 1, -1)[:, :S],
            starts[:-1].view(B, S + 1)[:, :S])


def seg_broadcast_lanes(seg_vals, pos):
    """Each element's segment value of every row: ``seg_vals [B, S, C]``
    at ``pos [B, n]`` -> [B, n, C] (rows past the kept segments read the
    last one; callers gate them)."""
    S = seg_vals.shape[1]
    return torch.gather(seg_vals, 1, pos.clamp(0, S - 1)[..., None].expand(
        -1, -1, seg_vals.shape[2]))
