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
"""

from __future__ import annotations

import torch

INT_MAX = 2**31 - 1


def run_bookkeeping(keys):
    """Segment starts, per-element segment index and segment count.

    Returns ``(first [n] bool, pos [n] int64, n_unique 0-d int64)``; ``pos``
    of the invalid tail continues the last real segment's index.
    """
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    first &= keys != INT_MAX
    pos = torch.cumsum(first, 0) - 1
    n_unique = torch.clamp(pos[-1] + 1, min=0)
    return first, pos, n_unique


def seg_reduce(keys, vals, first, pos, num_segments: int):
    """Sums of ``vals`` rows over the first ``num_segments`` runs.

    keys: [n] sorted int32; vals: [n, C]; ``first``/``pos`` from
    :func:`run_bookkeeping`. Returns ``(sums [num_segments, C], starts
    [num_segments] int64)``: runs that do not exist sum to zero and start at
    the first invalid lane. No host synchronisation.
    """
    n = keys.shape[0]
    S = num_segments
    n_valid = (keys != INT_MAX).sum()
    # starts[s] = first element of run s; S + 1 is a dump slot for the runs
    # beyond S, then holds n so that the last kept run ends where it should.
    starts = n_valid.expand(S + 2).clone()
    idx = torch.where(first & (pos <= S), pos, S + 1)
    starts.scatter_(0, idx, torch.arange(n, device=keys.device))
    starts[S + 1:].fill_(n)  # a fill, not a copy from the host
    sums = torch.segment_reduce(vals.contiguous(), "sum", offsets=starts,
                                axis=0, unsafe=True)
    return sums[:S], starts[:S]


def seg_broadcast(seg_vals, pos):
    """Each element's segment value: ``seg_vals[pos]`` (rows past the kept
    segments read the last one; callers gate them)."""
    return seg_vals[pos.clamp(0, seg_vals.shape[0] - 1)]
