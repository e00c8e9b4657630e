"""Row-gather cost on the card, in ns/row (port of
``benchmarks/profile_gather_modes.py``).

    python -m toyslam_tpu_torch.diag.profile_gather_modes [--device cpu]
        [--lanes B] [--cap CAP] [--nk NK]

At the fleet's stats-fetch shape (the JAX script's: 64 lanes, a [8192, 16]
float32 table per lane, 57344 ids per lane, ``default_rng(0)``), every mode
sums each gathered row to one float, so the gather cannot be skipped:

  a) single-lane indexing, ``t[ids].sum(1)`` with 8 x NK ids, at table
     sizes cap, 4 cap, 64 cap and 256 cap rows (8192 .. 2097152 at the
     fleet's cap: 512 KiB, which fits in L2, to 128 MiB, which spills);
  b) batched indexing, ``tab[lane, ids].sum(-1)``;
  b2) the batched gather alone, materialising the [B, NK, 16] rows that
     the fleet's regather loop carries;
  c) flat indexing into the [B * cap, 16] table;
  d) the D2 kernel (``ops/gather_kernels.lane_row_sum``) at the fleet's
     shape, and on each single-lane table of (a) as one lane.

(a)-(c) are PyTorch indexing, the library yardstick for D2. Times are CUDA
events over repeated calls on the same ids (the tables stay as warm as L2
keeps them). Prints one JSON line of ``*_ns_per_row`` keys, ``flat_matches``
(c agrees with b), ``kernel_matches`` (d equals its plain version bit for
bit) and ``device``; on the CPU the times are host-clock times of the plain
versions.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from toyslam_tpu_torch import diag
from toyslam_tpu_torch.ops import gather_kernels

LANES, CAP, NK = 64, 8192, 57344
SINGLE_IDS = 8  # single-lane ids per fleet lane's NK
REPS = 20


def single_rows(cap: int):
    return (cap, 4 * cap, 64 * cap, 256 * cap)


def inputs(lanes: int = LANES, cap: int = CAP, nk: int = NK):
    """The JAX script's arrays, drawn in its order: the fleet's tables
    [lanes, cap, 16] and ids [lanes, nk], then per single-lane size a
    table [rows, 16] and SINGLE_IDS * nk ids."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(lanes, cap, 16)).astype(np.float32)
    ids = rng.integers(0, cap, size=(lanes, nk)).astype(np.int32)
    singles = [(rng.normal(size=(rows, 16)).astype(np.float32),
                rng.integers(0, rows, size=(SINGLE_IDS * nk,)).astype(
                    np.int32)) for rows in single_rows(cap)]
    return table, ids, singles


def run(lanes: int = LANES, cap: int = CAP, nk: int = NK,
        device: str = "cuda", reps: int = REPS) -> dict:
    dev = diag.device(device)
    table_np, ids_np, singles = inputs(lanes, cap, nk)
    tab = torch.from_numpy(table_np).to(dev)
    ids = torch.from_numpy(ids_np).to(dev)
    ids_l = ids.long()
    lane = torch.arange(lanes, device=dev)[:, None]
    res = {}

    def ns_per_row(fn, rows):
        return 1e6 * diag.timed_ms(fn, dev, reps) / rows

    for t_np, i_np in singles:  # (a), and (d) on one lane
        t1 = torch.from_numpy(t_np).to(dev)
        i1 = torch.from_numpy(i_np).to(dev)
        i1_l = i1.long()
        rows = len(t_np)
        res[f"single_tab{rows}_ns_per_row"] = ns_per_row(
            lambda: t1[i1_l].sum(1), i1.numel())
        res[f"kernel_tab{rows}_ns_per_row"] = ns_per_row(
            lambda: gather_kernels.lane_row_sum(i1[None], t1[None]),
            i1.numel())
        del t1, i1, i1_l

    n_rows = lanes * nk
    res["batched_ns_per_row"] = ns_per_row(
        lambda: tab[lane, ids_l].sum(-1), n_rows)
    res["batched_carry_ns_per_row"] = ns_per_row(
        lambda: tab[lane, ids_l], n_rows)
    flat_tab = tab.reshape(lanes * cap, 16)
    offset = lane * cap

    def flat():
        return flat_tab[ids_l + offset].sum(-1)

    res["flat_ns_per_row"] = ns_per_row(flat, n_rows)
    batched = tab[lane, ids_l].sum(-1)
    res["flat_matches"] = bool(torch.allclose(flat(), batched, rtol=1e-6,
                                              atol=1e-4))
    res["kernel_ns_per_row"] = ns_per_row(
        lambda: gather_kernels.lane_row_sum(ids, tab), n_rows)
    got = gather_kernels.lane_row_sum(ids, tab)
    want = gather_kernels.lane_row_sum_plain(ids, tab)
    res["kernel_matches"] = bool(torch.equal(got.view(torch.int32),
                                             want.view(torch.int32)))
    res["device"] = diag.device_name(dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--nk", type=int, default=NK)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.lanes, args.cap, args.nk, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
