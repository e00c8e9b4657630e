"""What each of K4's pass-2 skipping mechanisms buys, on the card.

    python -m toyslam_tpu_torch.diag.k4_ablation [--reps 50] [--rounds 4]

K4 (``nearest_neighbor`` in ``csrc/nn_kernels.cu``) skips, in its second
pass, the chunks of 64 target columns that cannot hold a candidate of any
of the warp's rows (the per-chunk bound, ``Skip``), and keeps far rows
(the padded rows of a warp that also holds valid ones) in a bound of their
own. This builds the kernel as it is and copies of its source with one or
both mechanisms taken out (``VARIANTS``), checks each against
``nearest_neighbor_plain`` bit for bit, and times each at register-65k
(the registration pair of ``chip_smoke.py``, 32768 x 32768) with the
diagnostics' spin-queued CUDA-event timer, the variants interleaved in
each round. Prints one JSON line, ``{"device", "problems": {problem:
{variant: {"bit_identical", "ms"}}}}``, ``ms`` one mean a round. Needs a
card and ``nvcc``; the copies build into ``toyslam_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from toyslam_tpu_torch import diag
from toyslam_tpu_torch.core import pointcloud
from toyslam_tpu_torch.ops import _cuda, nn_kernels
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

# Each edit replaces text that occurs once in csrc/nn_kernels.cu.
NO_CHUNK_SKIP = (
    ("return u >= kSkipChunks || !(chunk_min[0][u] > vw[0]) ||\n"
     "           !(chunk_min[1][u] > vw[1]);", "return true;"),
    ("      if (u < kSkipChunks) {", "      if (false) {"),
)
NO_FAR_CLASS = (("far[i][h] = off[i][h] > split;", "far[i][h] = false;"),)
VARIANTS = {
    "as_built": (),
    "no_chunk_skip": NO_CHUNK_SKIP,
    "no_far_class": NO_FAR_CLASS,
    "neither": NO_CHUNK_SKIP + NO_FAR_CLASS,
}
HEADER = '#include "mma_split.cuh"'


def variant_source(name: str) -> str:
    """The kernel source with the edits of ``VARIANTS[name]``, its header
    included by absolute path (the copy builds outside ``csrc/``)."""
    text = nn_kernels.SOURCE.read_text()
    edits = ((HEADER, f'#include "{_cuda.CSRC / "mma_split.cuh"}"'),
             *VARIANTS[name])
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {nn_kernels.SOURCE.name}")
        text = text.replace(old, new)
    return text


def problems(dev):
    """register-65k's K4 operands: the source at the identity guess with
    GICP's 1e9 sentinel, and moved by 0.2 m / 0.01 rad with ICP's 1e30."""
    xyzi, mask, _ = spinning_lidar_scans(1, 2, 32, 2048,
                                         fov_deg=(-30.67, 10.67))
    clouds = [pointcloud.pad_to(pointcloud.voxel_downsample(
        pointcloud.PointCloud(torch.from_numpy(xyzi[k]).to(dev),
                              torch.from_numpy(mask[k]).to(dev)), 0.1),
        32768) for k in range(2)]
    src = clouds[1].xyzi[:, :3].contiguous()
    c, s = np.cos(0.01), np.sin(0.01)
    rot = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                       dtype=torch.float32, device=dev)
    moved = (src @ rot.T + torch.tensor([0.2, -0.1, 0.05], device=dev))
    tgt, tmask = clouds[0].xyzi[:, :3], clouds[0].mask
    return {
        "identity_1e9": (src, *nn_kernels.target_operands(tgt, tmask, 1e9)),
        "moved_1e30": (moved.contiguous(),
                       *nn_kernels.target_operands(tgt, tmask, 1e30)),
    }


def build():
    """Builds every variant at once; returns {name: entry point}."""
    out_dir = _cuda.BUILD_DIR / "k4_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in VARIANTS:
        path = out_dir / f"nn_kernels_{name}.cu"
        path.write_text(variant_source(name))
        paths.append(path)
    _cuda.build(*paths)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    return {name: _cuda.load(path, {"nearest_neighbor": [p] * 6 + [i64] * 2
                                    + [p]}).nearest_neighbor
            for name, path in zip(VARIANTS, paths)}


def run(reps: int = 50, rounds: int = 4) -> dict:
    dev = diag.device("cuda")
    fns = build()
    out = {"device": diag.device_name(dev), "problems": {}}
    for pname, (src, tgt_t, tsq) in problems(dev).items():
        n, m = src.shape[0], tgt_t.shape[1]
        pbest, pidx = nn_kernels.nearest_neighbor_plain(src, tgt_t, tsq)
        best = torch.empty(n, device=dev)
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        res = {}
        for name, fn in fns.items():
            _cuda.launch(fn, src, tgt_t, tsq, best, idx, None, n, m)
            res[name] = {"bit_identical": bool(
                torch.equal(idx, pidx)
                and torch.equal(best.view(torch.int32),
                                pbest.view(torch.int32))), "ms": []}
        for _ in range(rounds):
            for name, fn in fns.items():
                res[name]["ms"].append(diag.timed_ms(
                    lambda f=fn: _cuda.launch(f, src, tgt_t, tsq, best, idx,
                                              None, n, m), dev, reps))
        for name, r in res.items():
            print(f"{pname} {name:14s} bit-identical {r['bit_identical']}  "
                  + " ".join(f"{t:.4f}" for t in r["ms"]) + " ms",
                  file=sys.stderr)
        out["problems"][pname] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.reps, args.rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
