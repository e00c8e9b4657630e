"""How accurately bf16 splits of f32 coordinates rank ``s . t`` on the card
(port of ``benchmarks/diag_bf16_concat.py``).

    python -m toyslam_tpu_torch.diag.diag_bf16_concat [--device cpu] [--n N]

Runs D1 (``ops/ranking_kernels.split_dot``) in each of its five modes on
the JAX script's inputs: ``default_rng(7)``, s and t uniform in +-120 m,
N = M = 16384. Each mode's largest error against a float64 NumPy oracle on
the leading 2048 x 2048 slab, relative to the slab's largest ``|s . t|``,
says whether the tensor cores sum the split products in f32 (``3pass`` and
``concat9`` then reach ~1e-5, ``concat6`` and ``bf16`` stay at bf16 level);
each mode is timed at N x N with CUDA events. Prints one JSON line,
``{mode: {"max_rel_err", "ms_per_pass"}, ..., "device": name}``; on the
CPU (``--device cpu``) the times are host-clock times of the plain version.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from toyslam_tpu_torch import diag
from toyslam_tpu_torch.ops import ranking_kernels

N_FULL = 16384  # the GICP nearest-neighbour shape of the JAX script
N_ACC = 2048  # the accuracy slab
ORDER = ("highest", "3pass", "concat9", "concat6", "bf16")  # the script's
REPS = 20


def inputs(n: int):
    """The JAX script's s [n, 3] and t [n, 3], float32."""
    rng = np.random.default_rng(7)
    s = rng.uniform(-120.0, 120.0, (n, 3)).astype(np.float32)
    t = rng.uniform(-120.0, 120.0, (n, 3)).astype(np.float32)
    return s, t


def oracle(s_np, t_np, n_acc: int = N_ACC):
    """float64 ``s . t`` on the leading ``n_acc`` rows and columns."""
    n_acc = min(n_acc, len(s_np), len(t_np))
    return s_np[:n_acc].astype(np.float64) @ t_np[:n_acc].T.astype(np.float64)


def run(n: int = N_FULL, device: str = "cuda", reps: int = REPS) -> dict:
    dev = diag.device(device)
    s_np, t_np = inputs(n)
    want = oracle(s_np, t_np)
    n_acc = want.shape[0]
    scale = float(np.abs(want).max())
    s_acc = torch.from_numpy(s_np[:n_acc]).to(dev)
    tt_acc = torch.from_numpy(np.ascontiguousarray(t_np[:n_acc].T)).to(dev)
    s = torch.from_numpy(s_np).to(dev)
    tt = torch.from_numpy(np.ascontiguousarray(t_np.T)).to(dev)
    results = {}
    for mode in ORDER:
        got = ranking_kernels.split_dot(s_acc, tt_acc, mode)
        rel = float(np.abs(got.double().cpu().numpy() - want).max()) / scale
        ms = diag.timed_ms(lambda m=mode: ranking_kernels.split_dot(s, tt, m),
                           dev, reps)
        results[mode] = {"max_rel_err": rel, "ms_per_pass": ms}
        print(f"{mode:8s}  max_rel_err={rel:.3e}   {ms:8.4f} ms/pass",
              file=sys.stderr)
    results["device"] = diag.device_name(dev)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N_FULL)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
