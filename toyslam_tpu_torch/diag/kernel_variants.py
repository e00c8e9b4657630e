"""K6 at other block shapes, and D2 against its on-chip candidates, checked
and timed on the card.

    python -m toyslam_tpu_torch.diag.kernel_variants [--reps 50] [--rounds 3]

K6 (``gicp_terms``, ``csrc/gicp_kernels.cu``) takes kPer correspondences
in each of kThreads threads a block: ``K6_SHAPES`` builds copies of it at
other (kThreads, kPer), the first the shape as built. D2 (``lane_row_sum``,
``csrc/gather_kernels.cu``) reads its rows through L2; ``diag/
gather_candidates.cu`` holds designs that keep a lane's table on chip
(``cluster_read``, ``owner_filter``) and one that reads a row with four
lanes (``four_lanes_a_row``), built at the block shapes of
``CLUSTER_SHAPES`` and ``OWNER_SHAPES``; ``ABLATIONS`` are D2 and the owner
design with a part taken out (their sums are not D2's).

Each copy is checked against its plain version (K6 within ``TERMS_RTOL``
of each group's largest sum and bit-identical on a rerun; D2 and its
candidates bit for bit) and timed with the diagnostics' spin-queued
CUDA-event timer, the copies interleaved in each round: K6 at
register-65k (``gicp_call_ops.operands``), D2 at the fleet's shape
(``profile_gather_modes.inputs``) warm and with the L2 cache flushed
before each call. Prints one JSON line, ``{"device", "card", "k6":
{shape: {"ok", "ms"}}, "d2": {name: {"ok", "ms", "cold_ms"}}}``, ``ms`` one
mean a round. Needs a card and ``nvcc``; the copies build into
``toyslam_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from toyslam_tpu_torch import diag
from toyslam_tpu_torch.diag import gicp_call_ops, profile_gather_modes
from toyslam_tpu_torch.ops import _cuda, gather_kernels, gicp_kernels

TERMS_RTOL = 1e-4  # chip_smoke.py's bound for K6 against its plain version
K6_SHAPES = ((128, 2), (64, 4), (128, 1), (256, 1), (256, 2), (128, 4))
K6_GROUPS = (slice(0, 6), slice(6, 12), slice(12, 21), slice(21, 27))
CANDIDATES = Path(__file__).resolve().parent / "gather_candidates.cu"
# (blocks a cluster, threads a block, ids a thread at once)
CLUSTER_SHAPES = ((8, 512, 2), (8, 512, 1), (8, 512, 4), (8, 256, 4),
                  (8, 1024, 2), (4, 512, 2))
# (blocks a group, threads a block, ids a thread at once)
OWNER_SHAPES = ((4, 1024, 4), (4, 1024, 8), (4, 512, 8), (4, 512, 16),
                (6, 1024, 8), (8, 512, 8), (8, 1024, 8))
# name -> (source, entry point, edits)
ABLATIONS = {
    "l2_ids_and_sums_only": (gather_kernels.SOURCE, "lane_row_sum", (
        ("out[lane * nk + i] =\n      __fadd_rn(__fadd_rn(sum4(q0), sum4(q1)),"
         " __fadd_rn(sum4(q2), sum4(q3)));",
         "out[lane * nk + i] = static_cast<float>(id);"),)),
    "owner_slice_copy_only": (CANDIDATES, "owner_filter", (
        ("for (; i0 < nk; i0 += step) {", "for (; i0 < 0; i0 += step) {"),)),
    "owner_no_row_reads": (CANDIDATES, "owner_filter", (
        ("row_sum(slice + (e >> 9) * 4);", "static_cast<float>(e);"),)),
}


def _edited(source, edits):
    text = source.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} occurs {text.count(old)} times in "
                             f"{source.name}")
        text = text.replace(old, new)
    return text


def _constants(names, values):
    """Edits that set the candidates' constexpr ``names`` to ``values``."""
    lines = CANDIDATES.read_text().splitlines()
    return tuple((next(ln for ln in lines
                       if ln.startswith(f"constexpr int {name} = ")),
                  f"constexpr int {name} = {value};")
                 for name, value in zip(names, values))


def k6_source(threads, per):
    return _edited(gicp_kernels.SOURCE, (
        ('#include "block_sum.cuh"',
         f'#include "{_cuda.CSRC / "block_sum.cuh"}"'),
        (f"constexpr int kThreads = {gicp_kernels.THREADS};",
         f"constexpr int kThreads = {threads};"),
        (f"constexpr int kPer = {gicp_kernels.PER_THREAD};",
         f"constexpr int kPer = {per};")))


def _copies():
    """{(kind, name): (source text, entry point)} of every copy."""
    out = {("k6", f"{t}x{p}"): (k6_source(t, p), "gicp_terms")
           for t, p in K6_SHAPES}
    out["d2", "four_lanes_a_row"] = (CANDIDATES.read_text(),
                                     "four_lanes_a_row")
    for shape in CLUSTER_SHAPES:
        out["d2", "cluster_read_" + "x".join(map(str, shape))] = (
            _edited(CANDIDATES, _constants(
                ("kCluster", "kClusterThreads", "kIds"), shape)),
            "cluster_read")
    for shape in OWNER_SHAPES:
        out["d2", "owner_filter_" + "x".join(map(str, shape))] = (
            _edited(CANDIDATES, _constants(
                ("kGroup", "kGroupThreads", "kGroupIds"), shape)),
            "owner_filter")
    for name, (source, entry, edits) in ABLATIONS.items():
        out["ablation", name] = (_edited(source, edits), entry)
    return out


def build():
    """Builds every copy at once; returns {(kind, name): entry point}."""
    out_dir = _cuda.BUILD_DIR / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    copies = _copies()
    paths = {}
    for (kind, name), (text, _) in copies.items():
        paths[kind, name] = out_dir / f"{kind}_{name}.cu"
        paths[kind, name].write_text(text)
    _cuda.build(*paths.values())
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    fns = {}
    for key, (_, entry) in copies.items():
        args = ([p] * 8 + [i64, i64, p] if entry == "gicp_terms"
                else [p] * 3 + [i64] * 3 + [p])
        fns[key] = getattr(_cuda.load(paths[key], {entry: args}), entry)
    return fns


def _k6_call(fn, shape, args):
    threads, per = map(int, shape.split("x"))
    n = args[1].shape[1]
    blocks = -(-n // (threads * per))
    out, partials, counter = _cuda.grid_sum_buffers(
        args[1].device, gicp_kernels.N_TERMS, gicp_kernels.SLOTS, blocks)
    _cuda.launch(fn, *args, partials, out, counter, n, blocks)
    return out


def _k6_ok(got, again, want):
    """Within TERMS_RTOL of the plain sums, and a rerun bit-identical."""
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    got, want = got.double().cpu(), want.double().cpu()
    rel = max(float((got[sl] - want[sl]).abs().max()
                    / want[sl].abs().max().clamp(min=1e-30))
              for sl in K6_GROUPS)
    return same and rel <= TERMS_RTOL


def run(reps: int = 50, rounds: int = 3) -> dict:
    dev = diag.device("cuda")
    fns = build()
    _, _, args = gicp_call_ops.operands(dev)
    want = gicp_kernels.gicp_terms_plain(*args)
    k6_calls = {name: (lambda f=fn, s=name: _k6_call(f, s, args))
                for (kind, name), fn in fns.items() if kind == "k6"}
    k6 = {}
    for name, call in k6_calls.items():
        got = call().clone()
        k6[name] = {"ok": _k6_ok(got, call(), want), "ms": []}

    table_np, ids_np, _ = profile_gather_modes.inputs()
    tab = torch.from_numpy(table_np).to(dev)
    ids = torch.from_numpy(ids_np).to(dev)
    lanes, cap, nk = tab.shape[0], tab.shape[1], ids.shape[1]
    d2_want = gather_kernels.lane_row_sum_plain(ids, tab).view(torch.int32)
    out = torch.empty_like(ids, dtype=torch.float32)

    def shipped():
        out.copy_(gather_kernels.lane_row_sum(ids, tab))

    d2_calls = {"lane_row_sum": shipped}
    for (kind, name), fn in fns.items():
        if kind != "k6":
            d2_calls[name] = (lambda f=fn: _cuda.launch(
                f, ids, tab, out, lanes, nk, cap))
    d2 = {}
    for name, call in d2_calls.items():
        out.zero_()
        call()
        d2[name] = {"ok": bool(torch.equal(out.view(torch.int32), d2_want)),
                    "ms": [], "cold_ms": []}
    d2_calls["lane_row_sum"] = lambda: gather_kernels.lane_row_sum(ids, tab)
    for _ in range(rounds):
        for name, call in k6_calls.items():
            k6[name]["ms"].append(diag.timed_ms(call, dev, reps))
        for name, call in d2_calls.items():
            d2[name]["ms"].append(diag.timed_ms(call, dev, reps))
            d2[name]["cold_ms"].append(diag.timed_cold_ms(call, dev, reps))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return {"device": diag.device_name(dev), "card": card, "k6": k6,
            "d2": d2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.reps, args.rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
