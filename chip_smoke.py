#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``toyslam_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each against its plain PyTorch
version on the card. Then it drives two paths through the entry points a
user calls, each with the launch counts set to 0 just before it and read
just after:

- NDT: one exact-mode ``ndt_align`` (the align.cpp configuration) and
  ``ndt_odometry`` under the shipped ``OdometryConfig`` over 16 generated
  262144-ray scans (kernels K1-K3);
- registration: ``gicp_align`` and ``icp_align`` on the generated 32 x
  2048-ray pair, downsampled at 0.1 m and padded to 32768 points (K4-K6).

It checks that every align converged and improved on its identity guess
against the generated ground truth, that the kernels were launched, that
the results match the same runs through the plain versions and are
bit-identical on a rerun, counts the host syncs, and prints the timings
with the card's name and power limit. The line before the card's line is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before it. There is no CPU path: without a CUDA
device the script exits with 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path
from unittest import mock

import numpy as np

ODO_SCANS = 16  # 64 x 4096 = 262144 rays each
ALIGN_RAYS = (32, 2048)  # the ~65k-point HDL-32-class single-align pair
ALIGN_FOV = (-30.67, 10.67)
REG_CAPACITY = 32768  # the 0.1 m pair's 27201/27316 points, nothing cut
REPS = 20  # timed launches per kernel, after warm-up
TERMS_RTOL = 1e-4  # K1/K3/K6 sums vs plain, relative to the group's largest
PAIRS_TOL_M, PAIRS_TOL_RAD = 1e-3, 1e-4  # kernel vs plain odometry poses
NN_SHARE = 0.999  # K4 rows with the plain index; K5 entries within 1 ulp
TIE_RTOL = 1e-6  # a K4 row that differs must be a tie to this, relative
GICP_TOL_M, GICP_TOL_RAD = 1e-4, 1e-4  # kernel vs plain GICP pose
ICP_TOL_M, ICP_TOL_RAD = 1e-3, 1e-3  # kernel vs plain ICP pose
# Sanity bounds against ground truth (the data, not the port, limits the
# accuracy: an align can settle in a local minimum on the ring-sampled
# ground). Zero-motion estimates would give a 4.5 m ATE.
PAIR_MEDIAN_MAX_M = 0.02  # median per-scan relative translation error
ATE_MAX_M = 1.0
# The card's published peaks (H100 SXM at 700 W) for the bounds.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Operations per pair, counted from the kernel sources: the NDT terms
# (csrc/ndt_kernels.cu pair_terms, ~388) plus the block sum's 28 adds; the
# GICP terms (csrc/gicp_kernels.cu pair_terms, ~117) plus 27 adds; the
# ranked distance (3 mul, 2 add, 1 mul, 1 sub, 1 compare or subtract).
NDT_FLOPS_PER_PAIR = 416
GICP_FLOPS_PER_PAIR = 144
NN_FLOPS_PER_PAIR = 8
NDT_SRC = "toyslam_tpu_torch/csrc/ndt_kernels.cu"
NN_SRC = "toyslam_tpu_torch/csrc/nn_kernels.cu"
GICP_SRC = "toyslam_tpu_torch/csrc/gicp_kernels.cu"
KERNELS = {  # name -> (source, Pallas kernel it replaces)
    "ndt_terms_gathered": (NDT_SRC, "toyslam_tpu/ops/ndt_pallas.py:271"),
    "ndt_gather_repack": (NDT_SRC, "toyslam_tpu/ops/ndt_pallas.py:323"),
    "ndt_terms_packed": (NDT_SRC, "toyslam_tpu/ops/ndt_pallas.py:355"),
    "nearest_neighbor": (NN_SRC, "toyslam_tpu/ops/nn_pallas.py:197"),
    "neg_dist_bf16": (NN_SRC, "toyslam_tpu/ops/nn_pallas.py:152"),
    "gicp_terms": (GICP_SRC, "toyslam_tpu/ops/gicp_pallas.py:104"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS):
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=5):
    """Mean host-clock milliseconds per call, each closed by a sync."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.mean(times)), out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def count_syncs(fn):
    """Runs fn with PyTorch's sync debug mode on; returns (result, {line of
    the port that led to it: synchronising calls reported there})."""
    import torch

    import toyslam_tpu_torch

    pkg = str(Path(toyslam_tpu_torch.__file__).resolve().parent)
    where = {}

    def record(message, category, filename, lineno, *rest):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if str(Path(f.filename).resolve()).startswith(pkg)]
        f = ours[-1] if ours else None
        key = (f"{'/'.join(Path(f.filename).parts[-2:])}:{f.lineno}" if f
               else f"{'/'.join(Path(filename).parts[-2:])}:{lineno}")
        where[key] = where.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, where


def device_profile(fn, top=6):
    """One call of fn under torch.profiler: (wall ms, device busy ms,
    launches, [(kernel, calls, device ms)] of the top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    return (wall, sum(r[2] for r in rows), sum(r[1] for r in rows),
            rows[:top])


def host_wait_ms(fn, spin_ms=50.0):
    """Host milliseconds that fn takes while the card spins for spin_ms on
    work queued before it: about spin_ms if fn waits on the device
    (a sync hidden in a library call), a fraction of it if not."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * spin_ms / start.elapsed_time(end))
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    fn()
    waited = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return waited


def terms_err(got, want, groups):
    """Max error of the sums, each relative to the largest of its group."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    worst, abs_err = 0.0, 0.0
    for sl in groups:
        diff = np.abs(got[sl] - want[sl])
        abs_err = max(abs_err, float(diff.max()))
        worst = max(worst, float(diff.max() / max(np.abs(want[sl]).max(),
                                                   1e-30)))
    return worst, abs_err


NDT_GROUPS = (slice(0, 1), slice(1, 7), slice(7, 28))
GN_GROUPS = (slice(0, 6), slice(6, 12), slice(12, 21), slice(21, 27))


def rotation_angle(Ra, Rb):
    """Angle between two rotations from ||Ra - Rb||_F = 2 sqrt(2) sin(a/2)
    (arccos of the trace loses small angles to rounding)."""
    s = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))
    return float(2.0 * np.arcsin(min(s, 1.0)))


def pose_diff(Ta, Tb):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    return (float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])),
            rotation_angle(Ta[:3, :3], Tb[:3, :3]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.ops import _cuda, gicp_kernels, ndt_kernels
    from toyslam_tpu_torch.ops import nn_kernels
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import gicp, icp, ndt
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 1. Build, one nvcc per source, all at once.
    t0 = time.perf_counter()
    libs = _cuda.build(ndt_kernels.SOURCE, nn_kernels.SOURCE,
                       gicp_kernels.SOURCE)
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(lib.name for lib in libs)})")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # Scans: 16 x 262144 rays for odometry, 2 x 65536 for the single aligns.
    t0 = time.perf_counter()
    xyzi, mask, gt = spinning_lidar_scans(0, ODO_SCANS)
    a_xyzi, a_mask, a_gt = spinning_lidar_scans(1, 2, *ALIGN_RAYS,
                                                fov_deg=ALIGN_FOV)
    print(f"scans generated on the host: {time.perf_counter() - t0:.1f} s, "
          f"{xyzi.shape[1]} and {a_xyzi.shape[1]} rays per scan")
    scans = torch.from_numpy(xyzi).to(dev)
    scan_mask = torch.from_numpy(mask).to(dev)
    cfg = odometry.OdometryConfig()
    ds = [pointcloud.voxel_downsample(
        pointcloud.PointCloud(scans[k], scan_mask[k]), cfg.scan_leaf,
        xyzi.shape[1], with_intensity=False) for k in range(ODO_SCANS)]
    counts = [int(c.mask.sum()) for c in ds]
    print(f"0.3 m voxels per scan: min {min(counts)} max {max(counts)} "
          f"(work_capacity {cfg.work_capacity})")
    check(4000 <= min(counts) and max(counts) <= cfg.work_capacity,
          "scan voxel counts outside [4000, work_capacity]")

    # 2. K1-K3 against their plain versions on the card, at the odometry
    #    shapes (N = work_capacity, K = 7, grid 1 << 15).
    src = pointcloud.voxel_downsample(
        pointcloud.PointCloud(scans[1], scan_mask[1]), cfg.scan_leaf,
        cfg.work_capacity, with_intensity=False)
    m = ndt.build_ndt_map(pointcloud.pad_to(ds[0], cfg.work_capacity),
                          cfg.ndt)
    d1, d2, _ = ndt.gauss_coefficients(cfg.ndt.resolution,
                                       cfg.ndt.outlier_ratio)
    ev = ndt._Evaluator(m, src.xyzi[:, :3], src.mask, cfg.ndt.resolution,
                        ndt._OFFSETS[cfg.ndt.search_method], d1, d2)
    rel = np.linalg.inv(gt[0]) @ gt[1]
    p = ndt.se3.matrix_to_pose6(torch.from_numpy(rel)).numpy().astype(
        np.float32)
    params = ev.params(p)
    h, nvid, okm = ev.neighbor_hash(params)
    table = m.hash_table
    print(f"phase 2 shapes: N {ev.xyz.shape[1]} K {ev.K} pairs {h.numel()} "
          f"table {tuple(table.shape)}")
    err = {}
    stats = ndt_kernels.ndt_gather_repack(table, h, nvid, okm)
    stats_plain = ndt_kernels.ndt_gather_repack_plain(table, h, nvid, okm)
    torch.cuda.synchronize()
    check(torch.equal(stats.view(torch.int32), stats_plain.view(torch.int32)),
          "K2 ndt_gather_repack is not bit-identical to its plain version")
    err["ndt_gather_repack"] = float((stats - stats_plain).abs().max())
    gate_share = float(stats[9].mean())
    for name, got, want in (
            ("ndt_terms_packed",
             ndt_kernels.ndt_terms_packed(params, ev.xyz, stats),
             ndt_kernels.ndt_terms_packed_plain(params, ev.xyz, stats)),
            ("ndt_terms_gathered",
             ndt_kernels.ndt_terms_gathered(params, ev.xyz, table, h, nvid,
                                            okm),
             ndt_kernels.ndt_terms_gathered_plain(params, ev.xyz, table, h,
                                                  nvid, okm))):
        rel_err, err[name] = terms_err(got, want, NDT_GROUPS)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite sums")
        check(rel_err <= TERMS_RTOL,
              f"{name}: relative error {rel_err:.3g} > {TERMS_RTOL}")
        print(f"  {name}: max rel err {rel_err:.3g} (bound {TERMS_RTOL}), "
              f"max abs err {err[name]:.3g}")
    print(f"phase 2 kernels vs plain: ok (K2 bit-identical, gate open on "
          f"{gate_share:.3f} of pairs)")

    # NDT path: counts reset, then the exact align and the odometry.
    ndt_kernels.reset_launch_counts()
    a_src = [pointcloud.voxel_downsample(pointcloud.PointCloud(
        torch.from_numpy(a_xyzi[k]).to(dev),
        torch.from_numpy(a_mask[k]).to(dev)), 0.1) for k in range(2)]
    a_counts = [int(c.mask.sum()) for c in a_src]
    acfg = ndt.NDTConfig()
    amap = ndt.build_ndt_map(a_src[0], acfg)
    res = ndt.ndt_align(amap, a_src[1], torch.eye(4), acfg)
    a_rel = np.linalg.inv(a_gt[0]) @ a_gt[1]
    a_err = float(np.linalg.norm(res.transform.numpy()[:3, 3]
                                 - a_rel[:3, 3]))
    print(f"phase 3 exact align: {a_counts} points after the 0.1 m "
          f"downsample, converged {res.converged}, iterations "
          f"{res.iterations}, evaluations {res.evaluations}, host syncs "
          f"{res.host_syncs}, translation error vs ground truth {a_err:.4g} m")
    check(res.converged, "exact align did not converge")
    check(bool(torch.isfinite(res.transform).all())
          and a_err < np.linalg.norm(a_rel[:3, 3]),
          "exact align did not improve on its identity guess")

    t0 = time.perf_counter()
    out = odometry.ndt_odometry(scans, scan_mask, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ndt_kernels.LAUNCHES)
    print(f"launches in the NDT path: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the NDT path was never launched")
    check(bool(out.converged.all()), "an odometry align did not converge")
    poses = out.poses.double().numpy()
    check(np.isfinite(poses).all(), "non-finite odometry poses")
    gt_rel = np.linalg.inv(gt[0]) @ gt
    ate = np.linalg.norm(poses[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
    pair_err = [float(np.linalg.norm(
        out.pairwise[k].double().numpy()[:3, 3]
        - (np.linalg.inv(gt[k - 1]) @ gt[k])[:3, 3]))
        for k in range(1, ODO_SCANS)]
    print(f"phase 4 odometry: {ODO_SCANS} scans in {first_s:.2f} s (first "
          f"run), iterations {out.iterations.tolist()}, evaluations "
          f"{out.evaluations.tolist()}, gathers {out.gathers.tolist()}")
    print(f"  ATE vs ground truth: rmse {np.sqrt((ate ** 2).mean()):.4g} m, "
          f"max {ate.max():.4g} m; per-scan relative translation error "
          f"median {np.median(pair_err):.4g} m, max {max(pair_err):.4g} m")
    check(ate.max() < ATE_MAX_M and np.median(pair_err) < PAIR_MEDIAN_MAX_M,
          "odometry far from the ground truth")

    ndt_names = ("ndt_terms_gathered", "ndt_gather_repack",
                 "ndt_terms_packed")
    plain = {name: getattr(ndt_kernels, name + "_plain")
             for name in ndt_names}
    with mock.patch.multiple(ndt_kernels, **plain):
        out_plain = odometry.ndt_odometry(scans, scan_mask, cfg)
    pp = out_plain.poses.double().numpy()
    dt_max = float(np.abs(pp[:, :3, 3] - poses[:, :3, 3]).max())
    dr_max = max(rotation_angle(a[:3, :3], b[:3, :3])
                 for a, b in zip(pp, poses))
    print(f"  kernels vs plain versions on the card: max {dt_max:.3g} m, "
          f"{dr_max:.3g} rad (bounds {PAIRS_TOL_M} m, {PAIRS_TOL_RAD} rad)")
    check(dt_max <= PAIRS_TOL_M and dr_max <= PAIRS_TOL_RAD,
          "kernel and plain odometry disagree")

    # 5. Determinism (and the timed odometry run).
    t0 = time.perf_counter()
    out2 = odometry.ndt_odometry(scans, scan_mask, cfg)
    torch.cuda.synchronize()
    odo_s = time.perf_counter() - t0
    check(torch.equal(out2.poses, out.poses), "rerun poses differ")
    print("phase 5 determinism: rerun poses bit-identical")

    # K1 against its plain version at the shape the exact align gives it.
    aev = ndt._Evaluator(amap, a_src[1].xyzi[:, :3], a_src[1].mask,
                         acfg.resolution, ndt._OFFSETS[acfg.search_method],
                         d1, d2)
    aparams = aev.params(res.pose6.numpy())
    ah = aev.neighbor_hash(aparams)
    rel_err, abs_err = terms_err(
        ndt_kernels.ndt_terms_gathered(aparams, aev.xyz, amap.hash_table, *ah),
        ndt_kernels.ndt_terms_gathered_plain(aparams, aev.xyz,
                                             amap.hash_table, *ah),
        NDT_GROUPS)
    err["ndt_terms_gathered"] = max(err["ndt_terms_gathered"], abs_err)
    print(f"  ndt_terms_gathered at the exact-align shape (N "
          f"{aev.xyz.shape[1]}, K {aev.K}, table "
          f"{tuple(amap.hash_table.shape)}): max rel err {rel_err:.3g}, "
          f"max abs err {abs_err:.3g}")
    check(rel_err <= TERMS_RTOL,
          f"ndt_terms_gathered at the exact-align shape: relative error "
          f"{rel_err:.3g} > {TERMS_RTOL}")

    # 6. NDT timings.
    card = card_line()
    ms = {
        "ndt_gather_repack": (
            cuda_ms(lambda: ndt_kernels.ndt_gather_repack(table, h, nvid,
                                                          okm)),
            cuda_ms(lambda: ndt_kernels.ndt_gather_repack_plain(
                table, h, nvid, okm))),
        "ndt_terms_packed": (
            cuda_ms(lambda: ndt_kernels.ndt_terms_packed(params, ev.xyz,
                                                         stats)),
            cuda_ms(lambda: ndt_kernels.ndt_terms_packed_plain(
                params, ev.xyz, stats))),
    }
    ms["ndt_terms_gathered"] = (
        cuda_ms(lambda: ndt_kernels.ndt_terms_gathered(
            aparams, aev.xyz, amap.hash_table, *ah)),
        cuda_ms(lambda: ndt_kernels.ndt_terms_gathered_plain(
            aparams, aev.xyz, amap.hash_table, *ah)))
    akn = ah[0].numel()
    kn = h.numel()
    bounds = {
        "ndt_terms_gathered": bound(
            nbytes(aparams, aev.xyz, amap.hash_table, *ah) + 28 * 4,
            NDT_FLOPS_PER_PAIR * akn),
        "ndt_gather_repack": bound(nbytes(table, h, nvid, okm)
                                   + 10 * 4 * kn, 0),
        "ndt_terms_packed": bound(nbytes(params, ev.xyz, stats) + 28 * 4,
                                  NDT_FLOPS_PER_PAIR * kn),
    }
    library = {name: None for name in ndt_names}
    print(f"phase 6 timings ({card}), CUDA events, mean of {REPS} after "
          f"warm-up:")
    print("  ndt_terms_gathered at the exact-align shape; the others at the "
          "phase-2 odometry shape")
    for name in ndt_names:
        print(f"  {name}: kernel {ms[name][0]:.4f} ms, plain "
              f"{ms[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]})")
    align_ms, r = host_ms(
        lambda: ndt.ndt_align(amap, a_src[1], torch.eye(4), acfg))
    syncs = out2.host_syncs[1:].double()
    print(f"  odometry: {(ODO_SCANS - 1) / odo_s:.2f} scans/s "
          f"({1e3 * odo_s / (ODO_SCANS - 1):.2f} ms/scan incl. downsample "
          f"and map build, host clock, second run)")
    print(f"  exact align: {align_ms:.2f} ms/align (mean of 5, host clock), "
          f"{r.host_syncs} host syncs")
    print(f"  host syncs per odometry align: mean {float(syncs.mean()):.2f}, "
          f"max {int(syncs.max())}")

    # 7. K4-K6 against their plain versions on the card, at the shapes of
    #    the registration path: the 0.1 m pair padded to REG_CAPACITY.
    reg = [pointcloud.pad_to(c, REG_CAPACITY) for c in a_src]
    check(max(a_counts) <= REG_CAPACITY, "the pair does not fit its capacity")
    source, target = reg[1], reg[0]
    gcfg = gicp.GICPConfig()
    prob = gicp._problem(source, target, gcfg)
    n, m_cols = prob.src.shape[0], prob.tgt_t.shape[1]
    eye3 = torch.eye(3, device=dev)
    zero3 = torch.zeros(3, device=dev)
    moved = prob.src  # the first outer iteration, from the identity guess
    best, idx = nn_kernels.nearest_neighbor(moved, prob.tgt_t, prob.tsq)
    pbest, pidx = nn_kernels.nearest_neighbor_plain(moved, prob.tgt_t,
                                                    prob.tsq)
    valid = prob.mask
    same = (idx == pidx)[valid]
    share = float(same.double().mean())
    rows = torch.nonzero(valid & (idx != pidx))[:, 0]
    d64 = (prob.tsq[None].double() - 2.0 * moved[rows].double()
           @ prob.tgt_t.double())
    gap = (d64.gather(1, idx[rows, None].long())
           - d64.gather(1, pidx[rows, None].long())).abs()[:, 0]
    scale = d64.abs().amax(1)
    ties_ok = bool((gap <= TIE_RTOL * scale).all())
    err["nearest_neighbor"] = float((best - pbest).abs()[valid].max())
    print(f"phase 7 registration kernels vs plain (N {n}, M {m_cols}, "
          f"{int(valid.sum())} and {int(target.mask.sum())} valid points):")
    print(f"  nearest_neighbor: idx equal on {share:.6f} of valid rows "
          f"(bound {NN_SHARE}), {rows.numel()} rows differ, all ties within "
          f"{TIE_RTOL}: {ties_ok}; partial max abs err "
          f"{err['nearest_neighbor']:.3g}; bit-identical: "
          f"{torch.equal(best, pbest) and torch.equal(idx, pidx)}")
    check(share >= NN_SHARE and ties_ok,
          "K4 nearest_neighbor disagrees with its plain version")

    xyz_t = prob.tgt_t.T.contiguous()  # the target cloud's own k-NN
    tsq_all = (xyz_t * xyz_t).sum(1)
    nd = nn_kernels.neg_dist_bf16(xyz_t, tsq_all, prob.tgt_t, prob.tsq)
    nd_plain = nn_kernels.neg_dist_bf16_plain(xyz_t, tsq_all, prob.tgt_t,
                                              prob.tsq)
    tv = target.mask
    diff = (nd.float() - nd_plain.float())[tv][:, tv]
    ulp = 2.0 ** -8 * nd_plain.float()[tv][:, tv].abs()
    share5 = float((diff.abs() <= ulp).double().mean())
    err["neg_dist_bf16"] = float(diff.abs().max())
    print(f"  neg_dist_bf16: within 1 bf16 ulp on {share5:.6f} of valid x "
          f"valid entries (bound {NN_SHARE}), max abs err "
          f"{err['neg_dist_bf16']:.3g}, bit-identical: "
          f"{torch.equal(nd.view(torch.int16), nd_plain.view(torch.int16))}")
    check(share5 >= NN_SHARE, "K5 neg_dist_bf16 disagrees with its plain "
                              "version")
    del nd, nd_plain, diff, ulp

    q, m6, w = gicp._correspondences(prob, eye3, zero3)
    gparams = torch.cat([eye3.reshape(-1), zero3])
    rel_err, err["gicp_terms"] = terms_err(
        gicp_kernels.gicp_terms(gparams, prob.xyz, q, m6, w),
        gicp_kernels.gicp_terms_plain(gparams, prob.xyz, q, m6, w),
        GN_GROUPS)
    print(f"  gicp_terms: max rel err {rel_err:.3g} (bound {TERMS_RTOL}), "
          f"max abs err {err['gicp_terms']:.3g}, {int(w.sum())} "
          f"correspondences within {gcfg.max_correspondence_distance} m")
    check(rel_err <= TERMS_RTOL, "K6 gicp_terms disagrees with its plain "
                                 "version")

    # Registration path: counts reset, then one GICP and one ICP align.
    nn_kernels.reset_launch_counts()
    gicp_kernels.reset_launch_counts()
    g_res = gicp.gicp_align(source, target, None, gcfg)
    g_launch = {**nn_kernels.LAUNCHES, **gicp_kernels.LAUNCHES}
    i_res = icp.icp_align(source, target)
    reg_launches = {**nn_kernels.LAUNCHES, **gicp_kernels.LAUNCHES}
    print(f"phase 8 registration path (0.1 m pair, capacity {REG_CAPACITY}):")
    print(f"  launches: gicp_align {g_launch}; with icp_align "
          f"{reg_launches}")
    check(all(v > 0 for v in reg_launches.values()),
          "a kernel of the registration path was never launched")
    truth_t, truth_r = pose_diff(a_rel, np.eye(4))
    for name, r in (("gicp_align", g_res), ("icp_align", i_res)):
        e_t, e_r = pose_diff(r.transform, a_rel)
        print(f"  {name}: converged {r.converged}, iterations "
              f"{r.iterations}, host syncs {r.host_syncs}, error "
              f"{float(r.error):.5g}; vs ground truth {e_t:.4g} m, "
              f"{e_r:.4g} rad (identity guess {truth_t:.4g} m, "
              f"{truth_r:.4g} rad)")
        check(r.converged, f"{name} did not converge")
        check(bool(torch.isfinite(r.transform).all()) and e_t < truth_t,
              f"{name} did not improve on its identity guess")
    check(pose_diff(g_res.transform, a_rel)[1] < truth_r,
          "gicp_align did not improve the rotation of its identity guess")

    nn_plain = {name: getattr(nn_kernels, name + "_plain")
                for name in nn_kernels.LAUNCHES}
    with mock.patch.multiple(nn_kernels, **nn_plain), mock.patch.object(
            gicp_kernels, "gicp_terms", gicp_kernels.gicp_terms_plain):
        g_plain = gicp.gicp_align(source, target, None, gcfg)
        i_plain = icp.icp_align(source, target)
    for name, r, rp, (tol_m, tol_rad) in (
            ("gicp_align", g_res, g_plain, (GICP_TOL_M, GICP_TOL_RAD)),
            ("icp_align", i_res, i_plain, (ICP_TOL_M, ICP_TOL_RAD))):
        d_t, d_r = pose_diff(r.transform, rp.transform)
        print(f"  {name} kernels vs plain versions on the card: {d_t:.3g} "
              f"m, {d_r:.3g} rad (bounds {tol_m} m, {tol_rad} rad), "
              f"iterations {r.iterations} vs {rp.iterations}")
        check(d_t <= tol_m and d_r <= tol_rad,
              f"{name}: kernel and plain routes disagree")
    _, control_syncs = count_syncs(lambda: None)
    g_again, g_syncs = count_syncs(
        lambda: gicp.gicp_align(source, target, None, gcfg))
    i_again, i_syncs = count_syncs(lambda: icp.icp_align(source, target))
    check(torch.equal(g_again.transform, g_res.transform)
          and torch.equal(i_again.transform, i_res.transform),
          "rerun registration poses differ")
    print("  rerun poses bit-identical")
    print(f"  control, the sync count around no work: {control_syncs}")
    for name, r, where in (("gicp_align", g_res, g_syncs),
                           ("icp_align", i_res, i_syncs)):
        print(f"  {name}: {sum(where.values())} synchronising calls "
              f"reported by torch's sync debug mode ({r.host_syncs} "
              f"planned), by line: {where}")

    R0, t0_ = eye3, zero3
    nd_op = nn_kernels.neg_dist_bf16(xyz_t, tsq_all, prob.tgt_t, prob.tsq)
    step = gicp._GNStep(gcfg.damping, torch.float32, dev)
    probes = {
        "one inner GN step (K6, solve_ex, pose update)":
            lambda: step(prob.xyz, q, m6, w, R0, t0_),
        "K4 correspondences + Mahalanobis":
            lambda: gicp._correspondences(prob, R0, t0_),
        "covariances (K5 + topk + eigh3)":
            lambda: gicp.compute_covariances(prob.src, prob.mask, 20, 1e-3),
        "K5 alone": lambda: nn_kernels.neg_dist_bf16(
            xyz_t, tsq_all, prob.tgt_t, prob.tsq),
        "torch.topk (k 20) of K5's operand": lambda: torch.topk(nd_op, 20),
        "pose host-to-device copy (non-blocking)":
            lambda: torch.eye(4).to(dev, non_blocking=True),
        "GN-step constants (_GNStep)":
            lambda: gicp._GNStep(gcfg.damping, torch.float32, dev),
        "control: 1500 one-element additions (launches only)":
            lambda: [zero3.add(1.0) for _ in range(1500)],
    }
    print("  host wait while the card spins 50 ms on earlier work (~50 ms "
          "means the call waits on the device):")
    for name, fn in probes.items():
        print(f"    {name}: {host_wait_ms(fn):.3f} ms")
    del nd_op
    _, cov_syncs = count_syncs(
        lambda: gicp.compute_covariances(prob.src, prob.mask, 20, 1e-3))
    print(f"  compute_covariances alone: synchronising calls by line: "
          f"{cov_syncs}")

    # 9. Registration timings.
    card = card_line()
    tgt_xyz = prob.tgt_t.T.contiguous()
    ssq = (moved * moved).sum(1)
    a4 = torch.cat([2.0 * moved, -ssq[:, None]], 1)
    b4 = torch.cat([prob.tgt_t, torch.ones(1, m_cols, device=dev)], 0)
    neg_tsq = -prob.tsq
    ms["nearest_neighbor"] = (
        cuda_ms(lambda: nn_kernels.nearest_neighbor(moved, prob.tgt_t,
                                                    prob.tsq)),
        cuda_ms(lambda: nn_kernels.nearest_neighbor_plain(
            moved, prob.tgt_t, prob.tsq)))
    ms["neg_dist_bf16"] = (
        cuda_ms(lambda: nn_kernels.neg_dist_bf16(moved, ssq, prob.tgt_t,
                                                 prob.tsq)),
        cuda_ms(lambda: nn_kernels.neg_dist_bf16_plain(
            moved, ssq, prob.tgt_t, prob.tsq)))
    ms["gicp_terms"] = (
        cuda_ms(lambda: gicp_kernels.gicp_terms(gparams, prob.xyz, q, m6, w)),
        cuda_ms(lambda: gicp_kernels.gicp_terms_plain(gparams, prob.xyz, q,
                                                      m6, w)))
    library["nearest_neighbor"] = cuda_ms(
        lambda: torch.cdist(moved, tgt_xyz).argmin(1))
    library["neg_dist_bf16"] = cuda_ms(
        lambda: torch.addmm(neg_tsq, a4, b4).to(torch.bfloat16))
    library["gicp_terms"] = None
    bounds["nearest_neighbor"] = bound(
        nbytes(moved, prob.tgt_t, prob.tsq) + 8 * n,
        NN_FLOPS_PER_PAIR * n * m_cols)
    bounds["neg_dist_bf16"] = bound(
        nbytes(moved, ssq, prob.tgt_t, prob.tsq) + 2 * n * m_cols,
        NN_FLOPS_PER_PAIR * n * m_cols)
    bounds["gicp_terms"] = bound(nbytes(gparams, prob.xyz, q, m6, w)
                                 + 27 * 4, GICP_FLOPS_PER_PAIR * n)
    print(f"phase 9 registration timings ({card}), CUDA events, mean of "
          f"{REPS} after warm-up, at N = M = {n}; TF32 off for the plain "
          f"and library calls:")
    for name, lib_name in (("nearest_neighbor", "cdist + argmin"),
                           ("neg_dist_bf16", "addmm + to(bfloat16)"),
                           ("gicp_terms", None)):
        lib_txt = (f", library ({lib_name}) {library[name]:.4f} ms"
                   if lib_name else ", no library call")
        print(f"  {name}: kernel {ms[name][0]:.4f} ms, plain "
              f"{ms[name][1]:.4f} ms{lib_txt}, bound {bounds[name][0]:.4f} "
              f"ms ({bounds[name][1]})")
    gicp_ms, _ = host_ms(lambda: gicp.gicp_align(source, target, None, gcfg))
    cov_ms, _ = host_ms(lambda: gicp._problem(source, target, gcfg))
    icp_ms, _ = host_ms(lambda: icp.icp_align(source, target))
    print(f"  gicp_align: {gicp_ms:.2f} ms/align (mean of 5, host clock), of "
          f"which {cov_ms:.2f} ms set-up (covariances of both clouds); "
          f"{g_res.iterations} outer iterations")
    print(f"  icp_align: {icp_ms:.2f} ms/align (mean of 5, host clock), "
          f"{i_res.iterations} iterations")
    for name, fn in (
            ("gicp_align",
             lambda: gicp.gicp_align(source, target, None, gcfg)),
            ("icp_align", lambda: icp.icp_align(source, target))):
        wall, busy, n_launch, rows = device_profile(fn)
        print(f"  torch.profiler, one {name}: wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %), "
              f"{n_launch} device operations; top by device time:")
        for key, calls, dev_ms in rows:
            print(f"    {dev_ms:.3f} ms in {calls} calls: {key[:90]}")

    launches.update(reg_launches)
    print(card)
    kernels = [{
        "name": name, "route": "cuda", "source": source_path,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": library[name],
    } for name, (source_path, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(2)
