#!/usr/bin/env python3
"""Smoke run of the PyTorch port's NDT main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``toyslam_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the main
path through the entry points a user calls: one exact-mode ``ndt_align``
(the align.cpp configuration) and ``ndt_odometry`` under the shipped
``OdometryConfig`` over 16 generated 262144-ray scans. It checks that every
align converged, that the kernels were launched, that the poses match the
same run through the plain versions and are bit-identical on a rerun, and
prints the timings with the card's name and power limit. The last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
There is no CPU path: without a CUDA device the script exits with 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ODO_SCANS = 16  # 64 x 4096 = 262144 rays each
ALIGN_RAYS = (32, 2048)  # the ~65k-point HDL-32-class single-align pair
ALIGN_FOV = (-30.67, 10.67)
REPS = 20  # timed launches per kernel, after warm-up
TERMS_RTOL = 1e-4  # K1/K3 sums vs plain, relative to the group's largest
PAIRS_TOL_M, PAIRS_TOL_RAD = 1e-3, 1e-4  # kernel vs plain odometry poses
# Sanity bounds against ground truth (the data, not the port, limits the
# accuracy: an align can settle in a local minimum on the ring-sampled
# ground). Zero-motion estimates would give a 4.5 m ATE.
PAIR_MEDIAN_MAX_M = 0.02  # median per-scan relative translation error
ATE_MAX_M = 1.0
KERNELS = {  # name -> Pallas kernel it replaces
    "ndt_terms_gathered": "toyslam_tpu/ops/ndt_pallas.py:271",
    "ndt_gather_repack": "toyslam_tpu/ops/ndt_pallas.py:323",
    "ndt_terms_packed": "toyslam_tpu/ops/ndt_pallas.py:355",
}
SOURCE = "toyslam_tpu_torch/csrc/ndt_kernels.cu"


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


def terms_err(got, want):
    """Max error of 28 sums, each relative to the largest of its group
    (score, gradient, Hessian)."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    worst, abs_err = 0.0, 0.0
    for sl in (slice(0, 1), slice(1, 7), slice(7, 28)):
        diff = np.abs(got[sl] - want[sl])
        abs_err = max(abs_err, float(diff.max()))
        worst = max(worst, float(diff.max() / max(np.abs(want[sl]).max(),
                                                   1e-30)))
    return worst, abs_err


def rotation_angle(Ra, Rb):
    """Angle between two rotations from ||Ra - Rb||_F = 2 sqrt(2) sin(a/2)
    (arccos of the trace loses small angles to rounding)."""
    s = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))
    return float(2.0 * np.arcsin(min(s, 1.0)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.ops import ndt_kernels
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import ndt
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    lib = ndt_kernels.build()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s ({lib.name})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # Scans: 16 x 262144 rays for odometry, 2 x 65536 for the single align.
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

    # 2. Each kernel against its plain version on the card, at the odometry
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
        rel_err, err[name] = terms_err(got, want)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite sums")
        check(rel_err <= TERMS_RTOL,
              f"{name}: relative error {rel_err:.3g} > {TERMS_RTOL}")
        print(f"  {name}: max rel err {rel_err:.3g} (bound {TERMS_RTOL}), "
              f"max abs err {err[name]:.3g}")
    print(f"phase 2 kernels vs plain: ok (K2 bit-identical, gate open on "
          f"{gate_share:.3f} of pairs)")

    # Main path: counts reset, then the exact align and the odometry.
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
    print(f"launches in the main path: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
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

    plain = {name: getattr(ndt_kernels, name + "_plain") for name in KERNELS}
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
                                             amap.hash_table, *ah))
    err["ndt_terms_gathered"] = max(err["ndt_terms_gathered"], abs_err)
    print(f"  ndt_terms_gathered at the exact-align shape (N "
          f"{aev.xyz.shape[1]}, K {aev.K}, table "
          f"{tuple(amap.hash_table.shape)}): max rel err {rel_err:.3g}, "
          f"max abs err {abs_err:.3g}")
    check(rel_err <= TERMS_RTOL,
          f"ndt_terms_gathered at the exact-align shape: relative error "
          f"{rel_err:.3g} > {TERMS_RTOL}")

    # 6. Timings.
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
    print(f"phase 6 timings ({card}), CUDA events, mean of {REPS} after "
          f"warm-up:")
    print("  ndt_terms_gathered at the exact-align shape; the others at the "
          "phase-2 odometry shape")
    for name, (k_ms, p_ms) in ms.items():
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    align_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ndt.ndt_align(amap, a_src[1], torch.eye(4), acfg)
        torch.cuda.synchronize()
        align_times.append(time.perf_counter() - t0)
    syncs = out2.host_syncs[1:].double()
    print(f"  odometry: {(ODO_SCANS - 1) / odo_s:.2f} scans/s "
          f"({1e3 * odo_s / (ODO_SCANS - 1):.2f} ms/scan incl. downsample "
          f"and map build, host clock, second run)")
    print(f"  exact align: {1e3 * np.mean(align_times):.2f} ms/align (mean "
          f"of 5, host clock), {r.host_syncs} host syncs")
    print(f"  host syncs per odometry align: mean {float(syncs.mean()):.2f}, "
          f"max {int(syncs.max())}")

    print(card)
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": KERNELS[name], "launches": launches[name],
        "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1],
    } for name in KERNELS]
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
