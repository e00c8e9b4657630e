"""Device operations and times of one K6 call and of one GICP align on the
card.

    python -m toyslam_tpu_torch.diag.gicp_call_ops

Builds register-65k, the registration pair of ``chip_smoke.py`` (two
generated 32 x 2048-ray scans, the 0.1 m downsample, padded to 32768
points, ``GICPConfig()``), takes K6's operands at the identity guess, and
measures ``gicp_kernels.gicp_terms`` there:

- ``call``: CALLS calls under torch.profiler after a warm-up, their
  device operations by name and their device milliseconds;
- ``device_ms_per_call``: CUDA events around REPS calls queued behind a
  spin of the card (``diag.timed_ms``), every operation of a call and the
  gaps between them;
- ``host_ms_per_call``: the host clock around REPS calls, none waited for:
  what a call costs the host that issues it;
- ``align``: one ``gicp_align`` under torch.profiler, its device
  operations, device busy time and wall time.

Prints one JSON line with the card's name and power limit. It uses only
what the port has offered since GICP was ported, so it also measures
another checkout of the package: ``PYTHONPATH=<checkout> python3
toyslam_tpu_torch/diag/gicp_call_ops.py``. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

REPS = 200
CALLS = 20


PRIMER = "spin_kernel"  # torch.cuda._sleep's kernel


def profiled(fn, calls=1, sessions=3):
    """``calls`` calls of ``fn()`` under torch.profiler after a warm-up:
    {"ops", "device_ms", "by_name", "wall_ms"}, each over all the calls. A
    profiler session on the card can miss its first device events, and the
    records of its last ones can still be on their way when it stops, so
    each session starts with a few spins of the card and a pause of the
    host, which are left out of the result, and ends with a pause after
    the card is idle. A session that still reports no device event of
    ``fn`` is run again, up to ``sessions`` in all; raises if every one is
    empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            time.sleep(0.05)
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and PRIMER not in e.key]
        if rows:
            break
    else:
        raise RuntimeError(f"the profiler saw no device operation in "
                           f"{sessions} sessions")
    by_name = {}
    for key, c, _ in rows:  # names cut to 80 characters can coincide
        by_name[key[:80]] = by_name.get(key[:80], 0) + c
    return {"ops": sum(c for _, c, _ in rows),
            "device_ms": sum(t for _, _, t in rows) / 1e3,
            "by_name": by_name, "wall_ms": wall}


def operands(dev):
    """register-65k on ``dev``: the source and target clouds, and K6's
    operands at the identity guess, ``(params, xyz, q, m6, w)``."""
    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.registration import gicp
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    xyzi, mask, _ = spinning_lidar_scans(1, 2, 32, 2048,
                                         fov_deg=(-30.67, 10.67))
    source, target = (pointcloud.pad_to(pointcloud.voxel_downsample(
        pointcloud.PointCloud(torch.from_numpy(xyzi[k]).to(dev),
                              torch.from_numpy(mask[k]).to(dev)), 0.1),
        32768) for k in (1, 0))
    prob = gicp._problem(source, target, gicp.GICPConfig())
    eye3, zero3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    q, m6, w = gicp._correspondences(prob, eye3, zero3)
    return source, target, (torch.cat([eye3.reshape(-1), zero3]), prob.xyz,
                            q, m6, w)


def call_costs(call, dev):
    """What one call of ``call`` costs: its device operations by name under
    torch.profiler (``call``, over CALLS calls), its device time queued
    behind a spin (``device_ms_per_call``) and the host's time to issue it
    (``host_ms_per_call``), each over REPS calls."""
    from toyslam_tpu_torch import diag

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        call()
    host_ms = 1e3 * (time.perf_counter() - t0) / REPS
    torch.cuda.synchronize()
    return {"calls": CALLS, "call": profiled(call, CALLS),
            "device_ms_per_call": diag.timed_ms(call, dev, REPS),
            "host_ms_per_call": host_ms}


def run():
    from toyslam_tpu_torch.ops import gicp_kernels
    from toyslam_tpu_torch.registration import gicp

    if not torch.cuda.is_available():
        raise RuntimeError("gicp_call_ops needs a CUDA device")
    dev = torch.device("cuda:0")
    source, target, args = operands(dev)
    costs = call_costs(lambda: gicp_kernels.gicp_terms(*args), dev)
    align = profiled(lambda: gicp.gicp_align(source, target))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "card": card,
            "n": int(args[1].shape[1]), "valid_pairs": int(args[4].sum()),
            **costs,
            "align": {k: align[k] for k in ("ops", "device_ms", "wall_ms")}
            | {"k6_launches": sum(c for k, c in align["by_name"].items()
                                  if "gicp_terms_kernel" in k)}}


if __name__ == "__main__":
    print(json.dumps(run()))
