"""Device operations of one NDT derivative evaluation on the card.

    python -m toyslam_tpu_torch.diag.ndt_eval_ops

Builds the align-65k pair of ``chip_smoke.py`` (two generated 32 x
2048-ray scans, the 0.1 m downsample, ``NDTConfig()``) and profiles with
``torch.profiler``, after a warm-up of each, one exact evaluation of the
NDT evaluator at one lane (``_LaneEvaluator.derivs``: the parameters up,
the sums, the sums down), as ``ndt_align`` makes it, and one frozen one
(the same on stats gathered at the same pose). Prints one JSON line: the
card, and for each evaluation its device operations by name and their
device time. It uses only what ``_LaneEvaluator`` has offered since the
fleet's lanes were ported, so it also measures another checkout of the
package: ``PYTHONPATH=<checkout> python3
toyslam_tpu_torch/diag/ndt_eval_ops.py``. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch


def profile_evaluation(ev, p, frozen=False, sessions=3):
    """One evaluation of lane 0 at host pose ``p`` (``ev.derivs``; against
    its gathered neighbourhood if ``frozen``) under torch.profiler after a
    warm-up:
    device operations, their device milliseconds, and the count by name. A
    profiler session on the card can miss its first device events, so each
    session starts with a few spins of the card (``torch.cuda._sleep``'s
    ``spin_kernel``) and a pause of the host, which are left out. A session
    that still reports no device events is run again, up to ``sessions`` in
    all; raises if every one is empty."""
    from torch.profiler import ProfilerActivity, profile

    ev.derivs([(0, p, frozen)])
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.01)
            ev.derivs([(0, p, frozen)])
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key]
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
            "by_name": by_name}


def run():
    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.registration import ndt
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    if not torch.cuda.is_available():
        raise RuntimeError("ndt_eval_ops needs a CUDA device")
    dev = torch.device("cuda:0")
    xyzi, mask, gt = spinning_lidar_scans(1, 2, 32, 2048,
                                          fov_deg=(-30.67, 10.67))
    clouds = [pointcloud.voxel_downsample(pointcloud.PointCloud(
        torch.from_numpy(xyzi[k]).to(dev), torch.from_numpy(mask[k]).to(dev)),
        0.1) for k in range(2)]
    cfg = ndt.NDTConfig()
    d1, d2, _ = ndt.gauss_coefficients(cfg.resolution, cfg.outlier_ratio)
    ev = ndt._LaneEvaluator(
        ndt.NDTMap(*(f[None] for f in ndt.build_ndt_map(clouds[0], cfg))),
        clouds[1].xyzi[None], clouds[1].mask[None], cfg.resolution,
        ndt._OFFSETS[cfg.search_method], d1, d2)
    p = ndt.se3.matrix_to_pose6(torch.from_numpy(
        np.linalg.inv(gt[0]) @ gt[1])).numpy().astype(np.float32)
    ev.gather([0], [p])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "card": card,
            "points": int(ev.xyz.shape[2]), "K": len(ev.offsets),
            "exact": profile_evaluation(ev, p),
            "frozen": profile_evaluation(ev, p, frozen=True)}


if __name__ == "__main__":
    print(json.dumps(run()))
