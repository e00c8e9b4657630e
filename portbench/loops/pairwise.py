"""Pairwise registration as ``ndt_omp/apps/align.cpp`` times it.

Set-up casts the mix's street once (``pairs + 1`` consecutive scans of
the configuration's sensor), realises it with range noise and a sensor
yaw drawn from the seed, and downsamples every scan through the program
(``core/pointcloud.voxel_downsample`` at the configuration's leaf, padded
to its capacity), outside the window as align.cpp does outside its timer.
It draws one guess an align from the seed: a rotation vector and a
translation, each entry uniform within the mix's bounds of the identity.
The window is a closed loop of aligns, align ``k`` registering scan ``k
mod pairs + 1`` (source) to scan ``k mod pairs`` (target) from guess
``k``, so no (pair, guess) repeats.

The check holds every scan's downsample to the plain reference's
(``reference.voxel``), and a sample of the window's aligns drawn from the
seed, the slowest one always among them, to the plain reference's align
(``reference.gicp``, float64, on its own downsamples, from the same
guess): the final transform and its convergence. Each align's gaps are
compared by their largest, and the translation gap also by its median
over the sample, which a fault that moves every align a little (half of
the correspondences left out) lifts well above the rounding of a sound
run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scenes
from portbench.loops import common
from portbench.reference import gicp as ref_gicp
from portbench.reference import voxel as ref_voxel
from portbench.window import Unit


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from toyslam_tpu_torch.core import pointcloud
        from toyslam_tpu_torch.registration import gicp

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.pointcloud = pointcloud
        self.gicp = gicp
        self.cfg = gicp.GICPConfig(**config["gicp"])
        self.pairs = traffic["pairs"]
        self.results = []  # per align: (k, T, converged)

    def _guesses(self, gen, n):
        tr = self.traffic
        a, b = tr["guess_translation_m"], tr["guess_rotation_rad"]
        t = torch.tensor(common.uniform(gen, 3 * n, -a, a),
                         dtype=torch.float64).reshape(n, 3)
        w = torch.tensor(common.uniform(gen, 3 * n, -b, b),
                         dtype=torch.float64).reshape(n, 3)
        out = torch.eye(4, dtype=torch.float64).repeat(n, 1, 1)
        out[:, :3, :3] = torch.stack([ref_gicp.so3_exp(x) for x in w])
        out[:, :3, 3] = t
        return out.float()

    def setup(self, seconds: float):
        c, m, tr = self.config["sensor"], self.config["motion"], self.traffic
        gen = common.generator(self.seed, self.device)
        log = scenes.cast_log(tr["scene_seed"], self.pairs + 1, c["rings"],
                              c["azimuths"], c["fov_deg"], m["step_m"],
                              m["yaw_rate_rad"], m["tilt_deg"],
                              device=self.device)
        yaw = common.uniform(gen, 1, -math.pi, math.pi)[0]
        self.xyzi, self.mask = scenes.realise(log, c["noise_m"], yaw, gen)
        del log
        pc = self.pointcloud
        leaf, cap = self.config["leaf_m"], self.config["capacity"]
        self.clouds, self.counts = [], []
        for k in range(self.pairs + 1):
            ds = pc.voxel_downsample(pc.PointCloud(self.xyzi[k],
                                                   self.mask[k]), leaf)
            self.clouds.append(pc.pad_to(ds, cap))
            self.counts.append(ds.mask.sum())
        self.counts = [int(x) for x in self.counts]
        n = math.ceil(seconds * tr["max_aligns_per_s"]) + 1
        self.guess = self._guesses(gen, n)
        for g in self._guesses(gen, tr["warmup_aligns"]):
            self.gicp.gicp_align(self.clouds[1], self.clouds[0], g, self.cfg)

    def units(self):
        for k in range(len(self.guess)):
            def align(k=k):
                p = k % self.pairs
                res = self.gicp.gicp_align(self.clouds[p + 1], self.clouds[p],
                                           self.guess[k], self.cfg)
                self.results.append((k, res.transform, res.converged))
                return {"iterations": res.iterations,
                        "n_src": self.counts[p + 1], "n_tgt": self.counts[p],
                        "capacity": self.clouds[p].capacity,
                        "failed": not res.converged}

            yield Unit("align", align)
        raise RuntimeError(
            f"the window outran its {len(self.guess)} guesses: raise the "
            f"mix's max_aligns_per_s ({self.traffic['max_aligns_per_s']})")

    def facts(self) -> dict:
        return {"cloud_voxels_max": max(self.counts),
                "cloud_capacity": self.config["capacity"]}

    def program_answers(self, records) -> dict:
        """The program's downsamples and a sample of the window's aligns
        (``records``), the slowest always among them; frees the rest."""
        res = self.results
        seconds_of = [r.seconds for r in records if r.kind == "align"]
        rng = np.random.default_rng([self.seed % (1 << 63), 2])
        n = min(self.traffic["check_aligns"], len(res))
        pick = set(rng.choice(len(res), n, replace=False).tolist())
        if res:
            pick.add(max(range(len(res)), key=lambda i: seconds_of[i]))
        pick = sorted(pick)
        ans = {"aligns": [res[i][0] for i in pick],
               "transform": torch.stack([res[i][1] for i in pick]).double(),
               "converged": [res[i][2] for i in pick],
               "clouds": [c.xyzi[:n_, :3] for c, n_ in zip(self.clouds,
                                                          self.counts)]}
        self.results = []
        return ans

    def reference_answers(self, got: dict, dtype=torch.float64) -> dict:
        """The plain reference's downsamples and aligns for the sample of
        ``got``, computed in ``dtype``."""
        aligns = got["aligns"]
        leaf = self.config["leaf_m"]
        low = dtype != torch.float64
        clouds = [ref_voxel.downsample(x.to(dtype) if low else x, m, leaf,
                                       dtype)[:, :3]
                  for x, m in zip(self.xyzi, self.mask)]
        s = ref_gicp.Settings(**{k: self.config["gicp"][k]
                                 for k in ref_gicp.Settings._fields})
        T, conv = [], []
        for k in aligns:
            p = k % self.pairs
            t, ok, _ = ref_gicp.align(clouds[p + 1], clouds[p],
                                      self.guess[k].to(dtype), s)
            T.append(t.double().cpu())
            conv.append(ok)
        return {"aligns": aligns, "transform": torch.stack(T),
                "converged": conv, "clouds": clouds}

    def compare(self, got: dict, ref: dict) -> dict:
        gaps = [common.cloud_gap(a, b) for a, b in zip(got["clouds"],
                                                       ref["clouds"])]
        t, r = common.transform_gap_rows(got["transform"].cpu(),
                                         ref["transform"].cpu())
        return {
            "cloud_voxel_count_gap": max(g[0] for g in gaps),
            "cloud_gap_m": max(g[1] for g in gaps),
            "align_gap_m": float(t.max()),
            "align_gap_rad": float(r.max()),
            "align_gap_m_median": float(t.median()),
            "converged_mismatch": sum(
                a != b for a, b in zip(got["converged"], ref["converged"])),
        }
