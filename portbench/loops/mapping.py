"""Bag replay through the mapping pipeline (``ndt_rosbag_mapping_node``).

Set-up casts each street of the mix's ``scene_seeds`` once on the device
and realises from it as many logs as the window can use (the mix's
``max_scans_per_s`` times the window, plus one), log ``j`` on street ``j
mod len(scene_seeds)``, each with its own range noise and sensor yaw drawn
from the seed, so no two logs hand the program byte-identical scans while
every seed replays the same streets in the same order. The window replays
the logs one after another as a closed loop: ``mapping_init`` on a log's
first scan, then ``mapping_step`` on each further scan, every log into a
fresh map.

The check replays one completed log, drawn from the seed, through the
plain reference (``reference.voxel``, ``reference.ndt``) in float64: each
scan's downsample, the NDT map of the previous scan, the align, the pose
chain and the merge. It compares each scan's voxel count and converged
flag; each pairwise transform (the median gaps over the log, and the share
of scans off by more than the configuration's ``pose_match_m`` or
``pose_match_rad``); each pose of the chain (the largest gaps); and the
global map at the log's end.

One stage follows the program's own state rather than the reference's:
each align after the first starts from the program's previous pairwise
transform (the warm start; the first starts from the identity on both
sides). An f32 and an f64 align part at a step of the line search where
the frozen NDT objective is flat, and stop centimetres apart, so a chain
of the reference's own guesses would judge how the chain amplifies
rounding, not the program. For the same reason the reference's pose
chain composes the program's pairwise transforms, in float64 from the
identity (``pose_i = pose_{i-1} @ T_i``): the transforms are judged
against the reference's aligns, the chain judges the composition, and
the reference merges its own downsamples into the global map at its own
poses.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scenes
from portbench.loops import common
from portbench.reference import ndt as ref_ndt
from portbench.reference import voxel as ref_voxel
from portbench.window import Unit


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from toyslam_tpu_torch.pipelines import odometry
        from toyslam_tpu_torch.registration import ndt

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        odo = dict(config["odometry"])
        self.odo_cfg = odometry.OdometryConfig(
            ndt=ndt.NDTConfig(**odo.pop("ndt")), **odo)
        self.odometry = odometry
        self.map_capacity = config["map_capacity"]
        self.scans = config["scans_per_log"]
        self.logs = []  # [(xyzi [S, n, 4], mask [S, n])]
        self.done = {}  # log -> {"steps": [out], "ds": [mask], "map": cloud}

    # -- set-up -----------------------------------------------------------

    def _cast(self, scene_seed):
        c = self.config["sensor"]
        m = self.config["motion"]
        return scenes.cast_log(scene_seed, self.scans, c["rings"],
                               c["azimuths"], c["fov_deg"], m["step_m"],
                               m["yaw_rate_rad"], m["tilt_deg"],
                               device=self.device)

    def setup(self, seconds: float):
        tr = self.traffic
        gen = common.generator(self.seed, self.device)
        n_logs = math.ceil(seconds * tr["max_scans_per_s"] / self.scans) + 1
        cast = [self._cast(s) for s in tr["scene_seeds"]]
        noise = self.config["sensor"]["noise_m"]
        yaws = common.uniform(gen, n_logs + 1, -math.pi, math.pi)
        for j in range(n_logs):
            xyzi, mask = scenes.realise(cast[j % len(cast)], noise,
                                        yaws[j], gen)
            self.logs.append((xyzi, mask))
        # Warm-up: the cell's shapes, on a log of its own.
        xyzi, mask = scenes.realise(cast[0], noise, yaws[n_logs], gen)
        state = self.odometry.mapping_init(xyzi[0], mask[0],
                                           self.map_capacity, self.odo_cfg)
        for i in range(1, tr["warmup_scans"] + 1):
            state, _ = self.odometry.mapping_step(state, xyzi[i], mask[i],
                                                  self.odo_cfg)
        del cast, state

    # -- the window -------------------------------------------------------

    def units(self):
        n_traced = self.traffic["traced_units"]
        for j, (xyzi, mask) in enumerate(self.logs):
            rec = {"steps": [], "ds": [], "map": None}
            self.done[j] = rec
            box = {}

            def init(j=j, xyzi=xyzi, mask=mask, box=box):
                box["state"] = self.odometry.mapping_init(
                    xyzi[0], mask[0], self.map_capacity, self.odo_cfg)
                return {"log": j}

            yield Unit("init", init, False)
            for i in range(1, self.scans):
                def step(i=i, xyzi=xyzi, mask=mask, box=box, rec=rec):
                    state, out = self.odometry.mapping_step(
                        box["state"], xyzi[i], mask[i], self.odo_cfg)
                    box["state"] = state
                    rec["steps"].append(out)
                    rec["ds"].append(state.odometry.prev_ds.mask)
                    rec["map"] = state.map_cloud
                    return {"evaluations": out[5], "host_syncs": out[7],
                            "failed": not out[2]}

                yield Unit("scan", step, i + n_traced <= self.scans)
        raise RuntimeError(
            f"the window outran its {len(self.logs)} logs: raise the mix's "
            f"max_scans_per_s ({self.traffic['max_scans_per_s']})")

    # -- the check --------------------------------------------------------

    def facts(self) -> dict:
        """Largest voxel counts of the window: the scans' downsamples and
        the global maps at each log's end."""
        ds = [int(m.sum()) for r in self.done.values() for m in r["ds"]]
        maps = [int(r["map"].mask.sum()) for r in self.done.values()
                if r["map"] is not None]  # a map only grows
        return {"scan_voxels_max": max(ds, default=0),
                "scan_voxel_capacity": self.odo_cfg.work_capacity,
                "map_voxels_max": max(maps, default=0),
                "map_capacity": self.map_capacity}

    def program_answers(self, records) -> dict:
        """What the program produced for the log the check replays: its
        pairwise transforms, converged flags, downsample counts and final
        global map; frees the rest of the program's outputs."""
        full = self.scans - 1
        complete = [j for j, r in self.done.items()
                    if len(r["steps"]) == full]
        rng = np.random.default_rng([self.seed % (1 << 63), 1])
        if complete:
            j = int(rng.choice(complete))
        else:  # a window too short for a whole log: the scans it did
            j = max(self.done, key=lambda k: len(self.done[k]["steps"]))
            if not self.done[j]["steps"]:
                raise RuntimeError("no scan completed in the window")
        r = self.done[j]
        m = r["map"]
        ans = {"log": j,
               "pairwise": torch.stack([o[1] for o in r["steps"]]).double(),
               "poses": torch.stack([o[0] for o in r["steps"]]).double(),
               "converged": [bool(o[2]) for o in r["steps"]],
               "ds_count": [int(x.sum()) for x in r["ds"]],
               "map": m.xyzi[m.mask][:, :3].double()}
        self.done = {}
        return ans

    def reference_answers(self, got: dict, dtype=torch.float64) -> dict:
        """The plain reference's answers for the log of ``got``, computed
        in ``dtype``: its own downsamples and aligns, each warm-started from
        ``got``'s previous transform, the pose chain of ``got``'s transforms
        and the global map its merge makes of its downsamples at those
        poses. In a lower ``dtype`` it stands in the program's place (the
        control), and its chain composes its own transforms."""
        xyzi, mask = self.logs[got["log"]]
        n = len(got["pairwise"]) + 1  # the scans the program did
        c = self.config["odometry"]
        s = ref_ndt.Settings(**{k: c["ndt"][k]
                                for k in ref_ndt.Settings._fields})
        low = dtype != torch.float64
        ds, counts = [], []
        for i in range(n):
            pts = xyzi[i].to(dtype) if low else xyzi[i]
            d = ref_voxel.downsample(pts, mask[i], c["scan_leaf"], dtype)
            counts.append(len(d))
            ds.append(d[:c["work_capacity"]])
        guesses = [np.eye(4)] + [T.numpy() for T in got["pairwise"].cpu()]
        pairwise, converged, ndt_voxels = [], [], []
        for i in range(1, n):
            m = ref_ndt.build_map(ds[i - 1][:, :3], s)
            ndt_voxels.append(m.voxels)
            T, ok, _, _ = ref_ndt.align(m, ds[i][:, :3],
                                        guesses[i - 1] if c["warm_start"]
                                        else np.eye(4), s)
            pairwise.append(T if ok else np.eye(4))
            converged.append(ok)
        pairwise = torch.as_tensor(np.stack(pairwise))
        poses = chain(pairwise if low else got["pairwise"], dtype,
                      self.device)
        the_map = ref_voxel.downsample(
            ds[0], torch.ones(len(ds[0]), dtype=torch.bool,
                              device=self.device), c["map_leaf"], dtype)
        for i in range(1, n):
            the_map = ref_voxel.merge(the_map, ds[i], poses[i - 1],
                                      c["map_leaf"])
        return {"log": got["log"],
                "pairwise": pairwise,
                "converged": converged,
                "ds_count": counts[1:],
                "map": the_map[:self.map_capacity, :3].double(),
                "poses": poses.double().cpu(),
                "facts": {"ndt_map_voxels_max": max(ndt_voxels),
                          "ndt_map_capacity": s.map_capacity}}

    def compare(self, got: dict, ref: dict) -> dict:
        """The numbers the check holds to their limits."""
        t, r = common.transform_gap_rows(got["pairwise"].cpu(),
                                         ref["pairwise"].cpu())
        off = (t > self.config["pose_match_m"]) | (
            r > self.config["pose_match_rad"])
        chain_m, chain_rad = common.transform_gaps(got["poses"].cpu(),
                                                   ref["poses"].cpu())
        return {
            "scan_voxel_count_gap": max(
                abs(a - b) for a, b in zip(got["ds_count"],
                                           ref["ds_count"])),
            "pose_gap_m_median": float(t.median()),
            "pose_gap_rad_median": float(r.median()),
            "pose_mismatch_share": float(off.double().mean()),
            "pose_chain_gap_m": chain_m,
            "pose_chain_gap_rad": chain_rad,
            "converged_mismatch": sum(
                a != b for a, b in zip(got["converged"], ref["converged"])),
            "map_mismatch_share": common.map_mismatch(
                got["map"], ref["map"], self.config["odometry"]["map_leaf"],
                self.config["map_match_m"]),
        }


def chain(pairwise: torch.Tensor, dtype, device) -> torch.Tensor:
    """The poses ``[k, 4, 4]`` of scans 1..k composed in ``dtype`` from
    the identity pose of scan 0: ``pose_i = pose_{i-1} @ pairwise_i``."""
    pose = torch.eye(4, dtype=dtype, device=device)
    out = []
    for T in pairwise.to(device, dtype):
        pose = pose @ T
        out.append(pose)
    return torch.stack(out)
