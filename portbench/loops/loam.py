"""Log replay through LOAM feature odometry (``loam_mapping_node``).

Set-up casts each street of the mix's ``scene_seeds`` once on the device
and realises from it as many logs as the window can use (the mix's
``max_scans_per_s`` times the window, plus one), log ``j`` on street ``j
mod len(scene_seeds)``, each with its own range noise and sensor yaw drawn
from the seed, as ``loops/mapping.py`` does; each scan is padded to the
configuration's capacity. The window replays the logs one after another
as a closed loop with one client: ``loam_init`` on a log's first scan,
then ``loam_step`` on each further scan, every log into fresh maps. A
scan's unit ends when its pose and counters are on the host, in one copy.

The check replays one completed log, drawn from the seed, through the
plain reference (``reference.loam``) in float64, in two ways:

- each scan's step from the program's own state before it (its maps,
  pose, motion delta, keyframe anchor and counts, as ``loam_step``
  received them): the pose (median gaps, and the share of scans off by
  more than the configuration's ``pose_match_m`` or ``pose_match_rad``),
  the keyframe choice and the count of edge plus surface picks (the
  program's picks taken after the window by its own
  ``organize_and_extract``, which is deterministic). A step that starts
  from the program's state judges the step, and not how a chain
  amplifies rounding;
- the whole log as its own chain from the first scan: the largest pose
  gaps over the log, and the maps at its end (edge and surface, the larger
  of their mismatch shares).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scenes
from portbench.loops import common
from portbench.reference import loam as ref_loam
from portbench.window import Unit


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from toyslam_tpu_torch.core.pointcloud import PointCloud
        from toyslam_tpu_torch.pipelines import loam

        # A program without the streaming form stops here, at once.
        for name in ("loam_init", "loam_step", "LoamState"):
            if not hasattr(loam, name):
                raise ImportError(f"toyslam_tpu_torch.pipelines.loam has no "
                                  f"{name}")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.loam, self.PointCloud = loam, PointCloud
        c = dict(config["loam"])
        c["vertical_fov_deg"] = tuple(c["vertical_fov_deg"])
        self.cfg = loam.LoamConfig(**c)
        self.settings = ref_loam.Settings(**c)
        self.scans = config["scans_per_log"]
        self.logs = []  # [(xyzi [S, cap, 4], mask [S, cap])]
        self.done = {}  # log -> {"states": [LoamState], "outs": [host]}

    # -- set-up -----------------------------------------------------------

    def _cast(self, scene_seed):
        c = self.config["sensor"]
        m = self.config["motion"]
        return scenes.cast_log(scene_seed, self.scans, c["rings"],
                               c["azimuths"], c["fov_deg"], m["step_m"],
                               m["yaw_rate_rad"], m["tilt_deg"],
                               device=self.device)

    def _realise(self, cast, yaw, gen):
        xyzi, mask = scenes.realise(cast, self.config["sensor"]["noise_m"],
                                    yaw, gen)
        pad = self.config["capacity"] - xyzi.shape[1]
        fill = torch.full((self.scans, pad, 4), scenes.PAD_COORD,
                          dtype=xyzi.dtype, device=xyzi.device)
        fill[..., 3] = 0.0
        return (torch.cat([xyzi, fill], 1),
                torch.cat([mask, mask.new_zeros(self.scans, pad)], 1))

    def setup(self, seconds: float):
        tr = self.traffic
        gen = common.generator(self.seed, self.device)
        n_logs = math.ceil(seconds * tr["max_scans_per_s"] / self.scans) + 1
        cast = [self._cast(s) for s in tr["scene_seeds"]]
        yaws = common.uniform(gen, n_logs + 1, -math.pi, math.pi)
        for j in range(n_logs):
            self.logs.append(self._realise(cast[j % len(cast)], yaws[j],
                                           gen))
        # Warm-up: the cell's shapes, on a log of its own.
        xyzi, mask = self._realise(cast[0], yaws[n_logs], gen)
        state = self.loam.loam_init(self.PointCloud(xyzi[0], mask[0]),
                                    self.cfg)
        for i in range(1, tr["warmup_scans"] + 1):
            state, out = self.loam.loam_step(
                state, self.PointCloud(xyzi[i], mask[i]), self.cfg)
            self._on_host(out)
        del cast, state

    # -- the window -------------------------------------------------------

    @staticmethod
    def _on_host(out) -> list:
        """The step's pose, keyframe flag and counters in one copy:
        ``[qw, qx, qy, qz, tx, ty, tz, is_kf, gn_iterations, factors]``
        (the counters are small whole numbers, exact in the pose's
        dtype)."""
        extra = torch.stack([x.to(out.q.dtype) for x in (
            out.is_kf, out.gn_iterations, out.factors)])
        return torch.cat([out.q, out.t, extra]).tolist()

    def units(self):
        n_traced = self.traffic["traced_units"]
        for j, (xyzi, mask) in enumerate(self.logs):
            rec = {"states": [], "outs": []}
            self.done[j] = rec
            box = {}

            def init(j=j, xyzi=xyzi, mask=mask, box=box, rec=rec):
                box["state"] = self.loam.loam_init(
                    self.PointCloud(xyzi[0], mask[0]), self.cfg)
                rec["states"].append(box["state"])
                return {"log": j}

            yield Unit("init", init, False)
            for i in range(1, self.scans):
                def step(i=i, xyzi=xyzi, mask=mask, box=box, rec=rec):
                    state, out = self.loam.loam_step(
                        box["state"], self.PointCloud(xyzi[i], mask[i]),
                        self.cfg)
                    box["state"] = state
                    host = self._on_host(out)
                    rec["states"].append(state)
                    rec["outs"].append(host)
                    return {"gn_iterations": int(host[8]),
                            "factors": int(host[9]),
                            "failed": not all(map(math.isfinite, host[:7]))}

                yield Unit("scan", step, i + n_traced <= self.scans)
        raise RuntimeError(
            f"the window outran its {len(self.logs)} logs: raise the mix's "
            f"max_scans_per_s ({self.traffic['max_scans_per_s']})")

    # -- the check --------------------------------------------------------

    def facts(self) -> dict:
        """The largest map sizes at a log's end (a map only grows)."""
        ends = [r["states"][-1].maps for r in self.done.values()
                if r["states"]]
        return {"edge_map_points_max": max(
                    (int(m.edge_mask.sum()) for m in ends), default=0),
                "edge_map_capacity": self.cfg.map_capacity_edge,
                "surf_map_points_max": max(
                    (int(m.surf_mask.sum()) for m in ends), default=0),
                "surf_map_capacity": self.cfg.map_capacity_surf}

    def _ref_state(self, s) -> ref_loam.State:
        """The program's ``LoamState`` as the reference's, in float64."""
        m = s.maps
        return ref_loam.State(*(x.double() for x in (
            m.edge_xyz[m.edge_mask], m.surf_xyz[m.surf_mask], s.q_prev,
            s.t_prev, s.q_delta, s.t_delta, s.last_kf_q, s.last_kf_t)),
            int(s.static_frames), s.frame)

    def program_answers(self, records) -> dict:
        """What the program produced for the log the check replays: the
        state each step received, each step's pose and keyframe flag, its
        picks, and the maps at the end; frees the rest of its outputs."""
        full = self.scans - 1
        complete = [j for j, r in self.done.items()
                    if len(r["outs"]) == full]
        rng = np.random.default_rng([self.seed % (1 << 63), 1])
        if complete:
            j = int(rng.choice(complete))
        else:  # a window too short for a whole log: the scans it did
            j = max(self.done, key=lambda k: len(self.done[k]["outs"]))
            if not self.done[j]["outs"]:
                raise RuntimeError("no scan completed in the window")
        r = self.done[j]
        self.done = {}
        outs = torch.tensor(r["outs"], dtype=torch.float64)
        xyzi, mask = self.logs[j]
        feats = []
        for i in range(1, len(outs) + 1):
            f = self.loam.organize_and_extract(
                self.PointCloud(xyzi[i], mask[i]), self.cfg)
            feats.append(f.edge_mask.sum() + f.surf_mask.sum())
        end = r["states"][-1].maps
        return {"log": j,
                "states": [self._ref_state(s) for s in r["states"][:-1]],
                "q": outs[:, :4], "t": outs[:, 4:7],
                "is_kf": [bool(x) for x in outs[:, 7]],
                "features": torch.stack(feats).tolist(),
                "edge_map": end.edge_xyz[end.edge_mask].double(),
                "surf_map": end.surf_xyz[end.surf_mask].double()}

    def reference_answers(self, got: dict, dtype=torch.float64) -> dict:
        """The plain reference's answers for the log of ``got`` in
        ``dtype``: in float64, each step from ``got``'s state before it
        (``step_*``) and the log as its own chain (``chain_*``, the maps).
        In a lower ``dtype`` it stands in the program's place (the
        control): its own chain, in ``got``'s form."""
        xyzi, mask = self.logs[got["log"]]
        n = len(got["q"]) + 1  # the scans the program did
        xyz, mask = xyzi[:n, :, :3], mask[:n]
        before, chain, last = ref_loam.run_log(xyz, mask, self.settings,
                                               dtype)
        q = torch.stack([o.q for o in chain]).double().cpu()
        t = torch.stack([o.t for o in chain]).double().cpu()
        if dtype != torch.float64:
            return {"log": got["log"], "states": [
                        ref_loam.State(*(x.double() if torch.is_tensor(x)
                                         else x for x in s)) for s in before],
                    "q": q, "t": t, "is_kf": [o.is_kf for o in chain],
                    "features": [o.features for o in chain],
                    "edge_map": last.edge_map.double(),
                    "surf_map": last.surf_map.double()}
        steps = ref_loam.steps_from(got["states"], xyz, mask, self.settings)
        return {"log": got["log"],
                "step_q": torch.stack([o.q for o in steps]).cpu(),
                "step_t": torch.stack([o.t for o in steps]).cpu(),
                "step_kf": [o.is_kf for o in steps],
                "step_features": [o.features for o in steps],
                "chain_q": q, "chain_t": t,
                "edge_map": last.edge_map, "surf_map": last.surf_map}

    def compare(self, got: dict, ref: dict) -> dict:
        """The numbers the check holds to their limits."""
        t, r = pose_gaps(got["q"], got["t"], ref["step_q"], ref["step_t"])
        off = (t > self.config["pose_match_m"]) | (
            r > self.config["pose_match_rad"])
        ct, cr = pose_gaps(got["q"], got["t"], ref["chain_q"],
                           ref["chain_t"])
        c, mm = self.cfg, self.config["map_match_m"]
        return {
            "pose_gap_m_median": float(t.median()),
            "pose_gap_rad_median": float(r.median()),
            "pose_mismatch_share": float(off.double().mean()),
            "keyframe_mismatch": sum(
                a != b for a, b in zip(got["is_kf"], ref["step_kf"])),
            "feature_count_gap": max(
                abs(a - b) for a, b in zip(got["features"],
                                           ref["step_features"])),
            "pose_chain_gap_m": float(ct.max()),
            "pose_chain_gap_rad": float(cr.max()),
            "map_mismatch_share": max(
                common.map_mismatch(got["edge_map"], ref["edge_map"],
                                    c.map_leaf_edge, mm),
                common.map_mismatch(got["surf_map"], ref["surf_map"],
                                    c.map_leaf_surf, mm)),
        }


def pose_gaps(qa, ta, qb, tb):
    """Translation gaps (m) and rotation gaps (rad) ``[k]`` between the
    poses ``(qa [k, 4], ta [k, 3])`` and ``(qb, tb)``, in float64."""
    qa, ta, qb, tb = (x.double().cpu() for x in (qa, ta, qb, tb))
    dt = torch.linalg.vector_norm(ta - tb, dim=1)
    # The relative rotation's quaternion: its angle is 2 atan2(|v|, |w|).
    w = (qa * qb).sum(1)
    v = (qa[:, :1] * qb[:, 1:] - qb[:, :1] * qa[:, 1:]
         - torch.linalg.cross(qa[:, 1:], qb[:, 1:]))
    return dt, 2.0 * torch.atan2(torch.linalg.vector_norm(v, dim=1),
                                 w.abs())
