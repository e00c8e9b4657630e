"""LOAM's streaming form, ``loam_init`` and ``loam_step`` (``pipelines/
loam``), on the CPU.

- Over 6 scans of ``sim/loam_world`` (16 x 360 rays, the maps and feature
  caps of ``tests/test_torch_loam.py``), the steps give bit for bit, in
  f32 and in f64, what the whole-stack loop gives: each pose, each
  keyframe choice and the keyframe count, replayed here from the public
  stages (``organize_and_extract``, ``optimize_pose``, ``update_maps``)
  as ``loam_odometry`` ran them before it became a loop of steps; and
  ``loam_odometry`` itself is that loop.
- A state carried across two runs (steps 1-2, then 3-5 from the state
  the first run returned) gives the same bits as one run.
- The step's counters: ``gn_iterations`` and ``factors`` equal a replay
  of the done-flag rule from each iteration's solved step and factor
  counts (spied on the solve and the normal equations); on planes the
  features lie on exactly, the flag fires at the first iteration, and
  from a pose 5 cm off at a later check; the pose the flag kept is the
  pose of a run cut at that iteration.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

from toyslam_tpu_torch.core import se3  # noqa: E402
from toyslam_tpu_torch.core.pointcloud import PointCloud  # noqa: E402
from toyslam_tpu_torch.pipelines import loam  # noqa: E402
from toyslam_tpu_torch.sim import loam_world  # noqa: E402

CFG = loam.LoamConfig(n_rings=16, vertical_fov_deg=(-25.0, 5.0),
                      max_edge_features=192, max_surf_features=384,
                      map_capacity_edge=256, map_capacity_surf=1024)
SCANS = 6


@pytest.fixture(scope="module")
def drive():
    scans, _ = loam_world.drive(SCANS, 3, step_dtype=np.float64)
    xyzi, mask = loam_world.pack(scans)
    return torch.from_numpy(xyzi), torch.from_numpy(mask)


def _whole_stack(xyzi, mask, cfg):
    """The loop ``loam_odometry`` ran before its state moved into
    ``LoamState``: poses [S, 3] and [S, 4], keyframe flags and count."""
    dtype, dev = xyzi.dtype, xyzi.device
    ident = se3.quat_identity(dtype, dev)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    feat0 = loam.organize_and_extract(PointCloud(xyzi[0], mask[0]), cfg)
    maps = loam.update_maps(loam.empty_maps(cfg, dtype, dev), feat0, ident,
                            zero3, cfg)
    q_prev, t_prev, q_delta, t_delta = ident, zero3, ident, zero3
    last_kf_q, last_kf_t = ident, zero3
    n_kf, static_frames = izero + 1, izero
    ts, qs, kfs = [zero3], [ident], []
    for frame in range(1, xyzi.shape[0]):
        feats = loam.organize_and_extract(PointCloud(xyzi[frame],
                                                     mask[frame]), cfg)
        inject = ((static_frames > cfg.forced_motion_frames)
                  & (torch.linalg.norm(t_delta) < 0.02))
        nudge = torch.eye(3, dtype=dtype, device=dev)
        nudge = nudge[0] * 0.05 + nudge[1] * (0.01 * (frame % 3 - 1))
        t_delta_eff = torch.where(inject, t_delta + nudge, t_delta)
        q_pred = se3.quat_normalize(se3.quat_multiply(q_prev, q_delta))
        t_pred = t_prev + se3.quat_rotate(q_prev, t_delta_eff)
        q_new, t_new = loam.optimize_pose(feats, maps, q_pred, t_pred, cfg)
        q_prev_inv = se3.quat_conjugate(q_prev)
        q_delta = se3.quat_multiply(q_prev_inv, q_new)
        t_delta = se3.quat_rotate(q_prev_inv, t_new - t_prev)
        static_frames = torch.where(torch.linalg.norm(t_delta) < 0.02,
                                    static_frames + 1, izero)
        dq = se3.quat_multiply(se3.quat_conjugate(last_kf_q), q_new)
        angle = 2.0 * torch.arccos(torch.clamp(torch.abs(dq[0]), 0.0, 1.0))
        dist = torch.linalg.norm(t_new - last_kf_t)
        is_kf = (dist > cfg.keyframe_dist) | (angle > cfg.keyframe_angle)
        if frame % cfg.keyframe_interval == 0:
            is_kf = torch.ones_like(is_kf)
        maps_new = loam.update_maps(maps, feats, q_new, t_new, cfg)
        maps = loam.LoamMaps(*(torch.where(is_kf, new, old)
                               for new, old in zip(maps_new, maps)))
        last_kf_q = torch.where(is_kf, q_new, last_kf_q)
        last_kf_t = torch.where(is_kf, t_new, last_kf_t)
        n_kf = n_kf + is_kf.to(torch.int32)
        q_prev, t_prev = q_new, t_new
        ts.append(t_new)
        qs.append(q_new)
        kfs.append(bool(is_kf))
    return torch.stack(ts), torch.stack(qs), kfs, n_kf, maps


def _steps(xyzi, mask, cfg, state=None, first=1, last=None):
    """``loam_init`` (unless ``state`` is given) and ``loam_step`` over
    scans ``first`` .. ``last - 1``: (state, [LoamStepOut])."""
    last = xyzi.shape[0] if last is None else last
    if state is None:
        state = loam.loam_init(PointCloud(xyzi[0], mask[0]), cfg)
    outs = []
    for i in range(first, last):
        state, out = loam.loam_step(state, PointCloud(xyzi[i], mask[i]), cfg)
        outs.append(out)
    return state, outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_steps_equal_the_whole_stack_loop(drive, dtype):
    xyzi, mask = drive[0].to(dtype), drive[1]
    ts, qs, kfs, n_kf, maps = _whole_stack(xyzi, mask, CFG)
    state, outs = _steps(xyzi, mask, CFG)
    assert state.frame == SCANS - 1
    assert torch.equal(torch.stack([o.t for o in outs]), ts[1:])
    assert torch.equal(torch.stack([o.q for o in outs]), qs[1:])
    assert [bool(o.is_kf) for o in outs] == kfs
    assert torch.equal(state.n_keyframes, n_kf)
    assert int(n_kf) > 1  # a keyframe after the first one
    for a, b in zip(state.maps, maps):
        assert torch.equal(a, b)
    got = loam.loam_odometry(xyzi, mask, CFG)
    assert torch.equal(got.positions, ts) and torch.equal(got.quaternions,
                                                          qs)
    assert torch.equal(got.n_keyframes, n_kf)
    for o in outs:
        assert o.gn_iterations.dtype == torch.int32 and o.gn_iterations.ndim \
            == 0 and 1 <= int(o.gn_iterations) <= CFG.optimization_iterations
        assert o.factors.ndim == 0 and int(o.factors) > 0


def test_state_survives_a_split_run(drive):
    xyzi, mask = drive
    whole, outs = _steps(xyzi, mask, CFG)
    half, first = _steps(xyzi, mask, CFG, last=3)
    assert half.frame == 2
    back, rest = _steps(xyzi, mask, CFG, state=half, first=3)
    assert _same(first + rest, outs) and _same(back, whole)


def _same(a, b):
    """Bit-equal tensors and equal ints, in nested tuples and lists."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


class _Spy:
    """Records each iteration's solved step and factor counts."""

    def __init__(self, monkeypatch):
        self.dx, self.counts = [], []
        solve, normal = torch.linalg.solve_ex, loam._normal_equations

        def solve_ex(A, b):
            out = solve(A, b)
            self.dx.append(out[0].clone())
            return out

        def normal_equations(J, dist, w, ok):
            out = normal(J, dist, w, ok)
            self.counts.append(int(out[2]))
            return out

        monkeypatch.setattr(torch.linalg, "solve_ex", solve_ex)
        monkeypatch.setattr(loam, "_normal_equations", normal_equations)

    def replay(self, cfg):
        """(gn_iterations, factors) by the done-flag rule of
        ``optimize_pose``'s docstring."""
        n = cfg.optimization_iterations
        assert len(self.dx) == n and len(self.counts) == 2 * n
        kept, done = n, False
        for it, dx in enumerate(self.dx):
            factors = self.counts[2 * it] + self.counts[2 * it + 1]
            do = factors >= 50 and bool(torch.isfinite(dx).all())
            if it % 4 == 0 and not done and do and float(
                    torch.linalg.norm(dx)) < 1e-6:
                kept, done = it + 1, True
        return kept, factors


def test_step_counters_replay_the_done_flag_rule(drive, monkeypatch):
    xyzi, mask = drive
    state = loam.loam_init(PointCloud(xyzi[0], mask[0]), CFG)
    for i in range(1, 4):
        spy = _Spy(monkeypatch)
        state, out = loam.loam_step(state, PointCloud(xyzi[i], mask[i]), CFG)
        monkeypatch.undo()
        assert (int(out.gn_iterations), int(out.factors)) == spy.replay(CFG)


def _planes(dtype):
    """Surface features and a surface map on three orthogonal planes (the
    ground and two walls), the features lying on the map's planes."""
    g = torch.arange(-4.0, 4.01, 0.5, dtype=dtype)
    u, v = torch.meshgrid(g, g, indexing="ij")
    u, v = u.reshape(-1), v.reshape(-1)
    h = (v + 4.0) * 0.5
    pts = torch.cat([torch.stack([u, v, torch.zeros_like(u)], 1),
                     torch.stack([u, torch.full_like(u, 6.0), h], 1),
                     torch.stack([torch.full_like(u, 7.0), u, h], 1)])
    feat = pts[(torch.arange(len(pts)) % 3) == 1]
    # The 5th neighbour on a 0.5 m grid lies up to 0.5 m^2 away.
    cfg = CFG._replace(max_nn_sqdist=4.0)
    fe = torch.full((4, 3), 1e9, dtype=dtype)
    features = loam.FeatureScan(fe, torch.zeros(4, dtype=torch.bool), feat,
                                torch.ones(len(feat), dtype=torch.bool))
    maps = loam.LoamMaps(torch.full((8, 3), 1e9, dtype=dtype),
                         torch.zeros(8, dtype=torch.bool), pts,
                         torch.ones(len(pts), dtype=torch.bool))
    return features, maps, cfg


@pytest.mark.parametrize("offset,want", [(0.0, 1), (0.05, None)])
def test_done_flag_counters_on_planes(monkeypatch, offset, want):
    dtype = torch.float64
    features, maps, cfg = _planes(dtype)
    q0 = se3.quat_identity(dtype, "cpu")
    t0 = torch.tensor([offset, -offset, offset], dtype=dtype)
    spy = _Spy(monkeypatch)
    q, t, kept, factors = loam._optimize(features, maps, q0, t0, cfg)
    monkeypatch.undo()
    assert (int(kept), int(factors)) == spy.replay(cfg)
    if want is not None:
        assert int(kept) == want
    assert int(kept) < cfg.optimization_iterations
    # The kept pose is the pose of a run cut at that iteration.
    cut = cfg._replace(optimization_iterations=int(kept))
    qc, tc = loam.optimize_pose(features, maps, q0, t0, cut)
    assert torch.equal(q, qc) and torch.equal(t, tc)
    assert float(torch.linalg.norm(t)) < 1e-6
