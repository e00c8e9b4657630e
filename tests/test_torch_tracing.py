"""The program's trace spans (``utils/profiling.span``) on the CPU.

- While no profiler records, ``span`` hands back one shared no-op context.
- Under a CPU ``torch.profiler`` session, a small ``mapping_init`` plus
  ``mapping_step`` (with and without the coarse stage) and a small
  ``gicp_align`` leave the spans their modules name, each inside the span
  its caller opened (the innermost span that holds it on the host thread,
  which ``FunctionEvent.cpu_parent`` walks; read from the session's raw
  events, which ``events()`` takes seconds to build into a tree), in the
  numbers the program's own counters give: one ``ndt.derivs`` an NDT
  evaluation, one ``ndt.sync`` a host sync and one ``ndt.gather`` a
  gather; one ``gicp.sync`` a GICP host sync, ``inner_iterations``
  ``gicp.gn_step`` an outer iteration. A small ``loam_init`` plus
  ``loam_step`` leaves two ``loam.factors`` and one ``loam.solve`` for
  each of the step's Gauss-Newton iterations, inside ``loam.optimize``.
- A span is a host op of the session, not a user annotation (which the
  profiler mirrors onto a device's timeline).
- The calls' outputs are bit-identical with the session on and off.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from toyslam_tpu_torch.core.pointcloud import PointCloud  # noqa: E402
from toyslam_tpu_torch.pipelines import loam, odometry  # noqa: E402
from toyslam_tpu_torch.registration import gicp  # noqa: E402
from toyslam_tpu_torch.sim import loam_world  # noqa: E402
from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans  # noqa: E402
from toyslam_tpu_torch.utils import profiling  # noqa: E402
from toyslam_tpu_torch.utils.profiling import span, spanned  # noqa: E402

ROOT = "unit"  # the caller's span around each call, as a benchmark's


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first, second = span("a"), span("b")
    assert first is second is profiling._NO_SPAN
    with first as got:
        assert got is None

    @spanned("c")
    def add(a, b=1):
        return a + b

    assert add(2, b=3) == 5 and add.__name__ == "add"


def _mapping(coarse_leaf):
    xyzi, mask, _ = spinning_lidar_scans(2, 2, 16, 512)
    xyzi, mask = torch.from_numpy(xyzi), torch.from_numpy(mask)
    cfg = odometry.OdometryConfig(work_capacity=4096,
                                  coarse_leaf=coarse_leaf)

    def run():
        state = odometry.mapping_init(xyzi[0], mask[0], 8192, cfg)
        state, out = odometry.mapping_step(state, xyzi[1], mask[1], cfg)
        outputs = [state.map_cloud.xyzi, state.map_cloud.mask,
                   state.odometry.prev_ds.xyzi, out[0], out[1], out[4]]
        counts = {"toyslam.ndt.derivs": out[5], "toyslam.ndt.sync": out[7],
                  "toyslam.ndt.gather": out[6]}
        return outputs, [out[2], out[3], out[5], out[6], out[7]], counts

    aligns = 2 if coarse_leaf else 1
    parents = {"toyslam.mapping.init": ROOT,
               "toyslam.mapping.step": ROOT,
               "toyslam.odometry.downsample": {"toyslam.mapping.init",
                                               "toyslam.mapping.step"},
               "toyslam.ndt.build_map": "toyslam.mapping.step",
               "toyslam.ndt.align": "toyslam.mapping.step",
               "toyslam.ndt.gather": "toyslam.ndt.align",
               "toyslam.ndt.derivs": "toyslam.ndt.align",
               "toyslam.ndt.sync": "toyslam.ndt.derivs",
               "toyslam.mapping.merge": "toyslam.mapping.step"}
    fixed = {"toyslam.mapping.init": 1, "toyslam.mapping.step": 1,
             "toyslam.odometry.downsample": 1 + aligns,
             "toyslam.ndt.build_map": 1, "toyslam.ndt.align": aligns,
             "toyslam.mapping.merge": 1}
    return run, parents, fixed


def _gicp():
    rng = np.random.default_rng(3)

    def cloud(n):
        m = n // 3
        z = 0.02 * rng.normal(size=m)
        pts = np.concatenate([
            np.stack([rng.uniform(-10, 10, m), rng.uniform(-10, 10, m), z],
                     1),
            np.stack([rng.uniform(-10, 10, m), 5.0 + z, rng.uniform(0, 4, m)],
                     1),
            np.stack([-8.0 + z, rng.uniform(-10, 5, m), rng.uniform(0, 4, m)],
                     1)])
        xyzi = np.zeros((512, 4), np.float32)
        xyzi[:len(pts), :3] = pts
        mask = np.arange(512) < len(pts)
        return PointCloud(torch.from_numpy(xyzi), torch.from_numpy(mask))

    tgt, src = cloud(480), cloud(480)
    guess = torch.eye(4)
    guess[:3, 3] = torch.tensor([0.2, -0.1, 0.05])
    cfg = gicp.GICPConfig()

    def run():
        res = gicp.gicp_align(src, tgt, guess, cfg)
        counts = {"toyslam.gicp.sync": res.host_syncs,
                  "toyslam.gicp.gn_step": res.iterations
                  * cfg.inner_iterations,
                  "toyslam.gicp.correspondences": res.iterations,
                  "toyslam.gicp.converge": res.iterations}
        return [res.transform, res.error], [res.converged, res.iterations,
                                            res.host_syncs], counts

    parents = {"toyslam.gicp.align": ROOT,
               "toyslam.gicp.covariances": "toyslam.gicp.align",
               "toyslam.gicp.correspondences": "toyslam.gicp.align",
               "toyslam.gicp.gn_step": "toyslam.gicp.align",
               "toyslam.gicp.converge": "toyslam.gicp.align",
               "toyslam.gicp.sync": "toyslam.gicp.converge"}
    fixed = {"toyslam.gicp.align": 1, "toyslam.gicp.covariances": 2}
    return run, parents, fixed


def _loam():
    scans, _ = loam_world.drive(2, 3, step_dtype=np.float64)
    xyzi, mask = (torch.from_numpy(a) for a in loam_world.pack(scans))
    cfg = loam.LoamConfig(n_rings=16, vertical_fov_deg=(-25.0, 5.0),
                          max_edge_features=192, max_surf_features=384,
                          map_capacity_edge=256, map_capacity_surf=1024)

    def run():
        state = loam.loam_init(PointCloud(xyzi[0], mask[0]), cfg)
        state, out = loam.loam_step(state, PointCloud(xyzi[1], mask[1]), cfg)
        counts = {"toyslam.loam.factors": 2 * cfg.optimization_iterations,
                  "toyslam.loam.solve": cfg.optimization_iterations}
        return ([*state.maps, out.q, out.t],
                [bool(out.is_kf), int(out.gn_iterations), int(out.factors),
                 int(state.n_keyframes)], counts)

    parents = {"toyslam.loam.init": ROOT,
               "toyslam.loam.step": ROOT,
               "toyslam.loam.extract": {"toyslam.loam.init",
                                        "toyslam.loam.step"},
               "toyslam.loam.update_maps": {"toyslam.loam.init",
                                            "toyslam.loam.step"},
               "toyslam.loam.optimize": "toyslam.loam.step",
               "toyslam.loam.factors": "toyslam.loam.optimize",
               "toyslam.loam.solve": "toyslam.loam.optimize"}
    fixed = {"toyslam.loam.init": 1, "toyslam.loam.step": 1,
             "toyslam.loam.extract": 2, "toyslam.loam.update_maps": 2,
             "toyslam.loam.optimize": 1}
    return run, parents, fixed


CASES = {"mapping": lambda: _mapping(0.0),
         "mapping_coarse": lambda: _mapping(0.9),
         "gicp": _gicp,
         "loam": _loam}


def _span_parents(spans):
    """Each span's name and the name of the innermost span holding it."""
    out = []
    for e in spans:
        holders = [p for p in spans if p is not e
                   and p.start_ns() <= e.start_ns()
                   and e.end_ns() <= p.end_ns()]
        inner = max(holders, key=lambda p: (p.start_ns(), -p.end_ns()),
                    default=None)
        out.append((e.name(), None if inner is None else inner.name()))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_and_count_as_the_program_counts(case):
    run, parents, fixed = CASES[case]()
    off_out, off_facts, _ = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(ROOT):
            on_out, on_facts, counts = run()
    assert not torch.autograd._profiler_enabled()
    # The session changes no output, bit for bit.
    assert on_facts == off_facts
    for a, b in zip(on_out, off_out):
        assert torch.equal(a, b)

    spans = [e for e in prof.profiler.kineto_results.events()
             if e.name().startswith((profiling.SPAN_PREFIX, ROOT))]
    assert len({e.start_thread_id() for e in spans}) == 1
    assert all(e.is_user_annotation() == (e.name() == ROOT) for e in spans)
    seen = Counter(e.name() for e in spans if e.name() != ROOT)
    assert set(seen) == set(parents)
    for name, parent in _span_parents(spans):
        if name != ROOT:
            want = parents[name]
            assert parent in (want if isinstance(want, set) else {want})
    for name, n in (fixed | counts).items():
        assert seen[name] == n, name
    assert counts[next(iter(counts))] > 0
