"""``stages.read`` on synthetic profiler events (times in microseconds,
as ``FunctionEvent.time_range`` has them): a session with only the
benchmark's unit spans reads exactly as ``trace.Session.summary()``; idle
gaps go to the innermost span open on the host, by span and by path;
annotations on the device's timeline are no device work; each span's host
time and each device operation land on the path they were made in."""

from types import SimpleNamespace

import pytest
import torch

from portbench import stages, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=False, annotation=False, kernels=()):
    """The fields of a ``FunctionEvent`` that the readers read."""
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=CUDA if device else CPU, is_user_annotation=annotation,
        kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels])


def kernel(name, start, end):
    return ev(name, start, end, device=True)


def summary(events) -> trace.Summary:
    s = trace.Session.__new__(trace.Session)
    s.prof = SimpleNamespace(events=lambda: events)
    s.counted = {}
    return s.summary()


def unit_session():
    """Three scans in a window [100, 1100], device work in and around
    them, the primer before the window and the units' annotations on the
    device, as the harness's sessions have them."""
    return [
        ev("portbench.traced", 100, 1100, annotation=True),
        kernel("void spin_kernel(long)", 0, 90),
        ev("portbench.scan", 110, 400, annotation=True),
        ev("portbench.scan", 420, 700, annotation=True),
        ev("portbench.scan", 730, 1090, annotation=True),
        ev("portbench.scan", 150, 380, device=True, annotation=True),
        kernel("segment_reduce_k", 95, 130),
        kernel("terms_packed_kernel", 200, 260),
        kernel("terms_packed_kernel", 250, 300),
        kernel("elementwise_k", 650, 760),
        kernel("elementwise_k", 1080, 1150),
    ]


def test_a_session_of_unit_spans_reads_as_the_harness():
    events = unit_session()
    got, want = stages.read(events), summary(events)
    assert (got.window_s, got.busy_s, got.ops, got.by_name,
            got.idle_by_span) == (want.window_s, want.busy_s, want.ops,
                                  want.by_name, want.idle_by_span)
    assert set(got.idle_by_path) == {("portbench.scan",), ()}
    assert got.idle_by_path[()] == pytest.approx(
        got.idle_by_span["outside_calls"], abs=1e-15)


def test_idle_goes_to_the_innermost_span():
    # One scan [0, 1000]: mapping.step [100, 900] holds the align [200,
    # 600], which holds two evaluations [250, 350] and [400, 500], each
    # with its sync in its last 50; the merge [650, 850]. The device is
    # busy [0, 100] and [300, 450] only.
    events = [
        ev("portbench.traced", 0, 1000, annotation=True),
        ev("portbench.scan", 0, 1000, annotation=True),
        ev("toyslam.mapping.step", 100, 900),
        ev("toyslam.ndt.align", 200, 600),
        ev("toyslam.ndt.derivs", 250, 350),
        ev("toyslam.ndt.sync", 300, 350),
        ev("toyslam.ndt.derivs", 400, 500),
        ev("toyslam.ndt.sync", 450, 500),
        ev("toyslam.mapping.merge", 650, 850),
        kernel("k", 0, 100),
        kernel("k", 300, 450),
    ]
    st = stages.read(events)
    us = 1e-6
    scan = ("portbench.scan",)
    step = scan + ("toyslam.mapping.step",)
    align = step + ("toyslam.ndt.align",)
    derivs = align + ("toyslam.ndt.derivs",)
    want = {
        step: (100 + 50 + 50) * us,  # [100, 200], [600, 650], [850, 900]
        align: (50 + 100) * us,  # [200, 250], [500, 600]
        derivs: 50 * us,  # [250, 300]; [450, 500] is the sync's
        derivs + ("toyslam.ndt.sync",): 50 * us,
        step + ("toyslam.mapping.merge",): 200 * us,
        scan: 100 * us,  # [900, 1000]
    }
    assert st.idle_by_path.keys() == want.keys()
    for path, s in want.items():
        assert st.idle_by_path[path] == pytest.approx(s, rel=1e-12)
    assert st.idle_by_span["toyslam.ndt.derivs"] == pytest.approx(50 * us)
    assert "outside_calls" not in st.idle_by_span
    idle = st.window_s - st.busy_s
    assert sum(st.idle_by_path.values()) == pytest.approx(idle, rel=1e-12)
    assert stages.subtree(st.idle_by_path, "toyslam.ndt.align") == (
        pytest.approx(250 * us, rel=1e-12))
    # Host time of each span, on its path.
    assert st.host_by_path[derivs] == [2, pytest.approx(200 * us)]
    assert st.host_by_path[align] == [1, pytest.approx(400 * us)]


def test_annotations_are_no_device_work():
    base = unit_session()
    annotated = base + [
        ev("toyslam.ndt.align", 150, 390, device=True, annotation=True),
        ev("toyslam.mapping.merge", 500, 600, device=True),
        ev("some_user_range", 800, 900, device=True, annotation=True),
    ]
    got, want = stages.read(annotated), stages.read(base)
    assert (got.busy_s, got.ops, got.by_name, got.idle_by_span) == (
        want.busy_s, want.ops, want.by_name, want.idle_by_span)
    assert got.ops == 5


def test_device_operations_land_where_they_were_launched():
    events = [
        ev("portbench.traced", 0, 1000, annotation=True),
        ev("portbench.align", 0, 1000, annotation=True,
           kernels=[("portbench.align", 900)]),
        ev("toyslam.gicp.align", 10, 990),
        ev("toyslam.gicp.gn_step", 100, 200,
           kernels=[("gicp_terms_kernel", 4.0)]),
        ev("aten::linalg_solve_ex", 120, 180,
           kernels=[("getrf", 3.0), ("getrs", 1.0)]),
        ev("aten::topk", 300, 400, kernels=[("gatherTopK", 50.0)]),
        ev("aten::add", 1005, 1010, kernels=[("add", 1.0)]),
    ]
    st = stages.read(events)
    step = ("portbench.align", "toyslam.gicp.align", "toyslam.gicp.gn_step")
    assert st.device_by_path == {
        step: [3, pytest.approx(8e-6)],
        step[:2]: [1, pytest.approx(50e-6)],
    }


def test_a_session_without_its_window_is_lost():
    with pytest.raises(trace.LostEvents):
        stages.read([ev("portbench.scan", 0, 10, annotation=True)])
