"""The eigensolver's dispatch (``ops/eigh3.eigh3_soa``) and the wrapper of
its CUDA kernel (``ops/eigh3_kernels``), on the CPU.

- On CPU tensors ``eigh3_soa`` is ``eigh3_soa_plain`` bit for bit, in
  float32 and float64, on ``tests/eigh3_cases.matrices``' edge cases (zero
  and diagonal matrices, ``app == aqq``, repeated eigenvalues, entries
  near 1e18 and 1e36, NaN and inf rows) passed as the callers pass them
  (stride-9 views of ``[N, 3, 3]``, stride-6 views of ``[B, V, 6]``),
  and launches nothing.
- ``flat_stride`` finds the one stride of those views, and none where
  there is none; the wrapper refuses dtypes the kernel does not take.
- LOAM's factors, GICP's covariances and the NDT map build reach the
  kernel's entry point through the dispatch (counted by a stand-in for
  it that computes the plain version): 20 calls a ``loam_step``, 2 a
  ``gicp_align``, 1 a ``build_ndt_map``, each run bit-identical to the
  unpatched run.
- ``ops/launches`` reads and zeroes the kernel's ``"eigh3"`` count.

The kernel itself is held to ``eigh3_soa_plain`` on the card
(``tests/test_torch_gpu.py``).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

from toyslam_tpu_torch.core.pointcloud import PointCloud  # noqa: E402
from eigh3_cases import components, map_components, matrices  # noqa: E402
from toyslam_tpu_torch.ops import eigh3, eigh3_kernels  # noqa: E402
from toyslam_tpu_torch.ops import launches  # noqa: E402
from toyslam_tpu_torch.pipelines import loam  # noqa: E402
from toyslam_tpu_torch.registration import gicp, ndt  # noqa: E402
from toyslam_tpu_torch.sim import loam_world  # noqa: E402

INT = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(ts, dtype):
    return torch.stack([t.reshape(-1) for t in ts]).view(INT[dtype])


def _layouts(a):
    """The six components of ``a [N, 3, 3]`` as stride-9 views, and as
    stride-6 views of a ``[2, N / 2, 6]`` tensor (the map build's
    ``unbind(-1)``)."""
    return {"stride9": components(a), "stride6": map_components(a, 2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_eigh3_soa_is_plain_bit_for_bit(dtype):
    a = matrices(300, dtype, "cpu")
    eigh3_kernels.reset_launch_counts()
    for name, comps in _layouts(a).items():
        ev, vec = eigh3.eigh3_soa(*comps)
        ev_p, vec_p = eigh3.eigh3_soa_plain(*comps)
        assert len(ev) == 3 and len(vec) == 9, name
        assert ev[0].shape == comps[0].shape and ev[0].dtype == dtype
        assert torch.equal(_bits(ev, dtype), _bits(ev_p, dtype)), name
        assert torch.equal(_bits(vec, dtype), _bits(vec_p, dtype)), name
    assert eigh3_kernels.LAUNCHES == {"eigh3": 0}
    # The edge rows ran: a NaN row is NaN throughout, a zero row zero.
    ev, _ = eigh3.eigh3_soa(*components(a))
    ev = torch.stack(ev, -1)
    assert bool(torch.isnan(ev[12:17]).all()) and not bool(ev[0].any())


def test_flat_stride_of_the_callers_views():
    a = torch.zeros(5, 3, 3)
    assert [eigh3_kernels.flat_stride(c) for c in components(a)] == [9] * 6
    six = torch.zeros(2, 4, 6)
    assert [eigh3_kernels.flat_stride(c) for c in six.unbind(-1)] == [6] * 6
    assert eigh3_kernels.flat_stride(torch.zeros(7)) == 1
    assert eigh3_kernels.flat_stride(torch.zeros(1).expand(7)) == 0
    assert eigh3_kernels.flat_stride(torch.zeros(())) == 1
    assert eigh3_kernels.flat_stride(torch.zeros(4, 6)[:, :3]) is None
    assert eigh3_kernels.flat_stride(torch.zeros(5).expand(3, 5)) is None


def test_wrapper_refuses_what_the_kernel_does_not_take():
    half = components(torch.zeros(4, 3, 3, dtype=torch.float16))
    with pytest.raises(TypeError):
        eigh3_kernels.eigh3_soa_cuda(*half)
    mixed = list(components(torch.zeros(4, 3, 3)))
    mixed[2] = mixed[2].double()
    with pytest.raises(TypeError):
        eigh3_kernels.eigh3_soa_cuda(*mixed)


def _loam_step():
    scans, _ = loam_world.drive(2, 3, step_dtype=np.float64)
    xyzi, mask = (torch.from_numpy(a) for a in loam_world.pack(scans))
    cfg = loam.LoamConfig(n_rings=16, vertical_fov_deg=(-25.0, 5.0),
                          max_edge_features=64, max_surf_features=128,
                          map_capacity_edge=256, map_capacity_surf=512)
    state = loam.loam_init(PointCloud(xyzi[0], mask[0]), cfg)
    _, out = loam.loam_step(state, PointCloud(xyzi[1], mask[1]), cfg)
    return torch.cat([out.q, out.t])


def _clouds(capacity):
    rng = np.random.default_rng(5)
    walls = [np.c_[rng.uniform(-5, 5, 150), rng.uniform(-5, 5, 150),
                   np.full(150, z)] for z in (-1.0, 2.0)]
    walls.append(np.c_[np.full(150, 4.0), rng.uniform(-5, 5, 150),
                       rng.uniform(-1, 2, 150)])
    pts = np.concatenate(walls).astype(np.float32)
    pad = np.zeros((capacity, 4), np.float32)
    pad[:len(pts), :3] = pts
    mask = np.arange(capacity) < len(pts)
    return torch.from_numpy(pad), torch.from_numpy(mask)


def _gicp_align():
    xyzi, mask = _clouds(512)
    src = xyzi.clone()
    src[:, 0] += 0.05
    res = gicp.gicp_align(PointCloud(src, mask), PointCloud(xyzi, mask))
    return torch.as_tensor(res.transform)


def _build_ndt_map():
    m = ndt.build_ndt_map(PointCloud(*_clouds(512)),
                          ndt.NDTConfig(grid_capacity=1024, map_capacity=256))
    return torch.cat([m.mean3.reshape(-1), m.icov6.reshape(-1)])


@pytest.mark.parametrize("run,calls", [(_loam_step, 20), (_gicp_align, 2),
                                       (_build_ndt_map, 1)],
                         ids=["loam_step", "gicp_align", "build_ndt_map"])
def test_callers_reach_the_kernel_through_the_dispatch(monkeypatch, run,
                                                       calls):
    want = run()
    seen = []

    def entry(*comps, **kw):  # the kernel's entry point, computed plainly
        seen.append(comps[0].shape)
        return eigh3.eigh3_soa_plain(*comps, **kw)

    monkeypatch.setattr(eigh3, "_cuda", types.SimpleNamespace(
        on_cpu=lambda kind, *tensors: False))
    monkeypatch.setattr(eigh3_kernels, "eigh3_soa_cuda", entry)
    got = run()
    assert len(seen) == calls
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_launches_reads_and_resets_the_eigh3_count():
    eigh3_kernels.LAUNCHES["eigh3"] = 3
    assert launches.launches()["eigh3"] == 3
    launches.reset_launches()
    assert launches.launches()["eigh3"] == 0
