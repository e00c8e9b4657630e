"""The GN update after K6 (``ops/gicp_kernels.gicp_update``) on the CPU.

- ``gicp_update_plain`` equals, bit for bit, the step that ``gicp_align``
  took before the update was a kernel (``_step_before`` below, copied with
  its index of the 27 sums), in f32 and f64: on K6's plain sums of
  generated correspondences, and on the same sums with the gradient scaled
  down until the rotation step falls below ``so3_exp``'s 1e-7 rad Taylor
  branch.
- ``gicp_align`` on CPU tensors reaches ``gicp_kernels.gicp_terms`` and
  ``gicp_kernels.gicp_update`` through the module, ``iterations x
  inner_iterations`` times each: a patch of the module's ``gicp_terms``
  sees every step's sums (the route a planted fault takes).

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

from toyslam_tpu_torch.core import se3  # noqa: E402
from toyslam_tpu_torch.core.pointcloud import PointCloud  # noqa: E402
from toyslam_tpu_torch.ops import gicp_kernels  # noqa: E402
from toyslam_tpu_torch.registration import gicp  # noqa: E402

DAMPING = gicp.GICPConfig().damping


def _a_index_before():
    upper = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}

    def at(i, j):
        if i < 3 and j < 3:
            return 6 + upper[min(i, j), max(i, j)]
        if i < 3:
            return 12 + 3 * i + (j - 3)
        if j < 3:
            return 12 + 3 * j + (i - 3)
        return 21 + upper[min(i, j) - 3, max(i, j) - 3]

    return [at(i, j) for i in range(6) for j in range(6)]


def _step_before(s27, R, t, damping):
    """The step after K6 as ``gicp_align`` took it before ``gicp_update``."""
    a_index = torch.tensor(_a_index_before())
    A = s27[a_index].reshape(6, 6) + damping * torch.eye(6, dtype=s27.dtype)
    dx = -torch.linalg.solve_ex(A, s27[:6]).result
    return se3.so3_exp(dx[3:6]) @ R, t + dx[:3]


def _sums(dtype, n=500, seed=0):
    """K6's plain sums over ``n`` generated correspondences (SPD
    Mahalanobis, 30 % rejected) at a pose ``params``."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-20, 20, (3, n))
    q = xyz + rng.normal(0, 0.1, (3, n))
    L = rng.normal(size=(n, 3, 3))
    M = L @ L.transpose(0, 2, 1) + np.eye(3)
    m6 = M[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T
    w = (rng.uniform(size=n) > 0.3).astype(np.float64)
    R = se3.so3_exp(torch.from_numpy(rng.normal(size=3))).numpy()
    params = np.concatenate([R.reshape(-1), rng.uniform(-5, 5, 3)])
    params, xyz, q, m6, w = (torch.tensor(a, dtype=dtype)
                             for a in (params, xyz, q, m6, w))
    return gicp_kernels.gicp_terms_plain(params, xyz, q, m6, w), params


@pytest.mark.parametrize("taylor", [False, True], ids=["rodrigues",
                                                       "taylor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_update_plain_equals_the_step_before(dtype, taylor):
    s27, params = _sums(dtype)
    if taylor:  # the rotation step ~1e-9 rad: below the 1e-7 branch
        s27 = torch.cat([s27[:6] * 1e-9, s27[6:]])
    R, t = params[:9].reshape(3, 3), params[9:]
    want_R, want_t = _step_before(s27, R, t, DAMPING)
    got = gicp_kernels.gicp_update_plain(s27, params, DAMPING)
    assert got.dtype == dtype and got.shape == (12,)
    assert torch.equal(got, torch.cat([want_R.reshape(-1), want_t]))

    A = (s27[gicp_kernels.A_INDEX].reshape(6, 6).double()
         + DAMPING * torch.eye(6, dtype=torch.float64))
    theta = float(torch.linalg.norm(torch.linalg.solve(
        A, s27[:6].double())[3:]))
    assert (theta < 1e-7) if taylor else (theta > 1e-4)


def _plane_cloud(rng, n=480, cap=512):
    m = n // 3
    z = 0.02 * rng.normal(size=m)
    pts = np.concatenate([
        np.stack([rng.uniform(-10, 10, m), rng.uniform(-10, 10, m), z], 1),
        np.stack([rng.uniform(-10, 10, m), 5.0 + z, rng.uniform(0, 4, m)], 1),
        np.stack([-8.0 + z, rng.uniform(-10, 5, m), rng.uniform(0, 4, m)],
                 1)])
    xyzi = np.zeros((cap, 4), np.float32)
    xyzi[:len(pts), :3] = pts
    return PointCloud(torch.from_numpy(xyzi),
                      torch.from_numpy(np.arange(cap) < len(pts)))


def test_gicp_align_calls_the_step_through_the_module(monkeypatch):
    rng = np.random.default_rng(3)
    tgt, src = _plane_cloud(rng), _plane_cloud(rng)
    guess = torch.eye(4)
    guess[:3, 3] = torch.tensor([0.2, -0.1, 0.05])
    cfg = gicp.GICPConfig()
    want = gicp.gicp_align(src, tgt, guess, cfg)

    calls = {"gicp_terms": 0, "gicp_update": 0}
    for name in calls:
        def counted(*args, _fn=getattr(gicp_kernels, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(gicp_kernels, name, counted)
    got = gicp.gicp_align(src, tgt, guess, cfg)
    assert got.iterations >= 2
    n = got.iterations * cfg.inner_iterations
    assert calls == {"gicp_terms": n, "gicp_update": n}
    assert torch.equal(got.transform, want.transform)
