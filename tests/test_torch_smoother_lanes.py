"""The port's lane smoother (``pipelines/batch_fusion.batch_fusion_lanes``,
``parallel/batch.sharded_batch_fusion``) against the JAX package's
``vmap(batch_fusion)``, on the CPU, in f64.

Inputs are ``tests/test_batch_fusion.py``'s logs (``_make_log``: a 3 m
circle, the IMU and 0.1 m fixes from ``jax.random``, 20 samples a
keyframe, window 6, 4 Gauss-Newton steps); JAX's side is one jit. Bounds,
each about twice what was observed:

- (a) 8 lanes of 5 keyframes (seeds 10-17, JAX's
  ``test_sharded_batch_fusion_matches_single_device``) through
  ``sharded_batch_fusion`` over ``make_mesh(8, "cpu")``: keyframe
  positions within 6e-8 m of JAX's (observed 2.8e-8; JAX's own bound is
  1e-6 m), velocities within 2.5e-6 m/s (observed 1.1e-6), the same
  resets and counts;
- (b) 4 lanes of 10 keyframes (seeds 20-23), more than the window holds,
  so the batched marginalisation runs 4 times: positions within 1e-6 m
  (observed 4.6e-7), velocities within 1e-5 m/s (observed 4.6e-6), the
  final priors within 4e-7 of their largest entry (observed 1.9e-7);
- (c) 16 lanes of 5 keyframes (seeds 30-45): chunks 1, 2 and 16; chunk 1
  equals the port's single-log ``batch_fusion`` bit for bit (a lane of
  one is that function; lanes 0, 7 and 15 checked), chunk 2 equals chunk
  16 bit for bit, and chunk 16 lies within 2e-8 m of chunk 1 (observed
  8.1e-9): batched products of one matrix and of several round
  differently; the lane window that ``cat_lanes`` joins keeps every
  leaf's lane axis.

This configuration (UWB mode, 0.1 m fixes, no velocity fixes) leaves the
window's normal equations far worse conditioned than
``tests/test_torch_smoother.py``'s GPS log, and rounding alone moves the
result: JAX's own single-log ``batch_fusion`` and its ``vmap`` part by up
to 3.6e-8 m on (a)'s logs and 2.8e-7 m on (b)'s.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_batch_fusion as jtest_bf  # noqa: E402

from toyslam_tpu.estimators import window as jwindow  # noqa: E402
from toyslam_tpu.pipelines import batch_fusion as jbf  # noqa: E402
from toyslam_tpu_torch.estimators import window as twindow  # noqa: E402
from toyslam_tpu_torch.parallel import batch as tbatch  # noqa: E402
from toyslam_tpu_torch.pipelines import batch_fusion as tbf  # noqa: E402

WIN = dict(window_size=6, gn_iterations=4, pos_sigma=0.1)
SHORT_P, SHORT_V = 6e-8, 2.5e-6
LONG_P, LONG_V, LONG_PRIOR = 1e-6, 1e-5, 4e-7
CHUNK_P = 2e-8


def _logs(seeds, n_kf):
    """``_make_log``'s inputs of ``batch_fusion`` for each seed, stacked
    on a lane axis, as numpy f64."""
    logs = [jtest_bf._make_log(n_kf=n_kf, imu_per_kf=20, seed=s,
                               gps_sigma=0.1) for s in seeds]
    out = [np.stack([np.asarray(lg[i]) for lg in logs]) for i in range(6)]
    return out + [np.ones((len(seeds), n_kf), bool)]


CASES = {"short": (range(10, 18), 5), "long": (range(20, 24), 10),
         "chunks": (range(30, 46), 5)}


@pytest.fixture(scope="module")
def runs():
    logs = {k: _logs(*v) for k, v in CASES.items()}
    jcfg = jbf.BatchFusionConfig(window=jwindow.WindowConfig(**WIN))

    def jax_side(short, long_):
        one = jax.vmap(lambda *a: jbf.batch_fusion(*a, config=jcfg))
        return one(*short), one(*long_)

    want = jax.jit(jax_side)(*([jnp.asarray(a) for a in logs[k]]
                               for k in ("short", "long")))
    return logs, want


def _torch(log):
    return [torch.from_numpy(a) for a in log]


CFG = tbf.BatchFusionConfig(window=twindow.WindowConfig(**WIN))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_sharded_batch_fusion_matches_jax_vmap(runs):
    logs, (want, _) = runs
    got = tbatch.sharded_batch_fusion(tbatch.make_mesh(8, "cpu"),
                                      *_torch(logs["short"]), config=CFG)
    assert got.kf_p.shape == (8, 5, 3)
    assert np.isfinite(got.kf_p.numpy()).all()
    _close(got.kf_p, want.kf_p, SHORT_P)
    _close(got.kf_v, want.kf_v, SHORT_V)
    np.testing.assert_array_equal(got.reset.numpy(), np.asarray(want.reset))
    np.testing.assert_array_equal(got.win.count.numpy(),
                                  np.asarray(want.win.count))


def test_sharded_batch_fusion_marginalizes_like_jax(runs):
    logs, (_, want) = runs
    got = tbatch.sharded_batch_fusion(tbatch.make_mesh(2, "cpu"),
                                      *_torch(logs["long"]), config=CFG)
    assert got.kf_p.shape == (4, 10, 3)
    assert bool(got.win.prior_valid.all()) and bool(
        (got.win.count == WIN["window_size"]).all())
    _close(got.kf_p, want.kf_p, LONG_P)
    _close(got.kf_v, want.kf_v, LONG_V)
    np.testing.assert_array_equal(got.reset.numpy(), np.asarray(want.reset))
    jprior = np.asarray(want.win.prior_sqrt_info)
    for b in range(4):
        _close(got.win.prior_sqrt_info[b], jprior[b],
               LONG_PRIOR * float(np.abs(jprior[b]).max()))


def test_lanes_match_single_logs_and_chunks(runs):
    logs, _ = runs
    args = _torch(logs["chunks"])
    mesh = tbatch.make_mesh(device="cpu")
    by_chunk = {c: tbatch.sharded_batch_fusion(mesh, *args, config=CFG,
                                               chunk=c) for c in (1, 2, 16)}
    fields = tbf.BatchFusionOutput._fields[:6]
    for f in fields:
        assert torch.equal(getattr(by_chunk[2], f), getattr(by_chunk[16], f))
    for a, b in zip(twindow._leaves(by_chunk[2].win),
                    twindow._leaves(by_chunk[16].win)):
        assert a.shape[0] == 16 and torch.equal(a, b)
    _close(by_chunk[16].kf_p, by_chunk[1].kf_p.numpy(), CHUNK_P)
    np.testing.assert_array_equal(by_chunk[16].reset.numpy(),
                                  by_chunk[1].reset.numpy())
    for b in (0, 7, 15):
        single = tbf.batch_fusion(*(a[b] for a in args), config=CFG)
        for f in fields:
            assert torch.equal(getattr(by_chunk[1], f)[b],
                               getattr(single, f))
