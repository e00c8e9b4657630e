"""K1-K3 of the PyTorch port against the JAX Pallas kernels.

The port's plain versions (``toyslam_tpu_torch/ops/ndt_kernels.py``) run
on the same numpy-made inputs as ``ops/ndt_pallas.ndt_terms_raw``,
``ndt_terms`` and ``ndt_repack`` in interpret mode, as
``tests/test_ndt.py:218-295`` runs them against the jnp path. Bounds are
those of that test (f32, summation order differs): score rtol 1e-5,
gradient rtol 1e-4 / atol 1e-5, Hessian rtol 1e-4 / atol 1e-4; the
repack does no arithmetic and must be bit-identical. The CUDA kernels
themselves are held against these plain versions on the card by
``test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pointcloud  # noqa: E402
from toyslam_tpu.ops import ndt_pallas  # noqa: E402
from toyslam_tpu.registration import ndt  # noqa: E402
from toyslam_tpu_torch import convert  # noqa: E402
from toyslam_tpu_torch.ops import ndt_kernels  # noqa: E402
from toyslam_tpu_torch.registration import ndt as tndt  # noqa: E402

N_SRC = 1024  # the Pallas kernels take N % 1024 == 0
OFFS = ndt._OFFSETS["DIRECT7"]


def _scene(rng, n):
    """Floor + two walls + noise, f64 (as tests/test_ndt.py builds it)."""
    floor = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                      0.05 * rng.normal(size=n)], 1)
    wall1 = np.stack([rng.uniform(-20, 20, n // 2),
                      8.0 + 0.05 * rng.normal(size=n // 2),
                      rng.uniform(0, 5, n // 2)], 1)
    wall2 = np.stack([-12.0 + 0.05 * rng.normal(size=n // 2),
                      rng.uniform(-20, 20, n // 2),
                      rng.uniform(0, 5, n // 2)], 1)
    return np.concatenate([floor, wall1, wall2], 0)


@pytest.fixture(scope="module")
def case():
    """One JAX f32 map, a source cloud with masked lanes, a pose, and the
    kernel inputs of both packages built from them."""
    rng = np.random.default_rng(7)
    pts = _scene(rng, 700)
    cfg = ndt.NDTConfig(resolution=2.0, map_capacity=2048,
                        grid_capacity=1 << 14)
    m = jax.jit(ndt.build_ndt_map, static_argnums=1)(
        pointcloud.from_numpy(pts, capacity=2048, dtype=jnp.float32), cfg)
    src = (np.tile(pts, (2, 1))[:N_SRC] + 0.1).astype(np.float32)
    mask = np.arange(N_SRC) % 13 != 0
    p = np.array([0.05, -0.1, 0.08, 0.02, -0.03, 0.05], np.float32)
    d1, d2, _ = ndt.gauss_coefficients(2.0, 0.55, jnp.float32)

    # JAX side: exactly the operands compute_derivatives hands its kernels.
    src_j, mask_j, p_j = jnp.asarray(src), jnp.asarray(mask), jnp.asarray(p)
    K = len(OFFS)

    @jax.jit
    def operands(m, src_j, mask_j, p_j):
        T = ndt.se3.pose6_to_matrix(p_j)
        j_tab, h_tab = ndt._angle_tables(p_j, jnp.float32)
        params = jnp.concatenate([jnp.stack([d1, d2]), T[:3, :].reshape(-1),
                                  j_tab.reshape(-1), h_tab.reshape(-1)])
        h, nvid, ok = ndt._neighbor_hash(m, src_j, p_j, 2.0, OFFS)
        aux = ndt._aux_channels(nvid, ok, mask_j, N_SRC, K, jnp.float32)
        return params, h, nvid, ok, aux, m.hash_table[h]

    params, h, nvid, ok, aux, raw = operands(m, src_j, mask_j, p_j)
    xyz3 = src_j.T.reshape(3, N_SRC // 128, 128)

    okm = np.asarray(ok) & np.tile(mask, K)
    port = dict(
        params=torch.tensor(np.asarray(params)),
        xyz=torch.from_numpy(np.ascontiguousarray(src.T)),
        table=torch.tensor(np.asarray(m.hash_table)),
        h=torch.tensor(np.asarray(h, np.int32)),
        nvid=torch.tensor(np.asarray(nvid, np.int32)),
        okm=torch.from_numpy(okm),
    )
    return dict(m=m, src=src, mask=mask, p=p, params=params, xyz3=xyz3,
                aux=aux, raw=raw, port=port, K=K, h=h, nvid=nvid, ok=ok)


def _assert_terms(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:7], want[1:7], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[7:], want[7:], rtol=1e-4, atol=1e-4)


def test_neighbor_hash_matches_jax(case):
    """The plain-torch hash that feeds K1/K2 gives the JAX slots exactly."""
    tm = convert.ndt_map({k: np.asarray(v)
                          for k, v in case["m"]._asdict().items()},
                         device="cpu")
    ev = tndt._Evaluator(tm, torch.from_numpy(case["src"]),
                         torch.from_numpy(case["mask"]), 2.0, OFFS, 0, 0)
    h, nvid, okm = ev.neighbor_hash(case["port"]["params"])
    np.testing.assert_array_equal(h.numpy(), np.asarray(case["h"]))
    np.testing.assert_array_equal(nvid.numpy(), np.asarray(case["nvid"]))
    np.testing.assert_array_equal(okm.numpy(), case["port"]["okm"].numpy())


def test_k1_plain_matches_pallas_raw(case):
    want = ndt_pallas.ndt_terms_raw(case["params"].reshape(1, 83),
                                    case["xyz3"], case["aux"], case["raw"],
                                    interpret=True)
    q = case["port"]
    got = ndt_kernels.ndt_terms_gathered_plain(
        q["params"], q["xyz"], q["table"], q["h"], q["nvid"], q["okm"])
    _assert_terms(got.numpy(), want)


def test_k2_plain_bit_identical_to_pallas_repack(case):
    want = ndt_pallas.ndt_repack(case["aux"], case["raw"], interpret=True)
    q = case["port"]
    got = ndt_kernels.ndt_gather_repack_plain(q["table"], q["h"], q["nvid"],
                                              q["okm"])
    want = np.asarray(want).reshape(10, -1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert 0 < want[9].sum() < want.shape[1]  # the gate is exercised


def test_k3_plain_matches_pallas_packed(case):
    stats10 = ndt_pallas.ndt_repack(case["aux"], case["raw"], interpret=True)
    want = ndt_pallas.ndt_terms(case["params"].reshape(1, 83), case["xyz3"],
                                stats10, interpret=True)
    q = case["port"]
    got = ndt_kernels.ndt_terms_packed_plain(
        q["params"], q["xyz"], torch.tensor(np.asarray(stats10)
                                            ).reshape(10, -1))
    _assert_terms(got.numpy(), want)


def test_wrappers_take_cpu_tensors_to_plain(case):
    """On CPU tensors each wrapper is its plain version and launches
    nothing; a device with no kernel raises instead of falling back."""
    q = case["port"]
    ndt_kernels.reset_launch_counts()
    stats = ndt_kernels.ndt_gather_repack(q["table"], q["h"], q["nvid"],
                                          q["okm"])
    assert torch.equal(stats, ndt_kernels.ndt_gather_repack_plain(
        q["table"], q["h"], q["nvid"], q["okm"]))
    assert torch.equal(
        ndt_kernels.ndt_terms_packed(q["params"], q["xyz"], stats),
        ndt_kernels.ndt_terms_packed_plain(q["params"], q["xyz"], stats))
    assert torch.equal(
        ndt_kernels.ndt_terms_gathered(q["params"], q["xyz"], q["table"],
                                       q["h"], q["nvid"], q["okm"]),
        ndt_kernels.ndt_terms_gathered_plain(q["params"], q["xyz"],
                                             q["table"], q["h"], q["nvid"],
                                             q["okm"]))
    assert set(ndt_kernels.LAUNCHES.values()) == {0}
    meta = {k: v.to("meta") for k, v in q.items()}
    with pytest.raises(ValueError, match="no NDT kernel"):
        ndt_kernels.ndt_terms_packed(meta["params"], meta["xyz"],
                                     stats.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        ndt_kernels.ndt_terms_packed(q["params"], meta["xyz"], stats)
