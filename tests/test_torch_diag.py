"""D1 and D2 of the PyTorch port, and their diagnostic entry points, against
the JAX scripts in ``benchmarks/`` on the CPU.

D1 (``ops/ranking_kernels``): the plain version of every mode against
``benchmarks/diag_bf16_concat.run_variant(..., interpret=True)`` at 256 x
2048, the smallest shape its grid tiles, on coordinates uniform in +-120 m.
Bound: 5e-7 of the largest ``|s . t|``, about 2x the largest difference
seen (2.1e-7, ``concat9``; ``bf16`` and ``3pass`` agree bit for bit):
both sum the same exact bf16 products in f32, in another order. The split
itself is held to JAX's ``hi``/``lo`` bit for bit.

D2 (``ops/gather_kernels``): the plain version against the JAX script's
batched gather (mode b) and against a copy of its Pallas kernel ``kern``
(``profile_gather_modes.py:136-157``, a closure inside ``main()``) run in
interpret mode, at 2 lanes, cap 256, 1024 ids a lane. Bound: 4e-6 absolute
on row sums of 16 standard normals, about 2x the largest difference seen
(1.9e-6): the 16 floats are added in another order.

The CUDA kernels themselves are held against these plain versions on the
card by ``test_torch_gpu.py``.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from toyslam_tpu_torch.diag import diag_bf16_concat  # noqa: E402
from toyslam_tpu_torch.diag import profile_gather_modes  # noqa: E402
from toyslam_tpu_torch.ops import gather_kernels, ranking_kernels  # noqa: E402

D1_RTOL = 5e-7  # of the largest |s.t|
D2_ATOL = 4e-6


@pytest.fixture(scope="module")
def jax_d1():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "diag_bf16_concat.py"
    spec = importlib.util.spec_from_file_location("_jax_diag_bf16", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def d1_inputs():
    rng = np.random.default_rng(0)
    s = rng.uniform(-120.0, 120.0, (256, 3)).astype(np.float32)
    t_t = np.ascontiguousarray(
        rng.uniform(-120.0, 120.0, (2048, 3)).astype(np.float32).T)
    return s, t_t


def test_split2_matches_jax_bit_for_bit(d1_inputs):
    for x in d1_inputs:
        hi, lo = ranking_kernels.split2(torch.from_numpy(x))
        jhi = jnp.asarray(x).astype(jnp.bfloat16)
        jlo = (jnp.asarray(x) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
        np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                      np.asarray(jhi).view(np.int16))
        np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                      np.asarray(jlo).view(np.int16))


@pytest.mark.parametrize("mode", ranking_kernels.MODES)
def test_split_dot_plain_matches_jax(jax_d1, d1_inputs, mode):
    s, t_t = d1_inputs
    want = np.asarray(jax_d1.run_variant(mode, jnp.asarray(s),
                                         jnp.asarray(t_t), interpret=True))
    got = ranking_kernels.split_dot(torch.from_numpy(s),
                                    torch.from_numpy(t_t), mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(s.astype(np.float64) @ t_t.astype(np.float64)).max()
    assert np.abs(got.numpy() - want).max() <= D1_RTOL * scale
    assert ranking_kernels.LAUNCHES[mode] == 0  # CPU tensors: no launch


def test_split_dot_rejects_unknown_mode(d1_inputs):
    s, t_t = (torch.from_numpy(a) for a in d1_inputs)
    with pytest.raises(ValueError):
        ranking_kernels.split_dot(s, t_t, "x6")


def _pallas_kern(lanes, cap, nk):
    """The JAX script's Pallas gather (profile_gather_modes.py:136-157)."""
    rn = nk // 128

    def kern(idx_ref, tab_ref, out_ref):
        ids = idx_ref[0]              # [RN, 128]
        tab = tab_ref[0]              # [cap, 16]
        ids2 = jnp.broadcast_to(ids.reshape(-1)[:, None], (rn * 128, 16))
        g = jnp.take_along_axis(tab, ids2, axis=0)  # [NK, 16]
        out_ref[0] = jnp.sum(g, axis=1).reshape(rn, 128)

    def pallas_gather(i, t):
        return pl.pallas_call(
            kern,
            grid=(lanes,),
            in_specs=[
                pl.BlockSpec((1, rn, 128), lambda b: (b, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, cap, 16), lambda b: (b, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, rn, 128), lambda b: (b, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((lanes, rn, 128), jnp.float32),
            interpret=True,
        )(i, t)

    return pallas_gather


def test_lane_row_sum_plain_matches_jax():
    lanes, cap, nk = 2, 256, 1024
    table, ids, _ = profile_gather_modes.inputs(lanes, cap, nk)
    got = gather_kernels.lane_row_sum(torch.from_numpy(ids),
                                      torch.from_numpy(table)).numpy()
    batched = np.asarray(jax.vmap(lambda i, t: jnp.sum(t[i], axis=1))(
        jnp.asarray(ids), jnp.asarray(table)))
    np.testing.assert_allclose(got, batched, rtol=0, atol=D2_ATOL)
    ids3 = ids.reshape(lanes, nk // 128, 128)
    pallas = np.asarray(_pallas_kern(lanes, cap, nk)(jnp.asarray(ids3),
                                                     jnp.asarray(table)))
    got3 = gather_kernels.lane_row_sum(torch.from_numpy(ids3),
                                       torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got3, got.reshape(ids3.shape))
    np.testing.assert_allclose(got3, pallas, rtol=0, atol=D2_ATOL)
    assert gather_kernels.LAUNCHES["lane_row_sum"] == 0


def test_lane_row_sum_plain_tree_and_ids_out_of_range():
    """The fixed tree ((r0 + r1) + (r2 + r3)) + ... of each row, and ids
    outside [0, cap) taken as JAX's ``t[ids]`` takes them (a negative id
    counts from the end, then ids are clamped)."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(3, 40, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-45, 45, size=(3, 77)).astype(
        np.int32))
    got = gather_kernels.lane_row_sum(ids, table)
    for b in range(3):
        rows = torch.from_numpy(np.array(
            jnp.asarray(table[b].numpy())[jnp.asarray(ids[b].numpy())]))
        w4 = [(rows[:, 4 * j] + rows[:, 4 * j + 1])
              + (rows[:, 4 * j + 2] + rows[:, 4 * j + 3]) for j in range(4)]
        assert torch.equal(got[b], (w4[0] + w4[1]) + (w4[2] + w4[3]))


def _run_main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_diag_bf16_concat_runs_on_cpu():
    out = _run_main(diag_bf16_concat.main, ["--device", "cpu", "--n", "300"])
    assert out["device"] == "cpu"
    assert set(out) == set(ranking_kernels.MODES) | {"device"}
    for mode in ranking_kernels.MODES:
        assert set(out[mode]) == {"max_rel_err", "ms_per_pass"}
        assert out[mode]["ms_per_pass"] > 0
    err = {m: out[m]["max_rel_err"] for m in ranking_kernels.MODES}
    # f32 < the two full splits < the two that drop a cross term
    assert err["highest"] < 1e-6
    assert max(err["3pass"], err["concat9"]) < 1e-4
    assert min(err["concat6"], err["bf16"]) > 1e-4


def test_profile_gather_modes_runs_on_cpu():
    out = _run_main(profile_gather_modes.main,
                    ["--device", "cpu", "--lanes", "2", "--cap", "64",
                     "--nk", "300"])
    rows = profile_gather_modes.single_rows(64)
    keys = ({f"single_tab{r}_ns_per_row" for r in rows}
            | {f"kernel_tab{r}_ns_per_row" for r in rows}
            | {"batched_ns_per_row", "batched_carry_ns_per_row",
               "flat_ns_per_row", "kernel_ns_per_row", "flat_matches",
               "kernel_matches", "device"})
    assert set(out) == keys
    assert out["flat_matches"] and out["kernel_matches"]
    assert out["device"] == "cpu"


@pytest.mark.parametrize("main", [diag_bf16_concat.main,
                                  profile_gather_modes.main])
def test_diag_entry_points_need_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--n", "8"] if main is diag_bf16_concat.main else
             ["--lanes", "1", "--cap", "8", "--nk", "8"])
