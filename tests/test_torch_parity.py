"""Every public name of the JAX package has a counterpart in the PyTorch
port.

Both packages are read with ``ast`` and neither is imported. For each
module of ``toyslam_tpu/`` the port module of the same path must bind
each public top-level name the JAX module defines (functions, classes,
constants, and the upper-case constants it imports from its own package),
each field of each class (NamedTuple and dataclass fields), and each
parameter of each function. A counterpart may be any top-level binding of
the port module, an import included (``sim/urban.SPEED_OF_LIGHT`` comes
from ``core/geodesy`` there).

What the port leaves out on purpose stands in ``ALLOWED`` with its reason:
TPU-only modules, layout helpers and dispatch knobs, mesh axis names, and
JAX PRNG keys, which the port replaces with ``torch.Generator``s
(``RENAMED``). ``test_allow_list_is_current`` fails when an entry no
longer differs, so the list cannot go stale.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "toyslam_tpu"
PORT_PKG = ROOT / "toyslam_tpu_torch"

_PALLAS = ("a Pallas kernel module; its kernels are the hand-written CUDA "
           "kernels of {}")
_USE_PALLAS = ("chooses the Pallas kernel or the jnp path on the TPU; the "
               "port dispatches on the tensors' device")
_AXIS = ("a JAX mesh axis name for shard_map; the port's mesh is a list of "
         "devices")
_KEY = "a JAX PRNG key; the port draws from a torch.Generator `generator`"

# (module,) a whole module; (module, name) a top-level name; (module, name,
# member) a class field or a function parameter. Paths are relative to the
# package root.
ALLOWED = {
    ("ops/ndt_pallas.py",): _PALLAS.format("ops/ndt_kernels.py (K1-K3)"),
    ("ops/nn_pallas.py",): _PALLAS.format("ops/nn_kernels.py (K4, K5)"),
    ("ops/gicp_pallas.py",): _PALLAS.format("ops/gicp_kernels.py (K6)"),
    ("ops/gatherflat.py",): "a custom_vmap lowering of batched gathers for "
                            "XLA on the TPU; torch indexes lanes directly",
    ("ops/segtree.py",): "a lane tree that avoids TPU scatters; the port "
                         "sums sorted runs in ops/segment.py",
    ("core/pointcloud.py", "soa_channels"):
        "splits [N, 4] into lane-dense 1D channels for the TPU's (8, 128) "
        "tiles; torch slices the columns",
    ("core/pointcloud.py", "masked_min_max"):
        "the SoA bounds helper of the TPU layout; the port's bounds are in "
        "voxel_grid_lanes",
    ("core/se3.py", "mm"): "a matmul at Precision.HIGHEST against the TPU's "
                           "bf16 default; torch multiplies in the input dtype",
    ("core/se3.py", "HIGHEST"): "the XLA precision constant that mm uses",
    ("registration/ndt.py", "gather_neighborhood_raw"):
        "packs the 16-bit id halves for the Pallas K1's gate; the port's K1 "
        "hashes and gates in-kernel",
    ("registration/ndt.py", "NDTConfig", "use_pallas"): _USE_PALLAS,
    ("registration/ndt.py", "NDTConfig", "repack_pallas"): _USE_PALLAS,
    ("registration/ndt.py", "gather_neighborhood", "use_pallas"): _USE_PALLAS,
    ("registration/ndt.py", "compute_derivatives", "use_pallas"): _USE_PALLAS,
    ("registration/gicp.py", "GICPConfig", "use_pallas_nn"): _USE_PALLAS,
    ("registration/gicp.py", "GICPConfig", "use_pallas_terms"): _USE_PALLAS,
    ("registration/gicp.py", "GICPConfig", "use_pallas_cov"): _USE_PALLAS,
    ("registration/gicp.py", "GICPConfig", "nn_mode"):
        "picks one of the Pallas K4's TPU modes; the port has one K4",
    ("registration/gicp.py", "compute_covariances", "use_pallas"):
        _USE_PALLAS,
    ("registration/gicp.py", "compute_covariances", "interpret"):
        "runs the Pallas kernel in interpret mode off the TPU; a CUDA kernel "
        "has no such mode",
    ("registration/icp.py", "ICPConfig", "use_pallas_nn"): _USE_PALLAS,
    ("registration/icp.py", "ICPConfig", "nn_mode"):
        "picks one of the Pallas K4's TPU modes; the port has one K4",
    ("registration/ndt.py", "compute_derivatives", "axis_name"): _AXIS,
    ("registration/ndt.py", "ndt_align", "axis_name"): _AXIS,
    ("parallel/batch.py", "make_mesh", "axis"): _AXIS,
    ("parallel/batch.py", "sharded_odometry", "axis"): _AXIS,
    ("parallel/batch.py", "sharded_fusion", "axis"): _AXIS,
    ("parallel/batch.py", "sharded_align", "axis"): _AXIS,
    ("parallel/batch.py", "sharded_batch_fusion", "axis"): _AXIS,
    ("registration/ndt.py", "fitness_score", "chunk"):
        "bounds the TPU's [chunk, M] distance block; the port's K4 tiles "
        "the whole product itself",
    ("registration/ndt.py", "sample_display_cloud", "key"): _KEY,
    ("sim/gps.py", "simulate_constellation", "key"): _KEY,
    ("sim/sensors.py", "simulate_imu", "key"): _KEY,
    ("sim/sensors.py", "simulate_uwb_ranges", "key"): _KEY,
    ("sim/urban.py", "make_city", "rng_key"): _KEY,
    ("sim/urban.py", "receiver_clock_walk", "key"): _KEY,
    ("sim/urban.py", "simulate_urban_epochs", "key"): _KEY,
    ("sim/urban.py", "simulate_urban_pseudoranges", "key"): _KEY,
    ("registration/ndt.py", "gauss_coefficients", "dtype"):
        "the port returns d1, d2, d3 as Python floats; callers cast",
    ("estimators/preintegration.py", "synthesize_imu_gap", "dtype"):
        "the port takes the dtype of its input tensors",
}

# What the port has in place of an allowed difference.
RENAMED = {
    ("ops/ndt_pallas.py",): "ops/ndt_kernels.py",
    ("ops/nn_pallas.py",): "ops/nn_kernels.py",
    ("ops/gicp_pallas.py",): "ops/gicp_kernels.py",
    ("ops/segtree.py",): "ops/segment.py",
    **{k: "generator" for k, reason in ALLOWED.items() if reason == _KEY},
}


def _surface(path: Path, jax_side: bool):
    """Top-level bindings of a module: name -> (members or None). Members
    are a class's annotated fields or a function's parameters. On the JAX
    side only what the module defines, plus upper-case constants it
    imports from its own package; on the port side every binding."""
    out = {}

    def visit(stmts):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                out[node.name] = {
                    x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                    + [v for v in (a.vararg, a.kwarg) if v is not None]}
            elif isinstance(node, ast.ClassDef):
                out[node.name] = {
                    s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)}
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            out[n.id] = None
            elif isinstance(node, ast.ImportFrom):
                own = node.level > 0 or (node.module or "").split(".")[0] \
                    == JAX_PKG.name
                for al in node.names:
                    name = al.asname or al.name
                    if not jax_side or (own and name.isupper()):
                        out[name] = None
            elif isinstance(node, ast.Import) and not jax_side:
                for al in node.names:
                    out[(al.asname or al.name).split(".")[0]] = None
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                visit(node.body)
                visit(getattr(node, "orelse", []))

    visit(ast.parse(path.read_text()).body)
    return out


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))


def _differences(module):
    """What the JAX module has and its port counterpart lacks, as
    ALLOWED-style keys."""
    port = PORT_PKG / module
    if not port.exists():
        return [(module,)]
    want = _surface(JAX_PKG / module, jax_side=True)
    have = _surface(port, jax_side=False)
    missing = []
    for name, members in want.items():
        if name.startswith("_"):
            continue
        if name not in have:
            missing.append((module, name))
        elif members and have[name] is not None:
            missing += [(module, name, m) for m in sorted(members)
                        if not m.startswith("_") and m not in have[name]]
    return missing


def test_packages_found():
    assert len(JAX_MODULES) > 40
    assert (PORT_PKG / "registration" / "ndt.py").exists()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_names_have_counterparts(module):
    missing = [k for k in _differences(module) if k not in ALLOWED]
    assert not missing, (
        f"toyslam_tpu/{module}: public names, fields or parameters without a "
        f"counterpart in toyslam_tpu_torch/{module}: {missing}")


def test_allow_list_is_current():
    """Each allowed difference still differs, and what the port has in
    its place is there."""
    differs = {k for m in JAX_MODULES for k in _differences(m)}
    stale = sorted(k for k in ALLOWED if k not in differs)
    assert not stale, f"allow-list entries that no longer differ: {stale}"
    for key, instead in RENAMED.items():
        if len(key) == 1:
            assert (PORT_PKG / instead).exists(), (key, instead)
        else:
            module, name, _ = key
            assert instead in _surface(PORT_PKG / module, False)[name], (
                key, instead)
    assert all(isinstance(r, str) and r for r in ALLOWED.values())
