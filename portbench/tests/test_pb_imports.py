"""Nothing of the benchmark loads JAX, the JAX package (``toyslam_tpu``)
or the JAX package's ``bench.py``. Names are compared whole, by their
first dotted part: the port, ``toyslam_tpu_torch``, begins with the JAX
package's name and is allowed."""

import json
import subprocess
import sys
from pathlib import Path

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "toyslam_tpu", "bench"}
HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

# Imports every module of portbench/ (the metric readers by their files,
# as the harness does) and the program modules its loops call, and
# prints the top-level names this added to sys.modules.
PROBE = r"""
import importlib, json, sys
from pathlib import Path
before = {m.split(".")[0] for m in sys.modules}
from portbench import spec
root = Path(spec.HERE)
for path in sorted(root.rglob("*.py")):
    rel = path.relative_to(root.parent).with_suffix("")
    if path.parent.name == "metrics" and not path.stem.startswith("_"):
        spec.reader(path.stem)
    else:
        importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))
for name in ("toyslam_tpu_torch.pipelines.odometry",
             "toyslam_tpu_torch.registration.gicp",
             "toyslam_tpu_torch.core.pointcloud",
             "toyslam_tpu_torch.ops.launches"):
    importlib.import_module(name)
after = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(after - before)))
"""


def test_no_module_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    added = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in added and "toyslam_tpu_torch" in added
    assert not added & FORBIDDEN, sorted(added & FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"toyslam_tpu_torch": None,
                                         "toyslam_tpu_torch.ops": None,
                                         "benchmarks": None,
                                         "jaxtyping": None})
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "toyslam_tpu.core", None)
    monkeypatch.setitem(sys.modules, "jax", None)
    assert run.loaded_forbidden() == ["jax", "toyslam_tpu"]
