"""The LOAM cell (``hdl32-loam.drive``) on the CPU at a small size.

- A sound run through ``run.execute`` (set-up, window, answers, reference,
  limits) comes out correct; the control (the reference computed in
  bfloat16, put in the program's place) and each fault of
  ``portbench.faults_loam`` planted under the timed path come out not
  correct.
- The plain reference (``reference/loam.py``) and the program, both in
  float64 on the same scans, give the same picks and the same chain to
  1e-12 m (observed 8e-16 m over 6 scans of 512 azimuths, 2.2e-15 m over
  14 full-width scans).
- The loop, the reference, the faults and the program modules they call
  load no JAX and no JAX package, in a process of their own.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import faults_loam, run, scenes, spec
from portbench.loops import loam as loam_loop
from portbench.reference import loam as ref_loam

CELL = "hdl32-loam.drive"
SEED = 4200000017
ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small() -> spec.Cell:
    """The cell at a size the CPU runs in seconds: 32-ring scans of 256
    azimuths, logs of 6 scans."""
    c = spec.cell(CELL)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["sensor"]["azimuths"] = 256
    cfg["capacity"] = 32 * 256 + 512
    cfg["scans_per_log"] = 6
    tr["warmup_scans"] = 1
    tr["traced_units"] = 2
    return c._replace(config=cfg, traffic=tr)


def execute():
    return run.execute(small(), SEED, 4.0, False, "cpu")


def test_sound_run_is_correct():
    out = execute()
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert set(out["compared"]) == set(small().config["limits"])


def test_control_is_not_correct(monkeypatch):
    own = loam_loop.Cell.program_answers

    def control(self, records):
        return self.reference_answers(own(self, records), torch.bfloat16)

    monkeypatch.setattr(loam_loop.Cell, "program_answers", control)
    out = execute()
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("fault", faults_loam.FAULTS)
def test_fault_is_caught(monkeypatch, fault):
    faults_loam.plant(fault, monkeypatch.setattr)
    out = execute()
    assert not out["correct"], out["compared"]


def test_reference_agrees_with_the_program_in_float64():
    from toyslam_tpu_torch.core.pointcloud import PointCloud
    from toyslam_tpu_torch.pipelines import loam

    scans = 6
    log = scenes.cast_log(1, scans, 32, 512, (-30.67, 10.67), device="cpu")
    xyzi, mask = scenes.realise(log, 0.015, 0.7,
                                torch.Generator().manual_seed(3))
    cfg = loam.LoamConfig()
    s = ref_loam.Settings(**cfg._asdict())
    x64 = xyzi.double()
    state = loam.loam_init(PointCloud(x64[0], mask[0]), cfg)
    got = []
    for i in range(1, scans):
        state, out = loam.loam_step(state, PointCloud(x64[i], mask[i]), cfg)
        got.append(out)
        f = loam.organize_and_extract(PointCloud(x64[i], mask[i]), cfg)
        e, p = ref_loam.features(x64[i, :, :3], mask[i], s)
        assert torch.equal(f.edge_xyz[f.edge_mask], e)
        assert torch.equal(f.surf_xyz[f.surf_mask], p)
    _, steps, last = ref_loam.run_log(xyzi[:, :, :3], mask, s)
    assert [bool(o.is_kf) for o in got] == [o.is_kf for o in steps]
    t, r = loam_loop.pose_gaps(torch.stack([o.q for o in got]),
                               torch.stack([o.t for o in got]),
                               torch.stack([o.q for o in steps]),
                               torch.stack([o.t for o in steps]))
    assert float(t.max()) < 1e-12 and float(r.max()) < 1e-12
    m = state.maps
    for mine, theirs in ((m.edge_xyz[m.edge_mask], last.edge_map),
                         (m.surf_xyz[m.surf_mask], last.surf_map)):
        assert mine.shape == theirs.shape
        assert float((mine - theirs).abs().max()) < 1e-12


PROBE = r"""
import importlib, json, sys
before = {m.split(".")[0] for m in sys.modules}
from portbench import spec
spec.reader("gn_iterations_per_scan.loam")
for name in ("portbench.loops.loam", "portbench.reference.loam",
             "portbench.faults_loam", "toyslam_tpu_torch.pipelines.loam",
             "toyslam_tpu_torch.core.pointcloud"):
    importlib.import_module(name)
after = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(after - before)))
"""


def test_loam_modules_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    added = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in added and "toyslam_tpu_torch" in added
    assert not added & set(run.FORBIDDEN), sorted(added & set(run.FORBIDDEN))
