"""The check that decides ``correct``, driven on the CPU at a small size.

Each test runs a whole cell through ``run.execute`` (set-up, window,
answers, reference, limits) with the program's plain versions, skipping
only the harness's look for a card: a sound run comes out correct; the
control (the reference computed in bfloat16, put in the program's place)
and each fault of ``portbench.faults`` planted under the timed path come
out not correct.
"""

import copy

import pytest
import torch

from portbench import faults, run, spec
from portbench.loops import mapping, pairwise

MAPPING, GICP = "hdl64-mapping.replay", "ndtomp-align.gicp"
SEED = 20260917


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(name: str) -> spec.Cell:
    """The cell at a size the CPU runs in seconds: 32-ring scans of 512
    azimuths, logs of 8 scans, pairs of ~2k points."""
    c = spec.cell(name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["sensor"]["rings"], cfg["sensor"]["azimuths"] = 32, 512
    tr["traced_units"] = 2
    if name == MAPPING:
        cfg["scans_per_log"] = 8
        cfg["odometry"]["work_capacity"] = 16384
        cfg["map_capacity"] = 32768
        tr["warmup_scans"] = 1
    else:
        cfg["sensor"]["rings"], cfg["sensor"]["azimuths"] = 16, 256
        cfg["capacity"] = 4096
        tr |= {"pairs": 3, "warmup_aligns": 1, "check_aligns": 2}
        # The median gap of a sound align grows as the clouds shrink: on
        # ~2k points it reads up to 1.9e-3 m on the CPU (3.4e-3 m and more
        # with half of the correspondences left out), against at most
        # 7.1e-5 m on the cell's ~31k points, which its limit is set for.
        cfg["limits"]["align_gap_m_median"] = cfg["limits"]["align_gap_m"]
    return c._replace(config=cfg, traffic=tr)


SECONDS = {MAPPING: 6.0, GICP: 2.0}


def execute(name):
    return run.execute(small(name), SEED, SECONDS[name], False, "cpu")


@pytest.mark.parametrize("name", [MAPPING, GICP])
def test_sound_run_is_correct(name):
    out = execute(name)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("name,cls", [(MAPPING, mapping.Cell),
                                         (GICP, pairwise.Cell)])
def test_control_is_not_correct(monkeypatch, name, cls):
    own = cls.program_answers

    def control(self, records):
        return self.reference_answers(own(self, records), torch.bfloat16)

    monkeypatch.setattr(cls, "program_answers", control)
    out = execute(name)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in (MAPPING, GICP)
    for fault in faults.FAULTS[spec.cell(name).traffic["loop"]]])
def test_fault_is_caught(monkeypatch, name, fault):
    faults.plant(spec.cell(name).traffic["loop"], fault, monkeypatch.setattr)
    out = execute(name)
    assert not out["correct"], out["compared"]
