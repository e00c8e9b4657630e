"""The benchmark's ray caster against the system's numpy one
(``toyslam_tpu_torch/sim/urban_scans``): the same streets and poses from a
scene seed, and, without noise, the same scans but for rays that graze a
box's edge."""

import numpy as np
import pytest
import torch

from portbench import scenes
from toyslam_tpu_torch.sim import urban_scans

SIZES = [(3, 2, 8, 256, (-24.8, 2.0)), (1, 3, 16, 128, (-30.67, 10.67))]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_street_and_trajectory_are_the_numpy_ones(seed):
    a = np.random.default_rng(seed)
    b = np.random.default_rng(seed)
    boxes, kinds = scenes.street_scene(a)
    boxes_np, kinds_np = urban_scans.street_scene(b)
    assert np.array_equal(boxes, boxes_np) and np.array_equal(kinds,
                                                              kinds_np)
    assert np.array_equal(scenes.trajectory(a, 5),
                          urban_scans.trajectory(b, 5))


def _agree(seed, scans, rings, azimuths, fov, device):
    xyzi, mask, poses = urban_scans.spinning_lidar_scans(
        seed, scans, rings, azimuths, fov_deg=fov, noise=0.0)
    log = scenes.cast_log(seed, scans, rings, azimuths, fov, device=device)
    got, got_mask = scenes.realise(
        log, 0.0, 0.0, torch.Generator(device=device).manual_seed(0))
    got, got_mask = got.cpu().numpy(), got_mask.cpu().numpy()
    assert np.array_equal(log["poses"], poses)
    both = mask & got_mask
    # A ray that grazes a box edge may hit in one cast and miss in the
    # other; every other ray agrees to f32 rounding.
    assert (mask == got_mask).mean() > 0.999
    close = np.abs(got - xyzi).max(-1) <= 1e-5 * (1 + np.abs(xyzi).max(-1))
    assert close[both].mean() > 0.999
    assert both.sum() > 0.5 * mask.size


@pytest.mark.parametrize("seed,scans,rings,azimuths,fov", SIZES)
def test_cast_matches_numpy_on_cpu(seed, scans, rings, azimuths, fov):
    _agree(seed, scans, rings, azimuths, fov, "cpu")


@pytest.mark.portbench_card
@pytest.mark.parametrize("seed,scans,rings,azimuths,fov", SIZES)
def test_cast_matches_numpy_on_card(card, seed, scans, rings, azimuths,
                                    fov):
    _agree(seed, scans, rings, azimuths, fov, card)


def test_realise_draws_from_the_generator_and_turns_the_sensor():
    log = scenes.cast_log(2, 2, 8, 128, (-24.8, 2.0), device="cpu")
    a, m = scenes.realise(log, 0.015, 0.5,
                          torch.Generator().manual_seed(5))
    b, _ = scenes.realise(log, 0.015, 0.5,
                          torch.Generator().manual_seed(5))
    c, _ = scenes.realise(log, 0.015, 0.5,
                          torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    flat, _ = scenes.realise(log, 0.015, 0.0,
                             torch.Generator().manual_seed(5))
    # The yaw turns every point about z and keeps its range.
    r0 = torch.linalg.vector_norm(flat[m][:, :3], dim=1)
    r1 = torch.linalg.vector_norm(a[m][:, :3], dim=1)
    assert torch.allclose(r0, r1, rtol=1e-6)
    az = torch.atan2(a[m][:, 1], a[m][:, 0]) - torch.atan2(flat[m][:, 1],
                                                          flat[m][:, 0])
    az = torch.remainder(az + torch.pi, 2 * torch.pi) - torch.pi
    assert torch.allclose(az, torch.full_like(az, 0.5), atol=1e-4)
