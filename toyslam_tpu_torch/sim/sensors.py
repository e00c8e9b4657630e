"""IMU and UWB sensor simulators with bias and noise (port of
``toyslam_tpu/sim/sensors.py``).

After ``uwb_imu_sim_node.cpp``: IMU samples from the exact specific force
of a trajectory in the body frame plus bias and Gaussian noise
(``:107-199``), and noisy ranges to beacons (``:239-259``,
``uwb_node.cpp:158-200``). The noise comes from an explicit
``torch.Generator`` on the trajectory's device, in place of JAX's key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3

GRAVITY = 9.81

# Default beacons (uwb_imu_sim_node.cpp:33-41)
DEFAULT_BEACONS = ((-5.0, -5.0, 2.0), (5.0, -5.0, 2.0), (5.0, 5.0, 2.0),
                   (-5.0, 5.0, 2.0), (0.0, 0.0, 3.0))


class ImuSimParams(NamedTuple):
    """Defaults from ``uwb_imu_sim_node.cpp:44-60``."""

    accel_noise_std: float = 0.03
    gyro_noise_std: float = 0.002
    accel_bias: tuple = (0.05, -0.07, 0.1)
    gyro_bias: tuple = (0.002, -0.003, 0.001)


def imu_from_noise(traj, acc_noise, gyro_noise,
                   params: ImuSimParams = ImuSimParams()):
    """Body-frame IMU samples of a trajectory dict ('acc' world linear
    acceleration, 'quat' world <- body, 'gyro' body rates, each [T, ...])
    given standard normals ``acc_noise``/``gyro_noise [T, 3]``: specific
    force ``R^T (a_world + g) + bias + noise``, rates ``gyro + bias +
    noise``."""
    acc_w = traj["acc"].clone()
    acc_w[:, 2] += GRAVITY
    R = se3.quat_to_rot(traj["quat"])  # [T, 3, 3] world <- body
    acc_body = (R * acc_w[:, :, None]).sum(1)  # R^T a
    bias_a = torch.tensor(params.accel_bias, dtype=acc_w.dtype,
                          device=acc_w.device)
    bias_g = torch.tensor(params.gyro_bias, dtype=acc_w.dtype,
                          device=acc_w.device)
    acc = acc_body + bias_a + params.accel_noise_std * acc_noise
    gyro = traj["gyro"] + bias_g + params.gyro_noise_std * gyro_noise
    return acc, gyro


def simulate_imu(generator: torch.Generator, traj,
                 params: ImuSimParams = ImuSimParams()):
    """-> (acc [T, 3], gyro [T, 3]); see :func:`imu_from_noise`."""
    like = traj["acc"]

    def normal():
        return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                           device=like.device)

    acc_noise = normal()
    return imu_from_noise(traj, acc_noise, normal(), params)


def ranges_from_noise(positions, beacons, noise):
    """Ranges ``[T, B]`` from ``positions [T, 3]`` to ``beacons [B, 3]`` plus
    ``noise [T, B]`` (already scaled)."""
    beacons = torch.as_tensor(beacons, dtype=positions.dtype).to(
        positions.device)
    d = torch.linalg.norm(positions[:, None, :] - beacons[None], dim=-1)
    return d + noise


def simulate_uwb_ranges(generator: torch.Generator, positions,
                        beacons=DEFAULT_BEACONS, noise_std: float = 0.05):
    """Noisy ranges ``[T, B]`` to each beacon
    (``uwb_imu_sim_node.cpp:239-259``)."""
    shape = (positions.shape[0], len(beacons))
    noise = noise_std * torch.randn(shape, generator=generator,
                                    dtype=positions.dtype,
                                    device=positions.device)
    return ranges_from_noise(positions, beacons, noise)
