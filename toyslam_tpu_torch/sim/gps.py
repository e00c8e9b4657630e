"""GPS constellation simulator with fault injection (port of
``toyslam_tpu/sim/gps.py``).

The reference's ``generateSatelliteConstellation`` (``GPSRAIM.cpp:
251-303``): satellites placed by azimuth and elevation on a 20200 km
altitude shell around the true receiver, pseudoranges with Gaussian noise,
and an injected fault on a given or random satellite. The closed-loop
backend of the RAIM tests and app.

Draws come from an explicit ``torch.Generator``, in a fixed order
(azimuths, elevations, noise, then the fault's index), made on the
generator's device and moved to the receiver's: a seeded CPU generator
gives the same draws to a run on the host and on the card. They are not
the JAX package's numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.geodesy import ecef_to_enu_rotation, ecef_to_lla

GPS_ORBIT_RADIUS = 26560e3  # ~20200 km altitude shell


class GpsSimConfig(NamedTuple):
    n_sats: int = 8
    noise_std: float = 2.0  # pseudorange noise (m)
    clock_bias: float = 0.0  # receiver clock bias (m)
    fault_magnitude: float = 50.0  # injected bias (m)
    min_elevation_deg: float = 15.0
    max_elevation_deg: float = 80.0


def place_satellites(receiver_ecef, az, el):
    """Satellites [..., 3] on the orbit shell, seen from ``receiver_ecef``
    [3] at azimuths and elevations [...] (radians)."""
    lla = ecef_to_lla(receiver_ecef)
    R = ecef_to_enu_rotation(lla[0], lla[1])  # rows = ENU axes in ECEF
    los_enu = torch.stack([torch.cos(el) * torch.sin(az),
                           torch.cos(el) * torch.cos(az), torch.sin(el)], -1)
    return receiver_ecef + (los_enu @ R) * (
        GPS_ORBIT_RADIUS - torch.linalg.norm(receiver_ecef))


def simulate_constellation(generator: torch.Generator, receiver_ecef,
                           config: GpsSimConfig = GpsSimConfig(),
                           fault_index: int | None = None, batch=()):
    """Satellite positions and pseudoranges around ``receiver_ecef`` [3],
    optionally faulted, for each of ``batch`` (a shape) independent draws.

    fault_index: None = no fault; -1 = a random satellite; >= 0 = that one.
    Returns dict(sat_pos [*batch, S, 3], pseudoranges [*batch, S],
    fault_idx [*batch], elevations, azimuths [*batch, S]).
    """
    S = config.n_sats
    dtype, device = receiver_ecef.dtype, receiver_ecef.device
    shape = tuple(batch) + (S,)

    def draw(fn):
        return fn(shape, generator=generator, dtype=dtype,
                  device=generator.device).to(device)

    def uniform(lo, hi):
        return lo + (hi - lo) * draw(torch.rand)

    az = uniform(0.0, 2.0 * math.pi)
    el = uniform(math.radians(config.min_elevation_deg),
                 math.radians(config.max_elevation_deg))
    noise = draw(torch.randn)

    sat_pos = place_satellites(receiver_ecef, az, el)
    true_range = torch.linalg.norm(sat_pos - receiver_ecef, dim=-1)
    pr = true_range + config.clock_bias + config.noise_std * noise

    if fault_index is None:
        fault_idx = torch.full(tuple(batch), -1, dtype=torch.int64,
                               device=device)
    elif fault_index == -1:
        fault_idx = torch.randint(0, S, tuple(batch), generator=generator,
                                  device=generator.device).to(device)
    else:
        fault_idx = torch.full(tuple(batch), fault_index, dtype=torch.int64,
                               device=device)
    ids = torch.arange(S, device=device)
    pr = torch.where(ids == fault_idx[..., None], pr + config.fault_magnitude,
                     pr)
    return {"sat_pos": sat_pos, "pseudoranges": pr, "fault_idx": fault_idx,
            "elevations": el, "azimuths": az}
