"""Ionosphere (Klobuchar) and troposphere delay models (port of
``toyslam_tpu/gnss/atmosphere.py``).

The reference's ``KlobucharIonoModel::computeIonoDelay``
(``gnssSpp.cpp:479-547``; also ``RangingRC.cpp:487-542``) and the
simplified 2.3/sin(el) troposphere (``gnssSpp.cpp:995``;
``RangingRC.cpp:467-486``). Elementwise over satellites and epochs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.geodesy import SPEED_OF_LIGHT


class IonoParams(NamedTuple):
    alpha: torch.Tensor  # [4]
    beta: torch.Tensor  # [4]
    valid: bool = True


def klobuchar_delay(params: IonoParams, time_sec, lat, lon, elevation,
                    azimuth):
    """Klobuchar ionospheric delay in meters (``gnssSpp.cpp:482-546``)."""
    el_sc = elevation.abs().clamp(min=0.05) / math.pi
    lat_sc = lat / math.pi
    lon_sc = lon / math.pi

    psi = 0.0137 / (el_sc + 0.11) - 0.022
    phi_i = (lat_sc + psi * torch.cos(azimuth)).clamp(-0.416, 0.416)
    lambda_i = lon_sc + psi * torch.sin(azimuth) / torch.cos(phi_i * math.pi)
    phi_m = phi_i + 0.064 * torch.cos((lambda_i - 1.617) * math.pi)

    t = torch.remainder(43200.0 * lambda_i + time_sec, 86400.0)
    t = torch.where(t < 0, t + 86400.0, t)

    f = 1.0 + 16.0 * (0.53 - el_sc) ** 3

    a0, a1, a2, a3 = params.alpha.unbind(-1)
    amp = (a0 + a1 * phi_m + a2 * phi_m**2 + a3 * phi_m**3).clamp(min=0.0)
    all_zero = (a0 == 0) & (a1 == 0) & (a2 == 0) & (a3 == 0)
    amp = torch.where(all_zero, 5.0e-9, amp)

    b0, b1, b2, b3 = params.beta.unbind(-1)
    per = (b0 + b1 * phi_m + b2 * phi_m**2 + b3 * phi_m**3).clamp(
        min=72000.0)

    x = 2.0 * math.pi * (t - 50400.0) / per
    delay = torch.where(x.abs() < 1.57,
                        f * (5.0e-9 + amp * (1.0 - x * x / 2.0 + x**4 / 24.0)),
                        f * 5.0e-9) * SPEED_OF_LIGHT
    if torch.is_tensor(params.valid):
        return torch.where(params.valid, delay, 0.0)
    return delay if params.valid else torch.zeros_like(delay)


def simple_troposphere_delay(elevation):
    """2.3 / max(sin|el|, 0.1) meters (``gnssSpp.cpp:995``)."""
    return 2.3 / torch.sin(elevation.abs()).clamp(min=0.1)
