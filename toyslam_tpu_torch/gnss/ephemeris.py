"""GPS broadcast-ephemeris satellite position, velocity and clock (port of
``toyslam_tpu/gnss/ephemeris.py``).

The reference's ``GpsEphemerisCalculator::computeSatPosVel``
(``gnssSpp.cpp:323-476``; also ``RangingRC.cpp:185-266``): Kepler
solution, second-harmonic perturbations, ECEF velocity and the clock bias
and drift with the relativistic correction. Ephemerides are structures of
arrays; everything is elementwise over any leading shape, so a whole
constellation over a whole log is one pass. Kepler's equation runs a fixed
30 fixed-point steps (the reference's cap), never an early exit. Use
float64: orbit radii are ~2.7e7 m.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.geodesy import (EARTH_ROTATION_RATE, MU_GPS,
                                            SPEED_OF_LIGHT,
                                            adjust_time_within_week)

MAX_EPH_AGE = 7200.0  # seconds (gnssSpp.cpp:40)


class GpsEphemeris(NamedTuple):
    """Broadcast ephemeris fields, each [...] (e.g. [S] satellites)."""

    sat: torch.Tensor  # PRN (int32)
    toe_sec: torch.Tensor  # time of ephemeris (s of week)
    toc_sec: torch.Tensor  # time of clock
    sqrta: torch.Tensor
    e: torch.Tensor
    m0: torch.Tensor
    delta_n: torch.Tensor
    omega: torch.Tensor  # argument of perigee
    omg: torch.Tensor  # longitude of ascending node at toe
    omg_dot: torch.Tensor
    i0: torch.Tensor
    i_dot: torch.Tensor
    cus: torch.Tensor
    cuc: torch.Tensor
    crs: torch.Tensor
    crc: torch.Tensor
    cis: torch.Tensor
    cic: torch.Tensor
    af0: torch.Tensor
    af1: torch.Tensor
    af2: torch.Tensor
    tgd: torch.Tensor
    valid: torch.Tensor  # bool


def solve_kepler(M, e, iterations: int = 30):
    """Fixed-point E = M + e sin(E) (``gnssSpp.cpp:306-322``)."""
    E = M
    for _ in range(iterations):
        E = M + e * torch.sin(E)
    return E


def sat_pos_vel_clock(eph: GpsEphemeris, transmit_time,
                      force_use_ephemeris: bool = False):
    """Satellite ECEF position, velocity, clock bias and drift at
    ``transmit_time`` (broadcast against the ephemeris' leaves).

    Returns dict(pos [..., 3], vel [..., 3], clock_bias [...], clock_drift
    [...], valid [...]), with the reference's ephemeris-age gate.
    """
    tk = adjust_time_within_week(transmit_time, eph.toe_sec)
    valid = eph.valid & (eph.sqrta > 0)
    if not force_use_ephemeris:
        valid = valid & (tk.abs() <= MAX_EPH_AGE)

    a = eph.sqrta * eph.sqrta
    n = torch.sqrt(MU_GPS / (a * a * a)) + eph.delta_n
    M = eph.m0 + n * tk
    E = solve_kepler(M, eph.e)
    sin_E, cos_E = torch.sin(E), torch.cos(E)

    dt = adjust_time_within_week(transmit_time, eph.toc_sec)
    clock_bias = eph.af0 + eph.af1 * dt + eph.af2 * dt * dt
    clock_drift = eph.af1 + 2.0 * eph.af2 * dt
    # Relativistic corrections (``gnssSpp.cpp:383-390``)
    sqrt_mu = math.sqrt(MU_GPS)
    clock_bias = (clock_bias - 2.0 * sqrt_mu * eph.e * eph.sqrta * sin_E
                  / SPEED_OF_LIGHT**2)
    clock_drift = (clock_drift - 2.0 * sqrt_mu * eph.e * eph.sqrta * cos_E
                   * (n / (1.0 - eph.e * cos_E)) / SPEED_OF_LIGHT**2)

    f_E = torch.sqrt(1.0 - eph.e * eph.e)
    nu = torch.atan2(f_E * sin_E, cos_E - eph.e)
    E_dot = n / (1.0 - eph.e * cos_E)
    nu_dot = E_dot * f_E / (1.0 - eph.e * cos_E)

    phi = nu + eph.omega
    phi_dot = nu_dot
    s2p, c2p = torch.sin(2 * phi), torch.cos(2 * phi)
    du = eph.cus * s2p + eph.cuc * c2p
    dr = eph.crs * s2p + eph.crc * c2p
    di = eph.cis * s2p + eph.cic * c2p
    du_dot = 2.0 * phi_dot * (eph.cus * c2p - eph.cuc * s2p)
    dr_dot = 2.0 * phi_dot * (eph.crs * c2p - eph.crc * s2p)
    di_dot = 2.0 * phi_dot * (eph.cis * c2p - eph.cic * s2p)

    u = phi + du
    r = a * (1.0 - eph.e * cos_E) + dr
    inc = eph.i0 + di + eph.i_dot * tk
    u_dot = phi_dot + du_dot
    r_dot = a * eph.e * sin_E * E_dot + dr_dot
    inc_dot = eph.i_dot + di_dot

    x_op, y_op = r * torch.cos(u), r * torch.sin(u)
    x_op_dot = r_dot * torch.cos(u) - r * torch.sin(u) * u_dot
    y_op_dot = r_dot * torch.sin(u) + r * torch.cos(u) * u_dot

    Omega = (eph.omg + (eph.omg_dot - EARTH_ROTATION_RATE) * tk
             - EARTH_ROTATION_RATE * eph.toe_sec)
    Omega_dot = eph.omg_dot - EARTH_ROTATION_RATE
    si, ci = torch.sin(inc), torch.cos(inc)
    sO, cO = torch.sin(Omega), torch.cos(Omega)

    x = x_op * cO - y_op * ci * sO
    y = x_op * sO + y_op * ci * cO
    z = y_op * si

    # The full ECEF time derivative (Omega_dot holds the -earth_rate term).
    # The reference applies -omega_e x r on top (``gnssSpp.cpp:461-466``),
    # counting Earth's rotation twice (~1.9 km/s); the JAX package's
    # finite-difference test pins the derivative, and the port's tests
    # hold the port to the same physics.
    vx = (x_op_dot * cO - y_op_dot * ci * sO + y_op * si * sO * inc_dot
          - (x_op * sO + y_op * ci * cO) * Omega_dot)
    vy = (x_op_dot * sO + y_op_dot * ci * cO - y_op * si * cO * inc_dot
          + (x_op * cO - y_op * ci * sO) * Omega_dot)
    vz = y_op_dot * si + y_op * ci * inc_dot

    return {
        "pos": torch.stack([x, y, z], -1),
        "vel": torch.stack([vx, vy, vz], -1),
        "clock_bias": clock_bias,
        "clock_drift": clock_drift,
        "valid": valid,
    }
