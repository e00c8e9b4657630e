"""GNSS single point positioning (pseudorange WLS) and Doppler velocity
(port of ``toyslam_tpu/gnss/spp.py``).

The ``gnssSpp.cpp`` solver: elevation-weighted pseudorange WLS over the
receiver's [x, y, z, clock bias] with the Sagnac, satellite clock, TGD and
iono/tropo terms (``GpsPseudorangeResidual``, ``:550-597``;
``solveGpsOnlyWLS``, ``:1335-1428``), elevation x CN0 weights
(``:1481-1509``), DOPs (``:1510-1577``), the closed-form Doppler velocity
WLS with the Sagnac rate (``:1622-1708``) and the velocity checks
(``:44-46, 1711+``).

Satellites are padded [..., S] tensors with a validity mask, applied by
selection (``torch.where``), never by a product with 0, so a masked
channel's NaN stays out of the solve (XLA compiles JAX's products with
the converted mask to the same selects); every function takes leading
batch dimensions. The WLS is a fixed number of
Gauss-Newton steps (the residual is nearly linear in the state, as Ceres'
DENSE_QR sees it). The 4x4 systems are solved with ``solve_ex`` and
``inv_ex`` (no error check: the checking versions read ``info`` back to
the host on the card), and the normal matrices are sums of elementwise
products, so nothing here goes through a reduced-precision product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.geodesy import (EARTH_ROTATION_RATE,
                                            SPEED_OF_LIGHT,
                                            ecef_to_enu_rotation, ecef_to_lla)

DEFAULT_PSEUDORANGE_NOISE = 5.0  # m (gnssSpp.cpp:33)
MAX_VELOCITY = 200.0  # m/s (:44)
MAX_VEL_CHANGE = 20.0  # m/s (:45)


class SatelliteObs(NamedTuple):
    """One epoch's satellites, padded [..., S] with a ``valid`` mask."""

    pos: torch.Tensor  # [..., S, 3] ECEF at transmit time
    pseudorange: torch.Tensor  # [..., S] raw
    clock_bias: torch.Tensor  # [..., S] satellite clock (s)
    iono_delay: torch.Tensor  # [..., S] m
    trop_delay: torch.Tensor  # [..., S] m
    tgd: torch.Tensor  # [..., S] s
    weight: torch.Tensor  # [..., S] measurement weight
    valid: torch.Tensor  # [..., S] bool


def gram(A, B):
    """A^T B over the satellite axis: A [..., S, i], B [..., S, j] ->
    [..., i, j], as f32 or f64 products summed in that dtype."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(-3)


def mat_vec(M, v):
    """M [..., i, j] @ v [..., j], as products summed in their dtype."""
    return (M * v[..., None, :]).sum(-1)


def solve4(A, b):
    """A [..., n, n] x = b [..., n] without a host sync."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def inv4(A):
    """A^-1 without a host sync."""
    return torch.linalg.inv_ex(A)[0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def elevation_azimuth(sat_pos, receiver_ecef):
    """Elevation and azimuth [..., S] of satellites [..., S, 3] seen from
    the receiver [..., 3] (``:1431-1480``)."""
    lla = ecef_to_lla(receiver_ecef)
    R = ecef_to_enu_rotation(lla[..., 0], lla[..., 1])
    los = sat_pos - receiver_ecef[..., None, :]
    enu = mat_vec(R[..., None, :, :], los)
    rng = torch.linalg.norm(enu, dim=-1)
    elevation = torch.asin((enu[..., 2] / rng.clamp(min=1e-9)).clamp(-1, 1))
    azimuth = torch.atan2(enu[..., 0], enu[..., 1])
    return elevation, azimuth


def elevation_weight(elevation, cn0=None, min_cn0: float = 20.0, ura=None):
    """sin^2(el) x CN0 x URA weights (``calculateMeasurementWeight``,
    ``:1481-1509``)."""
    sin_el = torch.sin(elevation.abs())
    w = (sin_el * sin_el).clamp(min=0.1)
    if cn0 is not None:
        w = w * torch.where(cn0 > 0, ((cn0 - min_cn0) / 30.0).clamp(0.2, 1.0),
                            1.0)
    if ura is not None:
        w = w * torch.where(ura > 0, 1.0 / ura, 1.0)
    return w


def predicted_pseudorange(state, obs: SatelliteObs):
    """Expected pseudorange [..., S] at ``state`` [..., 4] per
    ``GpsPseudorangeResidual`` (``:559-585``)."""
    rx, ry, cb = state[..., 0:1], state[..., 1:2], state[..., 3:4]
    geo = torch.linalg.norm(obs.pos - state[..., None, :3], dim=-1)
    sagnac = (-EARTH_ROTATION_RATE
              * (rx * obs.pos[..., 1] - ry * obs.pos[..., 0])
              / SPEED_OF_LIGHT)
    return (geo + cb + sagnac + obs.iono_delay + obs.trop_delay
            - obs.tgd * SPEED_OF_LIGHT - obs.clock_bias * SPEED_OF_LIGHT)


class SppSolution(NamedTuple):
    state: torch.Tensor  # [..., 4] x, y, z, clock_bias
    covariance: torch.Tensor  # [..., 4, 4]
    gdop: torch.Tensor
    pdop: torch.Tensor
    hdop: torch.Tensor
    vdop: torch.Tensor
    tdop: torch.Tensor
    num_sats: torch.Tensor
    valid: torch.Tensor


def _geometry(sat_pos, position):
    """(d = sat - position [..., S, 3], range [..., S] clamped at 1e-9)."""
    d = sat_pos - position[..., None, :]
    return d, torch.linalg.norm(d, dim=-1).clamp(min=1e-9)


def solve_spp(obs: SatelliteObs, initial_state=None, iterations: int = 15):
    """Iterated WLS position solve (Ceres DENSE_QR, <= 15 iterations,
    ``:1398``) from ``initial_state`` [..., 4] (default zeros)."""
    valid = obs.valid
    if initial_state is None:
        initial_state = obs.pos.new_zeros(obs.pos.shape[:-2] + (4,))
    w = torch.where(valid, obs.weight, 0.0)
    psr_std = DEFAULT_PSEUDORANGE_NOISE / torch.sqrt(w.clamp(min=1e-6))
    eye = _eye(4, obs.pos)

    state = initial_state.to(obs.pos.dtype)
    for _ in range(iterations):
        r = (obs.pseudorange - predicted_pseudorange(state, obs)) / psr_std
        d, rng = _geometry(obs.pos, state[..., :3])
        # d(pred)/d(receiver xyz) = -los (the Sagnac terms, ~1e-9, left
        # out as in JAX); residual = (meas - pred) / std
        J = torch.cat([d / rng[..., None], -torch.ones_like(rng)[..., None]],
                      -1)
        Jw = torch.where(valid[..., None], J / psr_std[..., None], 0.0)
        H = gram(Jw, Jw) + 1e-9 * eye
        g = mat_vec(Jw.transpose(-1, -2), torch.where(valid, r, 0.0))
        state = state - solve4(H, g)

    # DOP and covariance at the solution (``calculateGpsDOP``, ``:1510-1577``)
    d, rng = _geometry(obs.pos, state[..., :3])
    G = torch.cat([-d / rng[..., None], torch.ones_like(rng)[..., None]], -1)
    cov = inv4(gram(G, G * w[..., None]) + 1e-12 * eye)
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)
    n_sats = obs.valid.sum(-1, dtype=torch.int32)
    return SppSolution(
        state=state, covariance=cov,
        gdop=torch.sqrt(diag.sum(-1)),
        pdop=torch.sqrt(diag[..., 0] + diag[..., 1] + diag[..., 2]),
        hdop=torch.sqrt(diag[..., 0] + diag[..., 1]),
        vdop=torch.sqrt(diag[..., 2]),
        tdop=torch.sqrt(diag[..., 3]),
        num_sats=n_sats, valid=n_sats >= 4)


class DopplerObs(NamedTuple):
    """One epoch's Doppler data, padded [..., S]."""

    sat_pos: torch.Tensor  # [..., S, 3]
    sat_vel: torch.Tensor  # [..., S, 3]
    sat_clock_drift: torch.Tensor  # [..., S] (s/s)
    range_rate: torch.Tensor  # [..., S] doppler * wavelength (m/s)
    weight: torch.Tensor  # [..., S]
    valid: torch.Tensor  # [..., S] bool


class VelocitySolution(NamedTuple):
    vel_ecef: torch.Tensor  # [..., 3]
    clock_drift: torch.Tensor  # [...] (m/s)
    covariance: torch.Tensor  # [..., 4, 4]
    vel_enu: torch.Tensor  # [..., 3]
    speed: torch.Tensor  # horizontal speed
    valid: torch.Tensor


def solve_velocity(dop: DopplerObs, receiver_ecef) -> VelocitySolution:
    """Closed-form Doppler velocity WLS (``computeVelocitySolution``,
    ``:1622-1708``): G = [los, 1], Z = sat_vel.los + Sagnac rate
    - sat_clock_drift c + range_rate, x = (G^T W G)^-1 G^T W Z."""
    d, rng = _geometry(dop.sat_pos, receiver_ecef)
    los = d / rng[..., None]  # receiver -> satellite unit
    sagnac = (EARTH_ROTATION_RATE / SPEED_OF_LIGHT
              * (dop.sat_vel[..., 0] * receiver_ecef[..., 1:2]
                 - dop.sat_vel[..., 1] * receiver_ecef[..., 0:1]))
    Z = ((los * dop.sat_vel).sum(-1) + sagnac
         - dop.sat_clock_drift * SPEED_OF_LIGHT + dop.range_rate)

    G = torch.cat([los, torch.ones_like(rng)[..., None]], -1)
    Gw = G * torch.where(dop.valid, dop.weight, 0.0)[..., None]
    cov = inv4(gram(G, Gw) + 1e-9 * _eye(4, G))
    x = mat_vec(cov, mat_vec(Gw.transpose(-1, -2),
                             torch.where(dop.valid, Z, 0.0)))

    lla = ecef_to_lla(receiver_ecef)
    R = ecef_to_enu_rotation(lla[..., 0], lla[..., 1])
    vel_enu = mat_vec(R, x[..., :3])
    speed = torch.sqrt(vel_enu[..., 0] ** 2 + vel_enu[..., 1] ** 2)
    n = dop.valid.sum(-1)
    ok = (n >= 4) & (torch.linalg.norm(x[..., :3], dim=-1) <= MAX_VELOCITY)
    return VelocitySolution(vel_ecef=x[..., :3], clock_drift=x[..., 3],
                            covariance=cov, vel_enu=vel_enu, speed=speed,
                            valid=ok)


def validate_velocity(new_vel: VelocitySolution, prev_vel_ecef=None):
    """The reference's gates (``:1711+``): |v| <= 200 m/s, |dv| <= 20 m/s."""
    ok = torch.linalg.norm(new_vel.vel_ecef, dim=-1) <= MAX_VELOCITY
    if prev_vel_ecef is not None:
        ok = ok & (torch.linalg.norm(new_vel.vel_ecef - prev_vel_ecef, dim=-1)
                   <= MAX_VEL_CHANGE)
    return ok
