"""Float32 GNSS SPP and Doppler velocity in a local frame (port of
``toyslam_tpu/gnss/local.py``).

The reference solves on float64 ECEF states (``gnssSpp.cpp:1335-1428``
position WLS, ``:1622-1708`` Doppler velocity), whose 2.6e7 m magnitudes
round at ~2 m in float32. The solve is split in two:

- ``prep_epochs`` (float64, once a log, where its inputs lie): the
  ephemeris at transmit time, the elevation and CN0 masks, the Klobuchar
  and troposphere corrections, and each satellite's linearisation about a
  fixed ECEF anchor A: unit line of sight, the anchored residual
  ``y = PR - rho0 - corrections`` (O(1e2) m, sub-mm in float32), the
  curvature ``1/rho0`` and the Sagnac coefficients. It emits float32.
- ``solve_epochs_local`` (float32): Gauss-Newton over ``x = [delta, cb]``
  (the receiver relative to the anchor, and the clock bias) with the
  second-order range

      rho(delta) - rho0 = -los.delta + (|delta|^2 - (los.delta)^2)/(2 rho0)

  whose truncation error is ``rho0 (|delta|/rho0)^3`` (< 2 mm at 10 km),
  plus the delta part of the Sagnac term. The velocity reuses the
  anchored right-hand side with the first-order line-of-sight change
  ``dlos = -(delta - los (los.delta)) / rho0``.

Every float32 quantity is O(1e3) or smaller, so the solve stays within
0.1 m of the float64 ECEF pipeline. The epochs are a Python loop of device
operations, as JAX's ``lax.scan``: each starts from the previous accepted
solution (``torch.where``, no host read), runs a fixed ``pos_iterations``
Gauss-Newton steps solved by a 4x4 Cholesky (``cholesky_ex``, no error
check, so no host sync), and nothing else. What needs no carried state,
the DOPs, covariances and velocities, runs over all epochs at once after
the loop; only the velocity checks' chain (each against the last accepted
velocity) runs in order. The normal matrices are sums of elementwise
float32 products, never a TF32 product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.geodesy import (EARTH_ROTATION_RATE,
                                            SPEED_OF_LIGHT,
                                            ecef_to_enu_rotation, ecef_to_lla)
from toyslam_tpu_torch.gnss import atmosphere, spp
from toyslam_tpu_torch.gnss.ephemeris import sat_pos_vel_clock
from toyslam_tpu_torch.gnss.pipeline import (EphemerisStore, EpochConfig,
                                             masks_and_corrections)

W_C = EARTH_ROTATION_RATE / SPEED_OF_LIGHT


class LocalEpochs(NamedTuple):
    """Anchored, float32-safe epoch observations ([E, S] leaves)."""

    los: torch.Tensor  # [E, S, 3] unit anchor->satellite LOS
    y: torch.Tensor  # [E, S] PR - rho0 - corrections(anchor), m
    inv_rho0: torch.Tensor  # [E, S] 1 / anchor range
    sag_coef: torch.Tensor  # [E, S, 2] d(sagnac)/d(delta_xy)
    sat_vel: torch.Tensor  # [E, S, 3] ECEF satellite velocity
    z0: torch.Tensor  # [E, S] Doppler RHS at the anchor, m/s
    weight: torch.Tensor  # [E, S]
    valid: torch.Tensor  # [E, S] bool (every mask applied)
    dop_valid: torch.Tensor  # [E, S] bool (velocity channels)
    # Diagnostics for the skyplot/DOP stream
    elevation: torch.Tensor  # [E, S] rad (at the anchor)
    azimuth: torch.Tensor  # [E, S] rad
    cn0: torch.Tensor  # [E, S]
    prn: torch.Tensor  # [E, S] int32
    iono_delay: torch.Tensor  # [E, S] m
    trop_delay: torch.Tensor  # [E, S] m
    # The ENU rotation at the anchor, for the outputs
    R_enu: torch.Tensor  # [3, 3]


def prep_epochs(store: EphemerisStore, iono: atmosphere.IonoParams,
                gps_tow, prn, pseudorange, doppler_ms, cn0, meas_valid,
                anchor_ecef, config: EpochConfig = EpochConfig(),
                out_dtype=torch.float32) -> LocalEpochs:
    """Linearise a whole log about ``anchor_ecef`` [3].

    The input contract of ``pipeline.run_epochs`` ([E, S] channels,
    ``gps_tow`` [E]); runs where the inputs lie and in their dtype (float64:
    ECEF orbits need it) and emits ``out_dtype`` leaves for
    ``solve_epochs_local``.
    """
    anchor = anchor_ecef.to(pseudorange.dtype)
    eph = store.lookup(prn)
    sat = sat_pos_vel_clock(eph, gps_tow[:, None] - pseudorange
                            / SPEED_OF_LIGHT)
    pos, vel = sat["pos"], sat["vel"]
    elevation, azimuth = spp.elevation_azimuth(pos, anchor)
    lla0 = ecef_to_lla(anchor)
    used, iono_delay, trop_delay, weight = masks_and_corrections(
        sat, gps_tow[:, None], cn0, meas_valid, elevation, azimuth, lla0,
        iono, config)

    d = pos - anchor
    rho0 = torch.linalg.norm(d, dim=-1)
    rho0_safe = rho0.clamp(min=1.0)
    los = d / rho0_safe[..., None]

    # Anchored residual: PR - predicted(anchor, cb=0)
    # (``GpsPseudorangeResidual``, ``gnssSpp.cpp:559-585``)
    sagnac0 = (-EARTH_ROTATION_RATE
               * (anchor[0] * pos[..., 1] - anchor[1] * pos[..., 0])
               / SPEED_OF_LIGHT)
    pred0 = (rho0 + sagnac0 + iono_delay + trop_delay
             - eph.tgd * SPEED_OF_LIGHT - sat["clock_bias"] * SPEED_OF_LIGHT)
    y = pseudorange - pred0

    # d(sagnac)/d(delta): -w/c * (dx * s_y - dy * s_x)
    sag_coef = torch.stack([-W_C * pos[..., 1], W_C * pos[..., 0]], -1)

    # Doppler RHS at the anchor (``computeVelocitySolution``, ``:1622-1708``)
    z0 = ((los * vel).sum(-1)
          + W_C * (vel[..., 0] * anchor[1] - vel[..., 1] * anchor[0])
          - sat["clock_drift"] * SPEED_OF_LIGHT + doppler_ms)

    # A NaN channel on a masked satellite (a PRN absent from an epoch, the
    # simulators' convention) must not poison the epoch: NaN * 0 is NaN, so
    # one non-finite row would spread through H = Jw^T Jw and freeze the
    # epoch at the anchor while it still reads valid. Finiteness joins the
    # masks and every masked solver channel is zeroed; a NaN Doppler drops
    # its satellite from the velocity alone, as in ``pipeline.run_epochs``.
    pos_finite = (torch.isfinite(y) & torch.isfinite(rho0)
                  & torch.isfinite(los).all(-1) & torch.isfinite(weight))
    vel_finite = torch.isfinite(vel).all(-1) & torch.isfinite(z0)
    used = used & pos_finite
    dop_used = used & vel_finite & config.use_doppler

    def rows(a, m):
        return torch.where(m[..., None], a, 0.0)

    def f(a):
        return a.to(out_dtype)

    return LocalEpochs(
        los=f(rows(los, used)), y=f(torch.where(used, y, 0.0)),
        inv_rho0=f(torch.where(used, 1.0 / rho0_safe, 0.0)),
        sag_coef=f(rows(sag_coef, used)), sat_vel=f(rows(vel, dop_used)),
        z0=f(torch.where(dop_used, z0, 0.0)),
        weight=f(torch.where(used, weight, 0.0)), valid=used,
        dop_valid=dop_used, elevation=f(elevation), azimuth=f(azimuth),
        cn0=f(cn0), prn=prn.to(torch.int32), iono_delay=f(iono_delay),
        trop_delay=f(trop_delay),
        R_enu=f(ecef_to_enu_rotation(lla0[0], lla0[1])))


class LocalSolution(NamedTuple):
    """Per-epoch ([E]-stacked) solution, relative to the anchor."""

    delta: torch.Tensor  # [E, 3] receiver ECEF position - anchor
    clock_bias: torch.Tensor  # [E] m
    enu: torch.Tensor  # [E, 3] (R_enu @ delta)
    covariance: torch.Tensor  # [E, 4, 4]
    gdop: torch.Tensor
    pdop: torch.Tensor
    hdop: torch.Tensor
    vdop: torch.Tensor
    tdop: torch.Tensor
    num_sats: torch.Tensor  # [E]
    valid: torch.Tensor  # [E]
    vel_ecef: torch.Tensor  # [E, 3]
    clock_drift: torch.Tensor  # [E] m/s
    vel_enu: torch.Tensor  # [E, 3]
    vel_valid: torch.Tensor  # [E]


def _ones_col(a):
    return torch.ones_like(a[..., :1])


def solve_epochs_local(epochs: LocalEpochs,
                       config: EpochConfig = EpochConfig(),
                       iterations: int | None = None) -> LocalSolution:
    """The epochs in order, each from the previous accepted solution, with
    the velocity checks chained, as ``pipeline.run_epochs`` on the anchored
    formulation. Makes no host synchronisation."""
    ep = epochs
    E = ep.y.shape[0]
    iters = config.pos_iterations if iterations is None else iterations
    w = torch.where(ep.valid, ep.weight, 0.0)
    psr_std = spp.DEFAULT_PSEUDORANGE_NOISE / torch.sqrt(w.clamp(min=1e-6))
    # Rows scaled by 1/std and masked: Jw = J a, the masked residual
    # (y - pred) a
    a = torch.where(ep.valid, 1.0 / psr_std, 0.0)
    # pred = P.x + q and J = P + inv_rho0 (delta - los (los.delta), 0) with
    # P = [-los + (sag_coef, 0), 1] (the first-order model and the Sagnac
    # delta term) and q the second-order range term
    zero_col = torch.zeros_like(ep.los[..., :1])
    los4 = torch.cat([ep.los, zero_col], -1)
    P = torch.cat([torch.cat([ep.sag_coef, zero_col], -1) - ep.los,
                   _ones_col(ep.los)], -1)
    half_inv_rho0 = 0.5 * ep.inv_rho0
    inv_rho0 = ep.inv_rho0[..., None]
    # [1, 1, 1, 0], made on the device (a host list would be a blocking
    # copy)
    mask3 = (torch.arange(4, device=ep.y.device) < 3).to(ep.y.dtype)
    eye = torch.eye(4, dtype=ep.y.dtype, device=ep.y.device)
    damp = 1e-6 * eye
    n_sats = ep.valid.sum(-1, dtype=torch.int32)
    pos_ok = n_sats >= 4

    x_prev = ep.y.new_zeros(4)
    xs = []
    for e in range(E):
        los, P_e, a_e, y_e = ep.los[e], P[e], a[e], ep.y[e]
        hr_e, ir_e, los4_e = half_inv_rho0[e], inv_rho0[e], los4[e]
        x = x_prev
        for _ in range(iters):
            ld = (los * x[:3]).sum(-1)
            d2 = (x[:3] * x[:3]).sum()
            pred = (P_e * x).sum(-1) + hr_e * (d2 - ld * ld)
            ra = (y_e - pred) * a_e
            J = P_e + ir_e * (x * mask3 - los4_e * ld[:, None])
            Jw = J * a_e[:, None]
            H = spp.gram(Jw, Jw) + damp
            g = (Jw * ra[:, None]).sum(0)
            L, info = torch.linalg.cholesky_ex(H)
            dx = torch.cholesky_solve(g[:, None], L)[:, 0]
            x = x + torch.where(torch.isfinite(dx) & (info == 0), dx, 0.0)
        xs.append(x)
        x_prev = torch.where(pos_ok[e], x, x_prev)
    X = torch.stack(xs)
    delta = X[:, :3]

    # DOP and covariance at each solution (``calculateGpsDOP``,
    # ``:1510-1577``), with the LOS moved to the solved position
    # (first order; ~4e-6 rad per 100 m).
    ld = (ep.los * delta[:, None]).sum(-1)
    dlos = -(delta[:, None] - ep.los * ld[..., None]) * inv_rho0
    los_c = ep.los + dlos
    G = torch.cat([-los_c, _ones_col(ld[..., None])], -1)
    cov = spp.inv4(spp.gram(G, G * w[..., None]) + 1e-8 * eye)
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)

    # Doppler velocity (closed form, ``:1622-1708``): the anchored RHS moved
    # to the solved position (the LOS change in the satellite-velocity
    # projection, the delta term of the Sagnac rate)
    z = (ep.z0 + (dlos * ep.sat_vel).sum(-1)
         + W_C * (ep.sat_vel[..., 0] * delta[:, 1:2]
                  - ep.sat_vel[..., 1] * delta[:, 0:1]))
    Gv = torch.cat([los_c, _ones_col(ld[..., None])], -1)
    Gvw = Gv * torch.where(ep.dop_valid, ep.weight, 0.0)[..., None]
    xv = spp.solve4(spp.gram(Gv, Gvw) + damp,
                    spp.mat_vec(Gvw.transpose(-1, -2),
                                torch.where(ep.dop_valid, z, 0.0)))
    vel = xv[:, :3]
    vel_base_ok = ((ep.dop_valid.sum(-1) >= 4)
                   & (torch.linalg.norm(vel, dim=-1) <= spp.MAX_VELOCITY))
    # The chain: each velocity against the last accepted one
    change = []
    v_prev = vel.new_zeros(3)
    for e in range(E):
        ok = vel_base_ok[e] & (torch.linalg.norm(vel[e] - v_prev)
                               <= spp.MAX_VEL_CHANGE)
        change.append(ok)
        v_prev = torch.where(ok, vel[e], v_prev)
    vel_ok = torch.stack(change)

    R = ep.R_enu
    return LocalSolution(
        delta=delta, clock_bias=X[:, 3], enu=spp.mat_vec(R, delta),
        covariance=cov,
        gdop=torch.sqrt(diag.sum(-1)),
        pdop=torch.sqrt(diag[:, 0] + diag[:, 1] + diag[:, 2]),
        hdop=torch.sqrt(diag[:, 0] + diag[:, 1]),
        vdop=torch.sqrt(diag[:, 2]), tdop=torch.sqrt(diag[:, 3]),
        num_sats=n_sats, valid=pos_ok, vel_ecef=vel, clock_drift=xv[:, 3],
        vel_enu=spp.mat_vec(R, vel), vel_valid=vel_ok)
