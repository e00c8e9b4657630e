"""GNSS epoch pipeline: ephemeris store -> masks and weights -> SPP and
Doppler velocity (port of ``toyslam_tpu/gnss/pipeline.py``).

The ``gnssSpp.cpp`` runtime between the callbacks and the math:

- a per-PRN ephemeris store with replace-on-update and the age gate at use
  (``ephemCallback``/``MAX_EPH_AGE``, ``:60-82,741-797,40,345-356``);
- the epoch ``rawMeasCallback -> processPositionSolution ->
  processVelocitySolution`` (``:827-1128``): transmit-time satellite
  states, elevation and CN0 masks (``:973-979``), elevation x CN0 weights,
  Klobuchar iono and 2.3/sin(el) tropo, the iterated WLS position with
  DOPs, the Doppler velocity and its chain of checks;
- per-satellite az/el/used records an epoch, the headless skyplot stream
  (``RangingRC.cpp:1917-3497``).

The store is 32 PRN-indexed slots. ``run_epochs`` is a Python loop of
device operations over the epochs (JAX's ``lax.scan``): each epoch starts
from the previous accepted solution, chosen with ``torch.where``, so the
loop reads nothing back to the host. Float64 throughout (ECEF).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.geodesy import (SPEED_OF_LIGHT,
                                            ecef_to_enu_rotation, ecef_to_lla)
from toyslam_tpu_torch.gnss import atmosphere, spp
from toyslam_tpu_torch.gnss.ephemeris import GpsEphemeris, sat_pos_vel_clock

N_PRN = 32  # GPS PRN 1..32


class EphemerisStore(NamedTuple):
    """Per-PRN broadcast ephemeris slots (leaves [32])."""

    eph: GpsEphemeris

    def update(self, new: GpsEphemeris) -> "EphemerisStore":
        """The store with the slot of ``new.sat`` (0-d leaves) replaced
        (``ephemCallback``'s replace-on-update)."""
        i = ((new.sat.long() - 1) % N_PRN).reshape(1)
        return EphemerisStore(GpsEphemeris(*(
            buf.index_put((i,), torch.as_tensor(v, device=buf.device)
                          .to(buf.dtype).reshape(1))
            for buf, v in zip(self.eph, new))))

    def lookup(self, prn) -> GpsEphemeris:
        """The slots of PRNs ``prn`` [...]: an invalid PRN lands on slot 0
        with valid=False."""
        i = (prn.long() - 1).clamp(0, N_PRN - 1)
        eph = GpsEphemeris(*(buf[i] for buf in self.eph))
        match = eph.sat.long() == prn.long()
        return eph._replace(valid=eph.valid & match)


def store_init(dtype=torch.float64, device="cuda") -> EphemerisStore:
    zeros = torch.zeros(N_PRN, dtype=dtype, device=device)
    fields = {f: zeros for f in GpsEphemeris._fields}
    fields["sat"] = torch.zeros(N_PRN, dtype=torch.int32, device=device)
    fields["valid"] = torch.zeros(N_PRN, dtype=torch.bool, device=device)
    return EphemerisStore(GpsEphemeris(**fields))


def synthetic_constellation(n_sats: int = 24, dtype=torch.float64,
                            toe: float = 0.0, device="cuda") -> GpsEphemeris:
    """The nominal 24-slot Walker-style GPS layout as broadcast ephemeris
    (6 planes x 4 slots, 55 deg inclination, GPS semi-major axis): ~8-10
    satellites above a mid-latitude horizon at any epoch
    (``RangingRC.cpp:135-266`` builds its satellites the same way)."""
    i = torch.arange(n_sats, device=device)
    plane = (i // 4).to(dtype)
    slot = (i % 4).to(dtype)

    def full(v):
        return torch.full((n_sats,), v, dtype=dtype, device=device)

    zeros = full(0.0)
    return GpsEphemeris(
        sat=(i + 1).to(torch.int32),
        toe_sec=full(toe), toc_sec=full(toe),
        sqrta=full(math.sqrt(26559.8e3)),
        e=full(0.01),
        # in-plane anomaly spread + inter-plane phasing
        m0=slot * (math.pi / 2.0) + plane * (math.pi / 12.0),
        delta_n=zeros, omega=zeros,
        omg=plane * (math.pi / 3.0),
        omg_dot=zeros,
        i0=full(math.radians(55.0)),
        i_dot=zeros,
        cus=zeros, cuc=zeros, crs=zeros, crc=zeros, cis=zeros, cic=zeros,
        af0=full(1e-5), af1=full(1e-12), af2=zeros, tgd=full(2e-9),
        valid=torch.ones(n_sats, dtype=torch.bool, device=device),
    )


class EpochConfig(NamedTuple):
    """Masks and weights (``gnssSpp.cpp:611-717`` parameter block)."""

    cut_off_degree: float = 10.0  # elevation mask (``:616``)
    min_cn0: float = 10.0  # dB-Hz (``:611``)
    disable_elevation_filter: bool = False
    apply_iono_correction: bool = True
    apply_tropo_correction: bool = True
    pos_iterations: int = 15
    use_doppler: bool = True


class EpochRecord(NamedTuple):
    """Per-satellite diagnostics of an epoch (the skyplot/DOP stream)."""

    prn: torch.Tensor  # [S]
    elevation: torch.Tensor  # [S] rad
    azimuth: torch.Tensor  # [S] rad
    cn0: torch.Tensor  # [S]
    used: torch.Tensor  # [S] bool (passed every mask, entered the solve)
    iono_delay: torch.Tensor  # [S] m
    trop_delay: torch.Tensor  # [S] m


class EpochSolution(NamedTuple):
    position: spp.SppSolution
    velocity: spp.VelocitySolution
    enu: torch.Tensor  # [3] solution in the ENU frame of the reference
    lla: torch.Tensor  # [3] lat, lon, alt
    record: EpochRecord


def masks_and_corrections(sat, gps_tow, cn0, meas_valid, elevation,
                          azimuth, anchor_lla, iono, config: EpochConfig):
    """The masks, corrections and weights that ``process_epoch`` and
    ``local.prep_epochs`` share (``:973-995``): (used, Klobuchar iono,
    tropo, elevation x CN0 weight)."""
    used = meas_valid & sat["valid"]
    if not config.disable_elevation_filter:
        used = used & (elevation >= math.radians(config.cut_off_degree))
    used = used & (cn0 >= config.min_cn0)
    zero = torch.zeros_like(elevation)
    iono_delay = (atmosphere.klobuchar_delay(iono, gps_tow, anchor_lla[0],
                                             anchor_lla[1], elevation,
                                             azimuth).to(elevation.dtype)
                  if config.apply_iono_correction else zero)
    trop_delay = (atmosphere.simple_troposphere_delay(elevation)
                  if config.apply_tropo_correction else zero)
    weight = spp.elevation_weight(elevation, cn0=cn0, min_cn0=config.min_cn0)
    return used, iono_delay, trop_delay, weight


def process_epoch(store: EphemerisStore, iono: atmosphere.IonoParams,
                  gps_tow, prn, pseudorange, doppler_ms, cn0, meas_valid,
                  approx_pos, ref_ecef=None,
                  config: EpochConfig = EpochConfig(),
                  prev_vel_ecef=None) -> EpochSolution:
    """One ``rawMeasCallback``.

    prn/pseudorange/doppler_ms/cn0: padded [S] channels with
    ``meas_valid``; ``doppler_ms`` is the range rate in m/s (doppler x
    wavelength). ``approx_pos`` starts the WLS and anchors the elevation
    masks; ``ref_ecef`` is the output's ENU origin (default approx_pos).
    """
    dtype = pseudorange.dtype
    if ref_ecef is None:
        ref_ecef = approx_pos

    # Transmit-time satellite states from the store (age gate inside)
    eph = store.lookup(prn)
    sat = sat_pos_vel_clock(eph, gps_tow - pseudorange / SPEED_OF_LIGHT)
    elevation, azimuth = spp.elevation_azimuth(sat["pos"], approx_pos)
    used, iono_delay, trop_delay, weight = masks_and_corrections(
        sat, gps_tow, cn0, meas_valid, elevation, azimuth,
        ecef_to_lla(approx_pos), iono, config)

    obs = spp.SatelliteObs(
        pos=sat["pos"], pseudorange=pseudorange,
        clock_bias=sat["clock_bias"], iono_delay=iono_delay,
        trop_delay=trop_delay, tgd=eph.tgd, weight=weight, valid=used)
    init = torch.cat([approx_pos, approx_pos.new_zeros(1)]).to(dtype)
    pos_sol = spp.solve_spp(obs, init, iterations=config.pos_iterations)

    dop = spp.DopplerObs(
        sat_pos=sat["pos"], sat_vel=sat["vel"],
        sat_clock_drift=sat["clock_drift"], range_rate=doppler_ms,
        weight=weight, valid=used & config.use_doppler)
    vel_sol = spp.solve_velocity(dop, pos_sol.state[:3])
    vel_sol = vel_sol._replace(valid=vel_sol.valid & spp.validate_velocity(
        vel_sol, prev_vel_ecef))

    ref_lla = ecef_to_lla(ref_ecef)
    R_enu = ecef_to_enu_rotation(ref_lla[0], ref_lla[1])
    return EpochSolution(
        position=pos_sol, velocity=vel_sol,
        enu=spp.mat_vec(R_enu, pos_sol.state[:3] - ref_ecef),
        lla=ecef_to_lla(pos_sol.state[:3]),
        record=EpochRecord(prn=prn, elevation=elevation, azimuth=azimuth,
                           cn0=cn0, used=used, iono_delay=iono_delay,
                           trop_delay=trop_delay))


def _stack(items):
    """A list of equal NamedTuples (nested) -> one with [E]-stacked
    leaves."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(leaves)) for leaves in zip(*items)))
    return torch.stack(items)


def run_epochs(store: EphemerisStore, iono: atmosphere.IonoParams,
               gps_tow, prn, pseudorange, doppler_ms, cn0, meas_valid,
               initial_pos, config: EpochConfig = EpochConfig()):
    """The epochs of a log ([E, S] channels, ``gps_tow`` [E]) in order: each
    starts from the previous accepted position and chains the velocity
    checks (``:1711+``). Returns an EpochSolution with [E]-stacked
    leaves."""
    dtype = pseudorange.dtype
    pos = initial_pos.to(dtype)
    vel = pos.new_zeros(3)
    sols = []
    for e in range(pseudorange.shape[0]):
        sol = process_epoch(store, iono, gps_tow[e], prn[e], pseudorange[e],
                            doppler_ms[e], cn0[e], meas_valid[e], pos,
                            ref_ecef=initial_pos, config=config,
                            prev_vel_ecef=vel)
        pos = torch.where(sol.position.valid, sol.position.state[:3], pos)
        vel = torch.where(sol.velocity.valid, sol.velocity.vel_ecef, vel)
        sols.append(sol)
    return _stack(sols)
