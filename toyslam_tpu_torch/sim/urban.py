"""Urban-canyon GNSS signal simulator: blockage, multipath and the error
budget (port of ``toyslam_tpu/sim/urban.py``).

The reference's ``lidar_subscriber/src/RangingRC.cpp``: buildings as
axis-aligned boxes with attenuation and reflectivity (``:34-134``), each
satellite's signal classed LOS, blocked or multipath by ray-box tests
(``:649-676,1864-1916``), single-bounce reflection points on building
faces (``:1744-1863``), C/N0 from the link budget and the pseudorange
error budget (iono/tropo/multipath/receiver noise/clock, ``:379-542``),
and a receiver clock random walk (``:976-990``).

Every function takes leading batch dimensions: a whole drive is one
[T, S, B, ...] tensor program, epochs at once (JAX scans over epochs, but
its scan carries only the PRNG key, so the epochs are independent). The
mirror-image reflection search is closed form for each vertical face.
Draws come from an explicit ``torch.Generator`` in a fixed order (the
clock walk when one is generated, then the pseudorange noise), made on the
generator's device and moved to the data's: reseeding it repeats a run,
and a seeded CPU generator gives the host and the card the same draws.
They are not the JAX package's numbers. ``skyplot_records`` and the DOP
helpers are host numpy, as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from toyslam_tpu_torch.core.geodesy import (SPEED_OF_LIGHT,
                                            ecef_to_enu_rotation, lla_to_ecef)
from toyslam_tpu_torch.gnss import atmosphere
from toyslam_tpu_torch.gnss.ephemeris import sat_pos_vel_clock
from toyslam_tpu_torch.gnss.spp import mat_vec


class Buildings(NamedTuple):
    """Axis-aligned boxes: [B] min/max corners and materials."""

    min_xyz: torch.Tensor  # [B, 3]
    max_xyz: torch.Tensor  # [B, 3]
    attenuation_db: torch.Tensor  # [B] through-building loss
    reflectivity: torch.Tensor  # [B] 0..1


def _randn(generator, shape, dtype, device):
    """Standard normals drawn on the generator's device, on ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def make_city(generator: torch.Generator, n_buildings=8, area=60.0,
              height_range=(10.0, 40.0), dtype=torch.float64,
              device="cuda") -> Buildings:
    """A random Manhattan-style block layout (RangingRC's default scene)."""
    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(
            shape, generator=generator, dtype=dtype,
            device=generator.device).to(device)

    centers = uniform((n_buildings, 2), -area, area)
    sizes = uniform((n_buildings, 2), 8.0, 20.0)
    heights = uniform((n_buildings,), *height_range)
    zeros = torch.zeros((n_buildings, 1), dtype=dtype, device=device)
    return Buildings(
        min_xyz=torch.cat([centers - sizes / 2, zeros], 1),
        max_xyz=torch.cat([centers + sizes / 2, heights[:, None]], 1),
        attenuation_db=torch.full((n_buildings,), 30.0, dtype=dtype,
                                  device=device),
        reflectivity=torch.full((n_buildings,), 0.5, dtype=dtype,
                                device=device))


def ray_aabb_intersect(origin, direction, box_min, box_max, t_max):
    """Slab test: does the segment origin + t direction, t in (eps, t_max),
    hit the box? Broadcasts over leading dimensions."""
    tiny = torch.where(direction >= 0, 1e-12, -1e-12)
    inv = 1.0 / torch.where(direction.abs() < 1e-12, tiny, direction)
    t0 = (box_min - origin) * inv
    t1 = (box_max - origin) * inv
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    return (t_near <= t_far) & (t_far > 1e-3) & (t_near < t_max)


def classify_signals(receiver, sat_pos, city: Buildings):
    """LOS / blocked (``computeGPSSignals``, ``:1864-1916``): (blocked
    [..., S], number of obstructions [..., S])."""
    blocked, n, _ = classify_signals_attenuation(receiver, sat_pos, city)
    return blocked, n


def classify_signals_attenuation(receiver, sat_pos, city: Buildings):
    """The classes and the summed through-building attenuation (the
    reference attenuates per penetrated building, ``:379-542``) of the
    satellites [..., S, 3] seen from ``receiver`` [..., 3]: (blocked,
    n_obstructions, attenuation_db), each [..., S]."""
    d = sat_pos - receiver[..., None, :]
    rng = torch.linalg.norm(d, dim=-1, keepdim=True)
    hit = ray_aabb_intersect(receiver[..., None, None, :],
                             (d / rng)[..., None, :], city.min_xyz,
                             city.max_xyz, rng)  # [..., S, B]
    att = torch.where(hit, city.attenuation_db, 0.0).sum(-1)
    return hit.any(-1), hit.sum(-1, dtype=torch.int32), att


def _segment_blocked(p0, p1, city: Buildings, exclude=None):
    """Is the segment p0 -> p1 blocked by a building (other than building
    ``exclude``)? ``checkSignalBlockage`` (``RangingRC.cpp:1696-1717``);
    p0/p1 broadcast over leading dimensions."""
    d = p1 - p0
    seg_len = torch.linalg.norm(d, dim=-1, keepdim=True)
    hit = ray_aabb_intersect(p0[..., None, :],
                             (d / seg_len.clamp(min=1e-9))[..., None, :],
                             city.min_xyz, city.max_xyz, seg_len)  # [..., B]
    if exclude is not None:
        B = city.min_xyz.shape[0]
        ids = torch.arange(B, device=hit.device)
        hit = hit & (ids != exclude[..., None])
    return hit.any(-1)


def _face_reflections(receiver, sat_pos, city: Buildings):
    """Single-bounce reflections off the 4 vertical faces of each building
    (the mirror method, closed form for axis-aligned faces, in place of
    the reference's search ``:1744-1863``).

    Both bounce segments (satellite -> reflection point -> receiver) are
    checked against every other building, as the reference's search does
    with ``checkSignalBlockage`` (``RangingRC.cpp:1696-1717,1744-1863``): a
    mirror hit whose path crosses a third building is no usable multipath.

    Returns (has_reflection, extra_path, refl_building), each [..., S].
    """
    lead_s = sat_pos.shape[:-1]
    B = city.min_xyz.shape[0]
    dtype, dev = sat_pos.dtype, sat_pos.device
    extra_best = torch.full(lead_s, math.inf, dtype=dtype, device=dev)
    found = torch.zeros(lead_s, dtype=torch.bool, device=dev)
    bld_best = torch.full(lead_s, -1, dtype=torch.int64, device=dev)

    direct = torch.linalg.norm(sat_pos - receiver[..., None, :], dim=-1)
    sat = sat_pos[..., :, None, :]  # [..., S, 1, 3]
    excl = torch.arange(B, device=dev).expand(lead_s + (B,))
    for axis in (0, 1):
        o1 = 1 - axis  # the other horizontal axis
        for side in (0, 1):
            plane = (city.min_xyz if side == 0 else city.max_xyz)[:, axis]
            # The receiver mirrored across each face's plane [..., B, 3]
            r_axis = receiver[..., axis:axis + 1]
            comps = [receiver[..., k:k + 1].expand(
                receiver.shape[:-1] + (B,)) for k in range(3)]
            comps[axis] = 2 * plane - r_axis
            mirrored = torch.stack(comps, -1)
            # Where the satellite -> mirrored segment meets the plane
            d = mirrored[..., None, :, :] - sat  # [..., S, B, 3]
            denom = d[..., axis]
            t = (plane - sat[..., axis]) / torch.where(denom.abs() < 1e-9,
                                                       1e-9, denom)
            hit_pt = sat + t[..., None] * d
            in_face = ((t > 0) & (t < 1)
                       & (hit_pt[..., o1] >= city.min_xyz[:, o1])
                       & (hit_pt[..., o1] <= city.max_xyz[:, o1])
                       & (hit_pt[..., 2] >= 0.0)
                       & (hit_pt[..., 2] <= city.max_xyz[:, 2]))
            # The receiver on the face's outer side
            outside = r_axis < plane if side == 0 else r_axis > plane
            # Both bounce segments clear of every OTHER building (the
            # reflector is left out: the bounce rays leave its surface, and
            # a grazing slab hit would block them)
            up_clear = ~_segment_blocked(sat.expand(hit_pt.shape), hit_pt,
                                         city, exclude=excl)
            down_clear = ~_segment_blocked(
                hit_pt, receiver[..., None, None, :].expand(hit_pt.shape),
                city, exclude=excl)
            valid = in_face & outside[..., None, :] & up_clear & down_clear
            # Reflected path length = |satellite -> mirrored receiver|
            extra = torch.where(valid, torch.linalg.norm(d, dim=-1)
                                - direct[..., None], math.inf)
            best_e, best_b = extra.min(-1)
            better = best_e < extra_best
            extra_best = torch.where(better, best_e, extra_best)
            bld_best = torch.where(better, best_b, bld_best)
            found = found | torch.isfinite(best_e)
    return found, torch.where(found, extra_best, 0.0), bld_best


class SignalBudget(NamedTuple):
    blocked: torch.Tensor  # [..., S] bool
    multipath: torch.Tensor  # [..., S] bool (blocked, a reflection: NLOS)
    cn0: torch.Tensor  # [..., S] dB-Hz
    pseudorange_error: torch.Tensor  # [..., S] m (systematic, no noise)
    noise_std: torch.Tensor  # [..., S] m
    usable: torch.Tensor  # [..., S] bool


BOLTZMANN_CONSTANT = 1.38064852e-23  # J/K (``RangingRC.cpp:369``)
RECEIVER_TEMP = 290.0  # K (``:370``)
GPS_L1_HZ = 1575.42e6


def free_space_path_loss_db(distance_m, frequency_hz=GPS_L1_HZ):
    """FSPL = 20 log10(4 pi d f / c) (``calculateFreeSpacePathLoss``,
    ``RangingRC.cpp:389-393``)."""
    return 20.0 * torch.log10(4.0 * math.pi * distance_m * frequency_hz
                              / SPEED_OF_LIGHT)


def cn0_from_elevation(elevations, path_loss_db=0.0):
    """C/N0 from the reference's link budget (``calculateCN0FromElevation``
    and ``calculateCN0``, ``RangingRC.cpp:402-427``): received power from
    -157 dBW at 5 deg elevation to -153 dBW at 90 deg (the nominal ~182.5
    dB orbital FSPL is in those constants), less ``path_loss_db`` of extra
    loss, over the kT noise floor at 290 K (N0 ~ -204 dBW/Hz). LOS C/N0 is
    ~47-51 dB-Hz. Elevations in radians."""
    el_deg = torch.rad2deg(elevations.abs())
    factor = ((el_deg - 5.0) / 85.0).clamp(0.0, 1.0)
    n0_dbw_hz = 10.0 * math.log10(BOLTZMANN_CONSTANT * RECEIVER_TEMP)
    return -157.0 + 4.0 * factor - path_loss_db - n0_dbw_hz


def pseudorange_std_from_cn0(cn0_db_hz, a=25.0):
    """sigma = a / sqrt(10^(C/N0 / 10)) (``calculatePseudorangeStdDev``,
    ``RangingRC.cpp:429-434``): ~0.11 m at 47 dB-Hz, 2.5 m at 20 dB-Hz."""
    return a / torch.sqrt(torch.pow(10.0, cn0_db_hz / 10.0))


def signal_budget(receiver, sat_pos, elevations, city: Buildings,
                  iono_m=None, tropo_m=None, min_cn0=20.0) -> SignalBudget:
    """The classes, the C/N0 link budget and the pseudorange error budget
    (``RangingRC.cpp:379-542,1470-1660``).

    Extra losses over the elevation link budget (``cn0_from_elevation``):
    none on a direct LOS path (``:1499``); blocked through buildings, the
    summed material attenuation (``:1524-1530``); blocked with a single
    bounce (NLOS), the reflected-vs-direct FSPL difference plus the
    reflection loss -20 log10(reflectivity) (``:1581-1591``). The reference
    charges the reflected path's absolute FSPL (~182 dB) on top of
    constants that already hold the orbital FSPL, which would drop every
    reflection below its own 20 dB-Hz threshold; the relative form is its
    evident intent. ``min_cn0`` is the reference's ``min_cn0_threshold``
    default (``:791``). Usability is the C/N0 floor alone, as there: LOS,
    bounced NLOS and through-building reception all count above it
    (``:1499,1594,1533-1556``).
    """
    blocked, _, att_db = classify_signals_attenuation(receiver, sat_pos, city)
    has_refl, extra_path, bld = _face_reflections(receiver, sat_pos, city)

    direct = torch.linalg.norm(sat_pos - receiver[..., None, :], dim=-1)
    refl_coeff = torch.where(bld >= 0, city.reflectivity[bld.clamp(min=0)],
                             0.0)
    reflection_loss = -20.0 * torch.log10(refl_coeff.clamp(min=1e-3))
    fspl_delta = (free_space_path_loss_db(direct + extra_path)
                  - free_space_path_loss_db(direct))
    multipath = blocked & has_refl
    extra_loss = torch.where(multipath, fspl_delta + reflection_loss,
                             torch.where(blocked, att_db, 0.0))
    cn0 = cn0_from_elevation(elevations, extra_loss)

    # The systematic pseudorange error: NLOS adds its extra path
    zero = torch.zeros_like(direct)
    pr_err = ((zero if iono_m is None else iono_m)
              + (zero if tropo_m is None else tropo_m)
              + torch.where(multipath, extra_path, 0.0))
    return SignalBudget(
        blocked=blocked, multipath=multipath, cn0=cn0,
        pseudorange_error=pr_err,
        # receiver noise from the link budget (``:429-441``)
        noise_std=pseudorange_std_from_cn0(cn0), usable=cn0 >= min_cn0)


def receiver_clock_walk(generator: torch.Generator, n_steps, dt, bias0=0.0,
                        drift0=1e-7, drift_noise=1e-9, dtype=torch.float64,
                        device="cuda"):
    """The receiver clock bias random walk (``:976-990``): the bias
    integrates a slowly wandering drift. Returns the bias [T] in meters."""
    steps = drift_noise * _randn(generator, (n_steps,), dtype, device)
    drift = drift0 + torch.cumsum(steps * dt ** 0.5, 0)
    bias_s = bias0 / SPEED_OF_LIGHT + torch.cumsum(drift * dt, 0)
    return bias_s * SPEED_OF_LIGHT


def simulate_urban_epochs(generator: torch.Generator, positions, times, eph,
                          city: Buildings, ref_lla, clock_bias_m=None,
                          iono_params=None, apply_atmosphere: bool = True):
    """A time-propagated canyon drive (``RangingRC.cpp:135-266`` and its
    update loop): the broadcast ephemeris Kepler-propagated at every epoch,
    the satellites in the city's ENU frame, and the ray-traced signal
    budget, all epochs at once.

    positions: [T, 3] receiver track in the city's ENU frame; times: [T]
    GPS seconds of week; eph: a ``gnss.ephemeris.GpsEphemeris``; ref_lla:
    [3] the ENU origin. clock_bias_m: [T] receiver clock (default: a
    generated random walk, ``:976-990``). As the reference's budget
    (``RangingRC.cpp:379-542``), Klobuchar (``iono_params``, default the
    broadcast zeros, the model's 5 ns floor) and the 2.3/sin(el)
    troposphere are added; ``apply_atmosphere=False`` leaves the geometric
    ranges. Runs where ``positions`` lie (float64).

    Returns dict(pseudoranges [T, S], budget leaves [T, S], sat_enu
    [T, S, 3], elevations, iono_m, tropo_m [T, S], clock_bias_m [T]).
    """
    T = positions.shape[0]
    S = eph.toe_sec.shape[0]
    ref_ecef = lla_to_ecef(ref_lla[0], ref_lla[1], ref_lla[2])
    R_enu = ecef_to_enu_rotation(ref_lla[0], ref_lla[1])
    if clock_bias_m is None:
        dt = times[1] - times[0] if T > 1 else 1.0
        clock_bias_m = receiver_clock_walk(generator, T, dt,
                                           dtype=positions.dtype,
                                           device=positions.device)
    if iono_params is None:
        iono_params = atmosphere.IonoParams(
            alpha=positions.new_zeros(4), beta=positions.new_zeros(4))

    sat = sat_pos_vel_clock(eph, times[:, None].expand(T, S))
    sat_enu = mat_vec(R_enu, sat["pos"] - ref_ecef)
    rel = sat_enu - positions[:, None, :]
    rng = torch.linalg.norm(rel, dim=-1)
    elev = torch.asin((rel[..., 2] / rng.clamp(min=1e-9)).clamp(-1, 1))
    azim = torch.atan2(rel[..., 0], rel[..., 1])
    if apply_atmosphere:
        iono_m = atmosphere.klobuchar_delay(iono_params, times[:, None],
                                            ref_lla[0], ref_lla[1], elev,
                                            azim)
        tropo_m = atmosphere.simple_troposphere_delay(elev)
    else:
        iono_m = tropo_m = torch.zeros_like(elev)
    pr, budget = simulate_urban_pseudoranges(
        generator, positions, sat_enu, elev, city,
        clock_bias_m=clock_bias_m[:, None], iono_m=iono_m, tropo_m=tropo_m)
    pr = torch.where(sat["valid"], pr, math.nan)
    usable = budget.usable & sat["valid"] & (elev > 0)
    return {"pseudoranges": pr, "budget": budget._replace(usable=usable),
            "sat_enu": sat_enu, "elevations": elev, "iono_m": iono_m,
            "tropo_m": tropo_m, "clock_bias_m": clock_bias_m}


def simulate_urban_pseudoranges(generator: torch.Generator, receiver,
                                sat_pos, elevations, city: Buildings,
                                clock_bias_m=0.0, iono_m=None, tropo_m=None):
    """The classes, the budget and noisy pseudoranges of the satellites
    [..., S, 3] seen from ``receiver`` [..., 3] (``clock_bias_m`` a number
    or broadcastable to [..., S]).

    Returns (pseudoranges [..., S], budget); unusable satellites get NaN
    (mask them with budget.usable).
    """
    budget = signal_budget(receiver, sat_pos, elevations, city, iono_m,
                           tropo_m)
    true_range = torch.linalg.norm(sat_pos - receiver[..., None, :], dim=-1)
    noise = budget.noise_std * _randn(generator, true_range.shape,
                                      true_range.dtype, true_range.device)
    pr = true_range + clock_bias_m + budget.pseudorange_error + noise
    return torch.where(budget.usable, pr, math.nan), budget


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def skyplot_records(epochs: dict, times=None):
    """A ``simulate_urban_epochs`` result as the headless skyplot stream
    (``publishSkyplot``, ``RangingRC.cpp:1917-3497``): a dict an epoch
    with each satellite's az/el/C/N0, the LOS / blocked / multipath class
    the RViz skyplot colours by, and the epoch's DOP of the usable
    geometry (``calculateDOP``). JSONL-ready; host numpy."""
    budget = epochs["budget"]
    sat_enu = _np(epochs["sat_enu"])
    elevs = _np(epochs["elevations"]).astype(np.float64)
    blocked = _np(budget.blocked)
    multipath = _np(budget.multipath)
    cn0 = _np(budget.cn0)
    usable = _np(budget.usable)
    T, S = elevs.shape

    az = np.arctan2(sat_enu[..., 0], sat_enu[..., 1])  # [T, S]
    el_deg = np.round(np.rad2deg(elevs), 2).tolist()
    az_deg = np.round(np.rad2deg(az), 2).tolist()
    cn0_r = np.round(cn0.astype(np.float64), 1).tolist()
    cls = np.where(multipath, "multipath",
                   np.where(blocked, "blocked", "los")).tolist()
    usable_l = usable.tolist()
    t_l = (_np(times).astype(np.float64).tolist() if times is not None
           else list(range(T)))
    dops = _dop_batch(az, elevs, usable)

    out = []
    for e in range(T):
        sats = [{"sat": s + 1, "el_deg": el_deg[e][s], "az_deg": az_deg[e][s],
                 "cn0": cn0_r[e][s], "class": cls[e][s],
                 "usable": usable_l[e][s]} for s in range(S)]
        rec = {"t": t_l[e], "sats": sats}
        rec.update(dops[e])
        out.append(rec)
    return out


def _dop_batch(az, el, usable):
    """DOPs over [T, S] az/el with each epoch's usable mask (the semantics
    of ``dop_from_az_el`` an epoch, one batched inverse)."""
    az = np.asarray(az, np.float64)
    el = np.asarray(el, np.float64)
    G = np.stack([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az),
                  np.sin(el), np.ones_like(el)], -1)  # [T, S, 4]
    Gm = G * usable[..., None]
    N = np.einsum("tsi,tsj->tij", Gm, Gm)
    ok = usable.sum(1) >= 4
    N_safe = np.where(ok[:, None, None], N, np.eye(4))
    with np.errstate(all="ignore"):
        try:
            Q = np.linalg.inv(N_safe)
        except np.linalg.LinAlgError:  # a singular member: epoch by epoch
            Q = np.stack([
                np.linalg.inv(n) if np.isfinite(np.linalg.cond(n))
                and np.linalg.cond(n) < 1e12 else np.full((4, 4), np.nan)
                for n in N_safe])
    # Reject inverses that did not invert (singular geometry)
    resid = np.abs(np.einsum("tij,tjk->tik", N_safe, Q)
                   - np.eye(4)).max((1, 2))
    good = ok & np.isfinite(Q).all((1, 2)) & (resid < 1e-3)
    d = np.einsum("tii->ti", Q)
    nan = float("nan")
    return [
        {"gdop": round(float(np.sqrt(d[e].sum())), 3),
         "pdop": round(float(np.sqrt(d[e, :3].sum())), 3),
         "hdop": round(float(np.sqrt(d[e, :2].sum())), 3),
         "vdop": round(float(np.sqrt(d[e, 2])), 3)} if good[e]
        else {"gdop": nan, "pdop": nan, "hdop": nan, "vdop": nan}
        for e in range(len(ok))
    ]


def dop_from_az_el(az, el):
    """GDOP/PDOP/HDOP/VDOP of the usable satellites' az/el
    (``calculateDOP``, ``RangingRC.cpp``: the unweighted geometry matrix
    G = [e n u 1] a satellite). NaNs below 4 satellites."""
    az = np.asarray(az, np.float64)
    el = np.asarray(el, np.float64)
    nan = {"gdop": float("nan"), "pdop": float("nan"),
           "hdop": float("nan"), "vdop": float("nan")}
    if len(az) < 4:
        return nan
    G = np.stack([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az),
                  np.sin(el), np.ones_like(el)], 1)
    try:
        Q = np.linalg.inv(G.T @ G)
    except np.linalg.LinAlgError:
        return nan
    d = np.diag(Q)
    return {"gdop": round(float(np.sqrt(d.sum())), 3),
            "pdop": round(float(np.sqrt(d[:3].sum())), 3),
            "hdop": round(float(np.sqrt(d[:2].sum())), 3),
            "vdop": round(float(np.sqrt(d[2])), 3)}
