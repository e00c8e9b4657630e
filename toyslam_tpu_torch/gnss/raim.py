"""RAIM: fault detection, exclusion and protection levels (port of
``toyslam_tpu/gnss/raim.py``).

The reference's ``GPSRAIM.cpp``: iterated elevation-weighted WLS
(``estimatePositionWeightedLeastSquares``, ``:395-481``), the residual test
statistic through the hat matrix against a chi-square threshold
(``calculateRAIMResiduals``, ``:483-523``), the covariance (``:525-539``),
protection levels from the ENU covariance's axes and the slope terms of
the minimum detectable bias (``calculateRigorousProtectionLevels``,
``:541-663``), and leave-one-out fault exclusion
(``performFaultExclusion``, ``:664-725``).

Satellites are padded [..., S] tensors with validity masks and every
function takes leading batch dimensions (JAX's ``vmap``): a whole run of
epochs is one call. ``fault_exclusion`` solves all S leave-one-out subsets
of every epoch as one batch of [..., S, S] masks. Use float64 (ECEF).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core.geodesy import ecef_to_enu_rotation, ecef_to_lla
from toyslam_tpu_torch.gnss.spp import gram, inv4, mat_vec, solve4

# The reference's normal-quantile table for the k(P) multipliers
# (``t_distribution_values_``), looked up at the nearest probability.
_PROB_TABLE = (
    (0.5, 0.674), (0.6827, 1.0), (0.9, 1.645), (0.95, 1.96),
    (0.9545, 2.0), (0.99, 2.576), (0.9973, 3.0), (0.999, 3.291),
    (0.99999, 4.417), (0.9999999, 5.327),
)


def k_multiplier(probability: float) -> float:
    """Nearest-entry lookup (``getMultiplierForProbability``,
    ``:649-663``)."""
    return min(_PROB_TABLE, key=lambda pk: abs(pk[0] - probability))[1]


class RaimConfig(NamedTuple):
    max_iterations: int = 10
    chi_square_threshold: float = 5.0
    noise_stddev_m: float = 2.0
    prob_false_alarm: float = 1e-5
    prob_missed_detection: float = 1e-3
    min_weight: float = 0.01


class RaimResult(NamedTuple):
    state: torch.Tensor  # [..., 4] position + clock bias
    residuals: torch.Tensor  # [..., S]
    test_statistic: torch.Tensor
    fault_detected: torch.Tensor
    covariance: torch.Tensor  # [..., 4, 4]
    hpl: torch.Tensor
    vpl: torch.Tensor
    weights: torch.Tensor  # [..., S]


def _enu_rotation(position):
    lla = ecef_to_lla(position)
    return ecef_to_enu_rotation(lla[..., 0], lla[..., 1])


def _elevation_weights(sat_pos, position, valid, min_weight):
    enu = mat_vec(_enu_rotation(position)[..., None, :, :],
                  sat_pos - position[..., None, :])
    el = torch.atan2(enu[..., 2],
                     torch.sqrt(enu[..., 0] ** 2 + enu[..., 1] ** 2))
    w = (torch.sin(el) ** 2).clamp(min=min_weight)
    return torch.where(valid, w, 0.0)


def _geometry(sat_pos, state):
    """(G = [-los, 1] [..., S, 4], range [..., S])."""
    d = sat_pos - state[..., None, :3]
    rng = torch.linalg.norm(d, dim=-1).clamp(min=1e-9)
    return torch.cat([-d / rng[..., None], torch.ones_like(rng)[..., None]],
                     -1), rng


def _eye(like):
    return torch.eye(4, dtype=like.dtype, device=like.device)


def wls_solve(sat_pos, pseudoranges, valid, initial_state,
              config: RaimConfig = RaimConfig()):
    """Iterated elevation-weighted WLS: (state [..., 4], G [..., S, 4],
    weights [..., S])."""
    state = initial_state.to(sat_pos.dtype).expand(
        sat_pos.shape[:-2] + (4,))
    for _ in range(config.max_iterations):
        G, rng = _geometry(sat_pos, state)
        dr = torch.where(valid, pseudoranges - (rng + state[..., 3:4]), 0.0)
        w = _elevation_weights(sat_pos, state[..., :3], valid,
                               config.min_weight)
        Gw = G * w[..., None]
        state = state + solve4(gram(G, Gw) + 1e-9 * _eye(G),
                               mat_vec(Gw.transpose(-1, -2), dr))
    G, _ = _geometry(sat_pos, state)
    return state, G, _elevation_weights(sat_pos, state[..., :3], valid,
                                        config.min_weight)


def _horizontal_axis(cov_enu):
    """(trace, sqrt(trace^2 / 4 - det)) of the horizontal 2x2 block: its
    eigenvalues are trace / 2 +- the second."""
    hc = cov_enu[..., :2, :2]
    tr = hc[..., 0, 0] + hc[..., 1, 1]
    det = hc[..., 0, 0] * hc[..., 1, 1] - hc[..., 0, 1] * hc[..., 1, 0]
    return tr, torch.sqrt((tr * tr / 4.0 - det).clamp(min=0.0))


def _cov_enu(R, cov):
    return R @ cov[..., :3, :3] @ R.transpose(-1, -2)


def raim_detect(sat_pos, pseudoranges, valid, initial_state,
                config: RaimConfig = RaimConfig()) -> RaimResult:
    """WLS solve, the residuals' chi-square fault test and the protection
    levels, over leading batch dimensions."""
    dtype = sat_pos.dtype
    state, G, w = wls_solve(sat_pos, pseudoranges, valid, initial_state,
                            config)
    rng = torch.linalg.norm(sat_pos - state[..., None, :3],
                            dim=-1).clamp(min=1e-9)
    dr = torch.where(valid, pseudoranges - (rng + state[..., 3:4]), 0.0)

    Gw = G * w[..., None]
    Ninv = inv4(gram(G, Gw) + 1e-9 * _eye(G))
    # hat = G N^-1 G^T W; residual projector I - hat (``:505-512``)
    hat = G @ Ninv @ Gw.transpose(-1, -2)
    res = torch.where(valid, dr - mat_vec(hat, dr), 0.0)

    n = valid.to(dtype).sum(-1)
    test_stat = (res * w * res).sum(-1) / (n - 4.0).clamp(min=1.0)
    fault = test_stat > config.chi_square_threshold

    # Protection levels (``:541-663``)
    R = _enu_rotation(state[..., :3])
    cov_enu = _cov_enu(R, Ninv)
    tr, disc = _horizontal_axis(cov_enu)
    semi_major = torch.sqrt((tr / 2.0 + disc).clamp(min=0.0))
    vertical_std = torch.sqrt(cov_enu[..., 2, 2].clamp(min=0.0))
    k_md = k_multiplier(1.0 - config.prob_missed_detection)
    k_fa = k_multiplier(1.0 - config.prob_false_alarm)

    # Slopes: the solution's sensitivity to a bias on each satellite
    sens_enu = R @ (Ninv @ Gw.transpose(-1, -2))[..., :3, :]  # [..., 3, S]
    h_slope = torch.where(valid, torch.sqrt(sens_enu[..., 0, :] ** 2
                                            + sens_enu[..., 1, :] ** 2), 0.0)
    v_slope = torch.where(valid, sens_enu[..., 2, :].abs(), 0.0)
    mdb = k_fa * config.noise_stddev_m * torch.sqrt(w.amax(-1))
    hpl = torch.maximum(k_md * semi_major, h_slope.amax(-1) * mdb)
    vpl = torch.maximum(k_md * vertical_std, v_slope.amax(-1) * mdb)
    return RaimResult(state=state, residuals=res, test_statistic=test_stat,
                      fault_detected=fault, covariance=Ninv, hpl=hpl,
                      vpl=vpl, weights=w)


def fault_exclusion(sat_pos, pseudoranges, valid, initial_state,
                    config: RaimConfig = RaimConfig()):
    """Leave-one-out exclusion, every candidate of every epoch in one
    batch (``performFaultExclusion``, ``:664-725``).

    Returns (excluded index or -1 [...], the test statistic after
    exclusion [...], the RaimResult of the best subset).
    """
    S = sat_pos.shape[-2]
    keep = ~torch.eye(S, dtype=torch.bool, device=sat_pos.device)
    results = raim_detect(sat_pos[..., None, :, :].expand(
        sat_pos.shape[:-2] + (S, S, 3)),
        pseudoranges[..., None, :].expand(pseudoranges.shape + (S,)),
        valid[..., None, :] & keep, initial_state[..., None, :], config)
    # Only satellites valid to begin with are candidates
    stats = torch.where(valid, results.test_statistic, torch.inf)
    best = stats.argmin(-1)
    best_stat = stats.gather(-1, best[..., None])[..., 0]
    excluded = torch.where(best_stat < config.chi_square_threshold, best, -1)

    def pick(x):
        idx = best.reshape(best.shape + (1,) * (x.dim() - best.dim()))
        return x.gather(best.dim(), idx.expand(
            best.shape + (1,) + x.shape[best.dim() + 1:])).squeeze(best.dim())

    return excluded, best_stat, RaimResult(*(pick(x) for x in results))


def covariance_ellipse(result: RaimResult):
    """The headless covariance and protection export (the RViz markers of
    ``publishPositionWithCovariance`` and the protection cylinder,
    ``GPSRAIM.cpp:823-918``): the ENU position covariance, the horizontal
    1-sigma ellipse (semi-axes, orientation of the major axis) and the
    protection cylinder (hpl radius, vpl half-height). Closed form for the
    2x2 block, over leading batch dimensions."""
    cov_enu = _cov_enu(_enu_rotation(result.state[..., :3]),
                       result.covariance)
    tr, disc = _horizontal_axis(cov_enu)
    hc = cov_enu[..., :2, :2]
    return {
        "cov_enu": cov_enu,
        "semi_major": torch.sqrt((tr / 2.0 + disc).clamp(min=0.0)),
        "semi_minor": torch.sqrt((tr / 2.0 - disc).clamp(min=0.0)),
        "orientation_rad": 0.5 * torch.atan2(2.0 * hc[..., 0, 1],
                                             hc[..., 0, 0] - hc[..., 1, 1]),
        "sigma_up": torch.sqrt(cov_enu[..., 2, 2].clamp(min=0.0)),
        "hpl": result.hpl,
        "vpl": result.vpl,
    }
