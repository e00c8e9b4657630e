"""UWB trilateration by damped Gauss-Newton least squares (port of
``toyslam_tpu/estimators/trilateration.py``).

In place of the reference's Ceres solves (``uwb_node.cpp:202-269``: range
residual, optional Huber loss, warm start): residuals ``r_i = ||p - a_i||
- d_i`` and a fixed number of damped Gauss-Newton steps. JAX's
``lax.fori_loop`` is a host loop of ``max_iterations`` steps that never
reads a device value, and the 3x3 normal equations are solved by the
adjugate (``core/se3.inv3``), so a solve makes no host synchronisation.
Every function takes leading batch dimensions: ``solve_positions_batch``
solves all epochs in one batched call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toyslam_tpu_torch.core import se3


class TrilaterationConfig(NamedTuple):
    max_iterations: int = 20  # uwb_node.cpp solver cap (:236 options)
    damping: float = 1e-6
    huber_delta: float = 0.0  # 0 disables robust weights (uwb_node optional)


def _residuals(p, ranges, anchors, w_valid, huber_delta):
    """(r [..., B], J [..., B, 3], w [..., B]) at positions p [..., 3]."""
    diff = p[..., None, :] - anchors
    dist = torch.linalg.norm(diff, dim=-1)
    r = dist - ranges
    J = diff / dist.clamp(min=1e-9)[..., None]
    w = w_valid
    if huber_delta > 0:
        absr = r.abs()
        w = w * torch.where(absr <= huber_delta, torch.ones_like(absr),
                            huber_delta / absr.clamp(min=1e-12))
    return r, J, w


def solve_position(ranges, anchors, initial_guess, valid=None,
                   config: TrilaterationConfig = TrilaterationConfig()):
    """Least-squares position from anchor ranges: ``ranges [..., B]``,
    ``anchors [B, 3]``, ``initial_guess [..., 3]``, ``valid [..., B]``
    optional. Returns ``(position [..., 3], residual RMS [...])``."""
    dtype = ranges.dtype
    w_valid = (torch.ones_like(ranges) if valid is None
               else valid.to(dtype))
    damp = torch.eye(3, dtype=dtype, device=ranges.device) * config.damping
    p = initial_guess.to(dtype)
    for _ in range(config.max_iterations):
        r, J, w = _residuals(p, ranges, anchors, w_valid, config.huber_delta)
        Jw = J * w[..., None]
        JwT = Jw.transpose(-1, -2)
        H = JwT @ J + damp
        g = (JwT @ r[..., None])[..., 0]
        p = p - (se3.inv3(H) @ g[..., None])[..., 0]
    r, _, w = _residuals(p, ranges, anchors, w_valid, config.huber_delta)
    rms = torch.sqrt(((r * w) ** 2).sum(-1) / w.sum(-1).clamp(min=1.0))
    return p, rms


def solve_positions_batch(ranges, anchors, initial_guess,
                          config: TrilaterationConfig = TrilaterationConfig()):
    """``ranges [T, B]`` -> (positions [T, 3], RMS [T]), every epoch from
    ``initial_guess [3]`` in one batched solve (the reference's warm start,
    ``uwb_node.cpp:221``, does not batch)."""
    guess = initial_guess.to(ranges.dtype).expand(ranges.shape[0], 3)
    return solve_position(ranges, anchors, guess, config=config)
