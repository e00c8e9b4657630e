"""Headless geometry exports for the reference's plotting helpers (the
port's copy of ``toyslam_tpu/utils/plotio.py``; numpy, as there).

Capability port of ``ICP/utils/plot.py:15-234`` without matplotlib: each
function returns the GEOMETRY the reference would have drawn (ellipse
parameters + polyline vertices, arrow polylines), ready for CSV/JSONL
export or any downstream plotting tool. The parameter conventions match
the reference exactly (chi2 scaling, major-axis angle via atan2 of the
dominant eigenvector, rot_mat_2d rotation).
"""

from __future__ import annotations

import numpy as np


def covariance_ellipse_2d(cov, chi2: float = 3.0):
    """Ellipse parameters of a 2x2 covariance (``plot_covariance_ellipse``,
    ``ICP/utils/plot.py:15-42``): semi-axes scaled by sqrt(chi2 * eig) and
    the major-axis angle.

    Returns dict(a, b, angle_rad).
    """
    cov = np.asarray(cov, dtype=np.float64)
    eig_val, eig_vec = np.linalg.eig(cov)
    big = 0 if eig_val[0] >= eig_val[1] else 1
    small = 1 - big
    a = float(np.sqrt(max(chi2 * eig_val[big], 0.0)))
    b = float(np.sqrt(max(chi2 * eig_val[small], 0.0)))
    angle = float(np.arctan2(eig_vec[1, big], eig_vec[0, big]))
    return {"a": a, "b": b, "angle_rad": angle}


def ellipse_polyline(x, y, a, b, angle, step: float = 0.1):
    """Vertices of the rotated ellipse the reference plots
    (``plot_ellipse``, ``:44-75``). Returns [N, 2]."""
    t = np.arange(0.0, 2.0 * np.pi + step, step)
    p = np.stack([a * np.cos(t), b * np.sin(t)])
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    xy = R @ p
    return np.stack([xy[0] + x, xy[1] + y], axis=1)


def covariance_ellipse_polyline(x, y, cov, chi2: float = 3.0,
                                step: float = 0.1):
    """Composition used by the reference demos: covariance -> polyline."""
    e = covariance_ellipse_2d(cov, chi2)
    return ellipse_polyline(x, y, e["a"], e["b"], e["angle_rad"], step)


def arrow_polyline(x, y, yaw, length: float = 1.0,
                   head_width: float = 0.1):
    """Pose-arrow vertices (``plot_arrow``, ``:78-120``): a shaft from
    (x, y) along yaw plus a two-segment head. Returns [5, 2] (shaft start,
    tip, head left, tip, head right)."""
    tip = np.array([x + length * np.cos(yaw), y + length * np.sin(yaw)])
    base = np.array([x, y])
    back = tip - head_width * 2.0 * np.array([np.cos(yaw), np.sin(yaw)])
    left = back + head_width * np.array([-np.sin(yaw), np.cos(yaw)])
    right = back - head_width * np.array([-np.sin(yaw), np.cos(yaw)])
    return np.stack([base, tip, left, tip, right])
