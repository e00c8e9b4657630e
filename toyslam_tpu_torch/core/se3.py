"""SE(3), SO(3) and Euler-chart primitives (port of
``toyslam_tpu/core/se3.py``).

NDT's 6-vector pose chart is ``p = [tx ty tz roll pitch yaw]`` with
``R = Rx(roll) @ Ry(pitch) @ Rz(yaw)``; ``rot_to_euler_xyz`` follows
Eigen's ``eulerAngles(0, 1, 2)`` branch (first angle in ``[0, pi]``).
``rot_to_quat`` feeds the trajectory writers of ``utils/evalio``; the
Hamilton ``[w, x, y, z]`` quaternion helpers serve the ESKF and the
simulators; ``rot_mat_2d`` and ``angle_mod`` are the 2-D helpers of the
reference's ``ICP/utils/angle.py``. Every function is dtype-generic and
works on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _axis_rot(a, rows):
    """[..., 3, 3] from rows of "c", "s", "-s", "0", "1" over angles a."""
    c, s = torch.cos(a), torch.sin(a)
    pick = {"c": c, "s": s, "-s": -s, "0": torch.zeros_like(a),
            "1": torch.ones_like(a)}
    return torch.stack([torch.stack([pick[k] for k in r], -1) for r in rows],
                       -2)


def rot_x(a):
    """Rotations about x by angles a [...] -> [..., 3, 3]."""
    return _axis_rot(a, (("1", "0", "0"), ("0", "c", "-s"),
                         ("0", "s", "c")))


def rot_y(a):
    """Rotations about y by angles a [...] -> [..., 3, 3]."""
    return _axis_rot(a, (("c", "0", "s"), ("0", "1", "0"),
                         ("-s", "0", "c")))


def rot_z(a):
    """Rotations about z by angles a [...] -> [..., 3, 3]."""
    return _axis_rot(a, (("c", "-s", "0"), ("s", "c", "0"),
                         ("0", "0", "1")))


def rot_mat_2d(angle):
    """2-D rotations [..., 2, 2] of angles [...]: a tensor gives a tensor,
    anything else (the numpy geometry of ``utils/plotio``) a numpy
    array."""
    if isinstance(angle, torch.Tensor):
        c, s = torch.cos(angle), torch.sin(angle)
        return torch.stack([torch.stack([c, -s], -1),
                            torch.stack([s, c], -1)], -2)
    c, s = np.cos(angle), np.sin(angle)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


def angle_mod(x, zero_2_2pi=False, degree=False):
    """Angles x (a tensor) wrapped to [-pi, pi), or [0, 2 pi) with
    ``zero_2_2pi``; in degrees with ``degree``. The [0, 2 pi) branch keeps
    the JAX package's two float edges: a negative denormal, which the
    remainder passes through, clamps to 0, and a tiny negative x, whose
    remainder rounds to 2 pi, wraps to 0."""
    if degree:
        x = torch.deg2rad(x)
    if zero_2_2pi:
        y = torch.clamp(torch.remainder(x, 2.0 * math.pi), min=0.0)
        y = torch.where(y >= 2.0 * math.pi, torch.zeros_like(y), y)
    else:
        y = torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi
    if degree:
        y = torch.rad2deg(y)
    return y


def euler_xyz_to_rot(rpy):
    """R = Rx(roll) @ Ry(pitch) @ Rz(yaw); rpy: [..., 3] -> [..., 3, 3]."""
    cx, sx = torch.cos(rpy[..., 0]), torch.sin(rpy[..., 0])
    cy, sy = torch.cos(rpy[..., 1]), torch.sin(rpy[..., 1])
    cz, sz = torch.cos(rpy[..., 2]), torch.sin(rpy[..., 2])
    rows = [
        [cy * cz, -cy * sz, sy],
        [cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy],
        [sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_to_euler_xyz(R):
    """Inverse of :func:`euler_xyz_to_rot` on Eigen's eulerAngles(0,1,2)
    branch."""
    r0 = torch.atan2(R[..., 1, 2], R[..., 2, 2])
    c2 = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 0, 1] ** 2)
    flip = r0 > 0  # "!odd && res[0] > 0" branch of Eigen
    r0_f = torch.where(flip, r0 - math.pi, r0 + math.pi)
    r1_f = torch.atan2(-R[..., 0, 2], -c2)
    r1 = torch.atan2(-R[..., 0, 2], c2)
    a0 = torch.where(flip, r0_f, r0)
    a1 = torch.where(flip, r1_f, r1)
    s1, c1 = torch.sin(a0), torch.cos(a0)
    a2 = torch.atan2(s1 * R[..., 2, 0] - c1 * R[..., 1, 0],
                     c1 * R[..., 1, 1] - s1 * R[..., 2, 1])
    return -torch.stack([a0, a1, a2], -1)


def skew(v):
    """Skew-symmetric matrix [v]x; v: [..., 3] -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zz = torch.zeros_like(x)
    rows = [[zz, -z, y], [z, zz, -x], [-y, x, zz]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def so3_exp(w):
    """Rodrigues exponential map; w: [..., 3] -> [..., 3, 3]. Below 1e-7
    rad the Taylor terms replace sin/theta and (1 - cos)/theta^2."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    small = theta < 1e-7
    K = skew(w)
    safe = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - theta**2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - theta**2 / 24.0,
                    (1.0 - torch.cos(safe)) / safe**2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def make_transform(R, t):
    """Assemble [..., 4, 4] from [..., 3, 3] rotation and [..., 3]
    translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], -1)
    # Made on R's device: writing a Python 1.0 into a CUDA tensor would be
    # a host-to-device copy that waits on the device.
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(batch + (1, 4))], -2)


def pose6_to_matrix(p):
    """NDT chart: p = [t(3), roll, pitch, yaw] -> 4x4."""
    return make_transform(euler_xyz_to_rot(p[..., 3:6]), p[..., 0:3])


def matrix_to_pose6(T):
    """Inverse of :func:`pose6_to_matrix`."""
    return torch.cat([T[..., :3, 3], rot_to_euler_xyz(T[..., :3, :3])], -1)


def svd_solve(A, b, rcond_factor=None):
    """Least-squares solve of ``A x = b`` through the SVD, with singular
    values below ``rcond_factor * max_sv`` treated as zero (Eigen
    JacobiSVD-style thresholding of the reference Newton step);
    ``rcond_factor`` defaults to ``eps * n``."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    if rcond_factor is None:
        rcond_factor = torch.finfo(A.dtype).eps * A.shape[-1]
    cutoff = rcond_factor * s.amax(-1, keepdim=True)
    keep = s > cutoff
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    ub = (u * b[..., :, None]).sum(-2)  # u^T b
    return (vt * (s_inv * ub)[..., :, None]).sum(-2)  # vt^T (s_inv * u^T b)


def rot_to_quat(R):
    """Rotation [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z) by
    Shepperd's method, branch-free: all four candidates, the one of the
    largest diagonal term kept (the first on a tie), then normalised."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                      1.0 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-30)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0)], -1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                     (m02 + m20) / (4 * x1)], -1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                     (m12 + m21) / (4 * y2)], -1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                     (m12 + m21) / (4 * z3), z3], -1),
    ], -2)
    idx = torch.argmax(qw, dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(
        idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_log(R):
    """Log map; R: [..., 3, 3] -> [..., 3]. Where sin(theta) < 1e-7 (near 0
    and near pi) the scale is the Taylor term 1/2 + theta^2/12, as in the
    JAX package."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = torch.sin(theta)
    small = torch.abs(sin_t) < 1e-7
    scale = torch.where(small, 0.5 + theta**2 / 12.0,
                        theta / torch.where(small, torch.ones_like(sin_t),
                                            2.0 * sin_t))
    return w * scale[..., None]


def transform_inverse(T):
    """Inverse of [..., 4, 4] rigid transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def transform_points(T, pts):
    """Apply [..., 4, 4] to points [..., N, 3]; a fourth column (intensity)
    is carried through."""
    out = pts[..., :3] @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    if pts.shape[-1] == 4:
        out = torch.cat([out, pts[..., 3:4]], -1)
    return out


# Quaternions: Hamilton convention, [w, x, y, z].


def quat_identity(dtype=torch.float32, device="cuda"):
    """[1, 0, 0, 0], made on ``device`` (no host copy)."""
    return torch.eye(4, dtype=dtype, device=device)[0]


def quat_multiply(q, r):
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q):
    """Rotation [..., 3, 3] of (not necessarily unit) quaternions."""
    w, x, y, z = q.unbind(-1)
    # s = 2 / n, bit for bit (doubling is exact): without an operation
    # between a tensor and a Python number, which torch.func differentiates
    # through a slow decomposition (and, for a 0-d value, in float64).
    inv = torch.reciprocal(w * w + x * x + y * y + z * z)
    s = inv + inv
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)


def quat_boxplus(q, dtheta):
    """q [+] dtheta with the small-angle right-multiplied delta quaternion
    dq = [1, dtheta / 2], renormalised. It multiplies by 2 dq = [2, dtheta]
    instead, which gives the same bits (doubling is exact and the norm
    cancels it) with no operation between a tensor and a Python number
    (see :func:`quat_to_rot`)."""
    two = torch.full_like(dtheta[..., :1], 2.0)
    return quat_normalize(quat_multiply(q, torch.cat([two, dtheta], -1)))


def quat_rotate(q, v):
    """Rotate vectors [..., 3] by quaternions [..., 4]."""
    return (quat_to_rot(q) @ v[..., None])[..., 0]


def quat_from_axis_angle(axis, angle):
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], -1)


def quat_slerp(q0, q1, t):
    """Spherical interpolation along the shorter arc; below sin(theta) 1e-6
    it is linear."""
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    theta = torch.arccos(torch.clamp(d.abs(), -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-6
    safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def inv3(M):
    """Inverse of 3x3 matrices ``[..., 3, 3]`` by the adjugate: the columns
    are the cross products of the rows over the determinant. Unlike
    ``torch.linalg.inv`` it never checks for singularity on the host, so
    it adds no device synchronisation (a singular matrix gives inf/NaN)."""
    r0, r1, r2 = M.unbind(-2)
    adj = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], -1)
    det = (r0 * adj[..., :, 0]).sum(-1)
    return adj / det[..., None, None]
