"""Inputs for the checks of the eigensolver ``ops/eigh3.eigh3_soa``, shared
by its CPU tests, its card tests and ``chip_smoke.py``.

``matrices(n, dtype, device)`` gives ``n`` symmetric 3x3 matrices
``[n, 3, 3]``: first the cases where the solver's branch-free selections
and NaN rules decide the bits (``EDGE``: zero and diagonal matrices,
``app == aqq``, repeated eigenvalues, entries near 1e18 and 1e36 as
LOAM's sentinel neighbours give, magnitudes below the 1e-30 scale floor,
signed zeros, NaN and inf), then, from ``seed``, scatter matrices of 5
points at scales from 1e-3 to 1e3 and symmetric matrices with signed
entries. ``components(a)`` and ``map_components(a, b)`` give the six
components as the callers pass them.
"""

from __future__ import annotations

import numpy as np
import torch

_NAN, _INF = float("nan"), float("inf")
# Upper triangles (00, 01, 02, 11, 12, 22).
EDGE = (
    (0, 0, 0, 0, 0, 0),  # zero: scale at its floor, every apq == 0
    (3, 0, 0, 1, 0, 2),  # diagonal
    (2, 0, 0, 2, 0, 2),  # a repeated eigenvalue, diagonal
    (1, 0.5, 0, 1, 0, 1),  # app == aqq: tau == 0
    (2, 1, 1, 2, 1, 2),  # eigenvalues (1, 1, 4)
    (1, 1, 1, 1, 1, 1),  # rank 1, a double zero eigenvalue
    (-3, 0.5, 0.25, -2, 0.125, -1),  # negative definite
    (1, -0.0, 0.0, 1, -0.0, 2),  # signed zeros off the diagonal
    (1e18, 3e17, -2e17, 9e17, 1e17, 5e17),  # near LOAM's 1e18 sentinel
    (1e36, 1e18, 1e18, 1e36, 1e18, 1e36),  # squares of sentinel points
    (4e-35, 1e-35, -2e-35, 3e-35, 0, 1e-35),  # below the 1e-30 floor
    (1e-40, 1e-41, 0, 3e-40, 0, 2e-40),  # f32 subnormals
    (1, _NAN, 0, 1, 0, 1),
    (_NAN, 0, 0, 0, 0, 0),
    (_INF, 0.5, 0, 1, 0, 1),
    (1, 0.5, 0, 1, -_INF, 1),
    (_INF, _INF, _INF, _INF, _INF, _INF),
)
_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]  # upper-triangle entry of M[i, j]


def matrices(n, dtype, device, seed=0):
    """``[n, 3, 3]`` symmetric matrices: ``EDGE`` first (cut at ``n``),
    then generated ones."""
    rng = np.random.default_rng(seed)
    m = max(n - len(EDGE), 0)
    pts = rng.normal(size=(m, 5, 3)) * 10.0 ** rng.uniform(-3, 3, (m, 1, 1))
    c = pts - pts.mean(1, keepdims=True)
    scatter = np.einsum("nki,nkj->nij", c, c)
    signed = rng.normal(size=(m, 3, 3)) * 10.0 ** rng.uniform(-3, 3, (m, 1, 1))
    signed = signed + signed.transpose(0, 2, 1)
    gen = np.where((np.arange(m) % 2 == 0)[:, None, None], scatter, signed)
    edge = np.array(EDGE, dtype=np.float64)[:, _SYM].reshape(-1, 3, 3)
    return torch.from_numpy(np.concatenate([edge, gen])[:n]).to(device, dtype)


def components(a):
    """The six components of ``a [..., 3, 3]`` as the callers pass them:
    strided views, stride 9 for a contiguous ``[N, 3, 3]``."""
    return (a[..., 0, 0], a[..., 0, 1], a[..., 0, 2], a[..., 1, 1],
            a[..., 1, 2], a[..., 2, 2])


def map_components(a, b):
    """The six components of ``a [N, 3, 3]`` as the NDT map build passes
    them: ``unbind(-1)`` of a ``[b, N / b, 6]`` tensor, views at stride
    6."""
    return torch.stack(components(a), -1).reshape(b, -1, 6).unbind(-1)
