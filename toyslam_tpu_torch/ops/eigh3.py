"""Batched symmetric 3x3 eigendecomposition by cyclic Jacobi rotations
(port of ``toyslam_tpu/ops/eigh3.py``).

Five branch-free sweeps over the (0,1), (0,2), (1,2) pairs on component
tensors, then an ascending sort by a 3-element network. Kept as the JAX
package's algorithm (not ``torch.linalg.eigh``) so that the NDT map's
eigenvalue inflation sees the same eigenpairs. ``eigh3_soa`` takes the six
components (the map build's layout); ``eigh3`` is its ``[..., 3, 3]`` form.

``eigh3_soa`` takes CPU tensors to ``eigh3_soa_plain`` and CUDA tensors to
one launch of the hand-written kernel of ``ops/eigh3_kernels``, which gives
the plain version's bits there; there is no fallback.
"""

from __future__ import annotations

import torch

from toyslam_tpu_torch.ops import _cuda, eigh3_kernels


def _rot_coeffs(app, aqq, apq):
    """Stable Jacobi rotation (c, s) zeroing the (p, q) entry."""
    one = torch.ones_like(apq)
    zero = torch.zeros_like(apq)
    tau = (aqq - app) / (2.0 * torch.where(apq == 0, one, apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(apq == 0, zero, torch.where(tau == 0, one, t))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def eigh3_soa(a00, a01, a02, a11, a12, a22, sweeps: int = 5):
    """Eigenpairs of symmetric 3x3 matrices given as six component tensors.

    Returns (evals: 3-tuple ascending, evecs: 9-tuple row-major
    ``v[i][j]`` = component i of eigenvector j).
    """
    if _cuda.on_cpu("eigh3", a00, a01, a02, a11, a12, a22):
        return eigh3_soa_plain(a00, a01, a02, a11, a12, a22, sweeps)
    return eigh3_kernels.eigh3_soa_cuda(a00, a01, a02, a11, a12, a22, sweeps)


def eigh3_soa_plain(a00, a01, a02, a11, a12, a22, sweeps: int = 5):
    """``eigh3_soa`` in PyTorch ops, on any device and float dtype."""
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    scale = torch.stack([a.abs() for a in (a00, a11, a22, a01, a02, a12)]
                        ).amax(0).clamp(min=1e-30)
    A = [[a00 / scale, a01 / scale, a02 / scale],
         [a01 / scale, a11 / scale, a12 / scale],
         [a02 / scale, a12 / scale, a22 / scale]]
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            c, s = _rot_coeffs(A[p][p], A[q][q], A[p][q])
            r = 3 - p - q  # the untouched index
            app = c * c * A[p][p] - 2.0 * s * c * A[p][q] + s * s * A[q][q]
            aqq = s * s * A[p][p] + 2.0 * s * c * A[p][q] + c * c * A[q][q]
            arp = c * A[r][p] - s * A[r][q]
            arq = s * A[r][p] + c * A[r][q]
            A[p][p], A[q][q] = app, aqq
            A[p][q] = A[q][p] = zero
            A[r][p] = A[p][r] = arp
            A[r][q] = A[q][r] = arq
            for i in range(3):
                vip = c * V[i][p] - s * V[i][q]
                viq = s * V[i][p] + c * V[i][q]
                V[i][p], V[i][q] = vip, viq

    evals = [A[0][0] * scale, A[1][1] * scale, A[2][2] * scale]

    def cswap(i, j):
        swap = evals[i] > evals[j]
        evals[i], evals[j] = (torch.where(swap, evals[j], evals[i]),
                              torch.where(swap, evals[i], evals[j]))
        for r_ in range(3):
            V[r_][i], V[r_][j] = (torch.where(swap, V[r_][j], V[r_][i]),
                                  torch.where(swap, V[r_][i], V[r_][j]))

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)
    return tuple(evals), tuple(V[i][j] for i in range(3) for j in range(3))


def eigh3(A, sweeps: int = 5):
    """Symmetric ``A [..., 3, 3]`` -> ``(evals [..., 3] ascending, evecs
    [..., 3, 3])`` with the eigenvectors as columns, by ``eigh3_soa``."""
    evals, evecs = eigh3_soa(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                             A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
                             sweeps=sweeps)
    return (torch.stack(evals, -1),
            torch.stack(evecs, -1).unflatten(-1, (3, 3)))
