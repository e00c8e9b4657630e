"""The launch counts of the port's main-path kernels, K1-K6, the GICP
update and the eigensolver, read and reset together: ``ops/ndt_kernels``
(K1-K3), ``ops/nn_kernels`` (K4, K5), ``ops/gicp_kernels`` (K6,
``gicp_update``) and ``ops/eigh3_kernels`` (``eigh3``) each count a launch
where their wrapper starts the kernel, and nowhere else."""

from __future__ import annotations

from toyslam_tpu_torch.ops import (eigh3_kernels, gicp_kernels, ndt_kernels,
                                   nn_kernels)

_MODULES = (ndt_kernels, nn_kernels, gicp_kernels, eigh3_kernels)


def launches() -> dict:
    """{kernel name: launches since the last reset}."""
    out = {}
    for mod in _MODULES:
        out.update(mod.LAUNCHES)
    return out


def reset_launches():
    for mod in _MODULES:
        mod.reset_launch_counts()
