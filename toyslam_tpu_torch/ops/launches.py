"""The launch counts of the SLAM path's kernels, K1-K6 and the GICP
update, read and reset together: ``ops/ndt_kernels`` (K1-K3),
``ops/nn_kernels`` (K4, K5) and ``ops/gicp_kernels`` (K6, ``gicp_update``)
each count a launch where their wrapper starts the kernel, and nowhere
else."""

from __future__ import annotations

from toyslam_tpu_torch.ops import gicp_kernels, ndt_kernels, nn_kernels

_MODULES = (ndt_kernels, nn_kernels, gicp_kernels)


def launches() -> dict:
    """{kernel name: launches since the last reset}."""
    out = {}
    for mod in _MODULES:
        out.update(mod.LAUNCHES)
    return out


def reset_launches():
    for mod in _MODULES:
        mod.reset_launch_counts()
