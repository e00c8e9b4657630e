"""PyTorch + CUDA port of toyslam_tpu: the NDT main path and the pairwise
ICP and GICP aligns.

The JAX package ``toyslam_tpu`` is the reference; every module here keeps
the name of its JAX counterpart. This package imports torch and numpy,
never jax. The Pallas kernels of these paths are hand-written CUDA C++ for
Hopper (``csrc/*.cu``), built at first use; on CPU tensors the same entry
points run their plain PyTorch versions. Tensors the port creates from
host data go to the card unless the caller names another device.
"""
