"""PyTorch + CUDA port of the toyslam_tpu NDT main path.

The JAX package ``toyslam_tpu`` is the reference; every module here keeps
the name of its JAX counterpart. This package imports torch and numpy,
never jax. The NDT derivative kernels are hand-written CUDA C++ for
Hopper (``csrc/ndt_kernels.cu``), built at first use; on CPU tensors the
same entry points run their plain PyTorch versions.
"""
