"""Build, load and launch helpers shared by the port's CUDA kernel modules.

Every ``csrc/*.cu`` source has a plain C interface. ``build`` compiles it
with ``nvcc`` for sm_90a into ``toyslam_tpu_torch/_build/`` at first use,
under a name keyed by the hash of the source, the headers beside it and the
flags, and keeps nvcc's ``-Xptxas -v`` report (registers, shared memory,
spills) beside the library as ``.log``. Given several sources it starts one
``nvcc`` for each missing library, all at once, and waits for every one.
``load`` opens a library with ctypes and declares its entry points, each of
which returns ``cudaGetLastError()`` after its launch. ``grid_sum_buffers``
holds what a launch of a kernel that ends in ``csrc/block_sum.cuh``'s
``grid_sum`` (K1, K3, K6) needs besides its inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# The grid sum's last-block counters of each (device, stream), one a grid
# row: two streams never share one, and each launch leaves its counters
# at 0.
_counters = {}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(source: Path) -> Path:
    """Where ``build`` puts the library of ``source``."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library is missing, in parallel; returns
    the library paths in the order of ``sources``."""
    libs = [_library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for source, lib in todo:
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs.append((lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for lib, tmp, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):"
                              f"\n{err}")
                continue
            lib.with_suffix(".log").write_text(out + err)
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """Build ``source`` if needed and open it; ``signatures`` maps each
    entry point to its ctypes argument types (its result is an int)."""
    lib = ctypes.CDLL(str(build(source)[0]))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def on_cpu(kind: str, *tensors) -> bool:
    """True when every tensor lies on the CPU, False when every one lies on
    one CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no {kind} kernel for device {dev}")
    return False


def check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(fn, *args, device=None):
    """Call the C entry point ``fn`` with each tensor argument passed as its
    device pointer and the current stream of ``device`` (by default the
    tensors' device) appended; raises if the launch failed (``fn`` returns
    ``cudaGetLastError()``)."""
    dev = device or next(a.device for a in args
                         if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        err = fn(*[ctypes.c_void_p(a.data_ptr())
                   if isinstance(a, torch.Tensor) else a for a in args],
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error "
                           f"{err}")


def grid_sum_buffers(device, n_out, slots, blocks, lanes=None):
    """The sums ``out``, the blocks' partial rows and the last-block
    counters of one launch of a ``grid_sum`` kernel with rows of ``slots``
    floats on the current stream. Without ``lanes``: ``out`` [n_out],
    partials [blocks, slots] and one counter; with ``lanes`` = L (a grid of
    (blocks, L)): ``out`` [L, n_out], partials [L, blocks, slots] and L
    counters, one a grid row. ``out`` and the rows share one allocation:
    the kernel writes ``slots`` sums a grid row at ``out``'s rows, and the
    partial rows start 16-byte aligned after them. The counters of a stream
    are zeroed once, grow to the widest launch and are left at 0 by every
    launch."""
    L = 1 if lanes is None else lanes
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counter = _counters.get(key)
    if counter is None or counter.numel() < L:  # a fleet's 64 lanes or more
        counter = _counters[key] = torch.zeros(max(L, 64), dtype=torch.int32,
                                               device=device)
    buf = torch.empty(slots * L * (blocks + 1), dtype=torch.float32,
                      device=device)
    out = buf[:slots * L].view(L, slots)[:, :n_out]
    return (out[0] if lanes is None else out), buf[slots * L:], counter
