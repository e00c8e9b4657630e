"""ctypes bindings to the port's host library (``csrc/host/*.c``).

The C sources are the port's own copies of the reference's host runtime:
LZF and LZ4-frame decoding, a pthread pool that parses and packs many PCD
files at once (``scanpack.c``, whose header parser is thread-safe), and a
one-pass ROS1 bag reader that packs every PointCloud2 of a topic straight
into the padded scan stack (``bagpack.c``).

``build`` compiles them with ``gcc -O3 -fPIC -pthread -shared`` at first
use into ``toyslam_tpu_torch/_build/``, under a name keyed by the hash of
the sources and the flags, as ``ops/_cuda.py`` names the kernels'
libraries. A failed build raises with the compiler's output, and every
entry point here raises on bad input or a failed file: nothing falls back
to Python. The pure-Python routes run only where a caller asks for them
(``native=False`` in ``core/pcd_io``, ``runtime/loader`` and
``runtime/rosbag``). ctypes releases the GIL during a call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
HOST_SRC = _PKG / "csrc" / "host"
SOURCES = tuple(HOST_SRC / name for name in ("pcdio.c", "scanpack.c",
                                             "bagpack.c"))
BUILD_DIR = _PKG / "_build"
CFLAGS = ["-O3", "-fPIC", "-pthread", "-shared", "-Wall"]
LIBS = ["-ldl"]
_lib = None
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_long)
_SIGNATURES = {
    "lzf_decompress": [ctypes.c_char_p, ctypes.c_long, _u8p, ctypes.c_long],
    "lz4f_decompress": [ctypes.c_char_p, ctypes.c_long, _u8p,
                        ctypes.c_long],
    "extract_xyzi": [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                     ctypes.c_long, ctypes.c_long, ctypes.c_long,
                     ctypes.c_long, _f32p],
    "pack_scans": [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                   ctypes.c_long, ctypes.c_long, _f32p, _u8p, _i64p],
    # The bag is passed as bytes, zero-copy (the C side only reads it); the
    # out pointers take None for the count-only pass.
    "bag_pack_scans": [ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                       ctypes.c_long, ctypes.c_long, _f32p, _u8p, _f64p,
                       _i64p],
    "host_bz2_available": [],
}
# bag_pack_scans' error codes.
_BAG_ERRORS = {
    -1: "malformed ROS bag",
    -2: "unsupported chunk compression",
    -3: "a bz2-compressed chunk, but libbz2 could not be opened "
        "(libbz2.so.1 not found); bz2 chunks cannot be read here",
}


def _compiler() -> str:
    cc = os.environ.get("CC") or "gcc"
    found = shutil.which(cc)
    if found is None:
        raise RuntimeError(f"C compiler {cc!r} not found: the host library "
                           "(csrc/host) cannot be built")
    return found


def library_path() -> Path:
    """Where ``build`` puts the library of the current sources."""
    digest = hashlib.sha256()
    for source in SOURCES:
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    digest.update(" ".join(CFLAGS + LIBS).encode())
    return BUILD_DIR / f"libtoyslam_host_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library if it is missing; returns its path. Raises
    with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.run(
        [_compiler(), *CFLAGS, "-o", str(tmp), *map(str, SOURCES), *LIBS],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host library failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds race harmlessly
    return lib


def load() -> ctypes.CDLL:
    """Build the library if needed and open it (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_long
            _lib = lib
    return _lib


def bz2_available() -> bool:
    """True when the C bag reader can decode bz2 chunks (libbz2 opened)."""
    return bool(load().host_bz2_available())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def lzf_decompress(src: bytes, expected_len: int) -> bytes:
    """LZF decompression (PCL binary_compressed payloads); raises
    ``ValueError`` on a corrupt stream."""
    out = np.empty(max(expected_len, 1), np.uint8)
    n = load().lzf_decompress(src, len(src), _ptr(out, _u8p), expected_len)
    if n < 0:
        raise ValueError("corrupt LZF stream")
    return out[:n].tobytes()


def lz4f_decompress(src: bytes, capacity: int) -> bytes:
    """LZ4-frame decoding (``bagpack.c``), byte-identical to
    ``runtime/lz4f.decompress``; ``capacity`` bounds the decoded size.
    Raises ``ValueError`` on a malformed frame or an overflow."""
    out = np.empty(max(capacity, 1), np.uint8)
    n = load().lz4f_decompress(src, len(src), _ptr(out, _u8p), capacity)
    if n < 0:
        raise ValueError("corrupt LZ4 frame")
    return out[:n].tobytes()


def extract_xyzi(data: bytes, n_points: int, record_size: int,
                 x_off: int, y_off: int, z_off: int, i_off: int):
    """Interleaved point records -> float32 [n, 4] x, y, z, intensity
    (``i_off`` < 0 fills 0)."""
    if len(data) < n_points * record_size:
        raise ValueError(f"{len(data)} bytes hold fewer than {n_points} "
                         f"records of {record_size}")
    out = np.empty((n_points, 4), np.float32)
    load().extract_xyzi(data, n_points, record_size, x_off, y_off, z_off,
                        i_off, _ptr(out, _f32p))
    return out


def _bag_check(n: int) -> int:
    if n < 0:
        raise ValueError(f"{_BAG_ERRORS.get(n, 'ROS bag error')} "
                         f"(code {n})")
    return int(n)


def bag_pack_scans(buf: bytes, topic: str, max_scans: int, capacity: int):
    """One-pass ROS bag parse into the packed layout: every PointCloud2 on
    ``topic`` (none/bz2/lz4 chunks) into xyzi [max_scans, capacity, 4] f32
    and mask [max_scans, capacity]. Returns (xyzi, mask, times [S] f64,
    counts [S] i64, n_scans). Raises ``ValueError`` on a malformed bag, an
    unknown compression, or a bz2 chunk without libbz2."""
    xyzi = np.empty((max_scans, capacity, 4), np.float32)
    mask = np.zeros((max_scans, capacity), np.uint8)
    times = np.zeros((max_scans,), np.float64)
    counts = np.zeros((max_scans,), np.int64)
    n = _bag_check(load().bag_pack_scans(
        buf, len(buf), topic.encode(), max_scans, capacity,
        _ptr(xyzi, _f32p), _ptr(mask, _u8p), _ptr(times, _f64p),
        _ptr(counts, _i64p)))
    return xyzi, mask.view(bool), times, counts, n


def bag_count_scans(buf: bytes, topic: str) -> int:
    """The PointCloud2 messages on ``topic`` (framing and connection
    filtering, no cloud decode; a compressed chunk is still decompressed),
    to size ``bag_pack_scans``' buffers. Raises
    ``ValueError`` on a malformed bag."""
    return _bag_check(load().bag_pack_scans(
        buf, len(buf), topic.encode(), 1 << 62, 0, None, None, None, None))


def pack_scans(paths, capacity: int, n_threads: int | None = None,
               out=None):
    """Parse and pack many PCD files on a pthread pool into (xyzi [S,
    capacity, 4] f32, mask [S, capacity] bool); ``out`` may give those two
    arrays (C-contiguous) to write into. Raises ``ValueError`` naming every
    file that failed."""
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    paths = [str(p) for p in paths]
    S = len(paths)
    if out is None:
        xyzi = np.empty((S, capacity, 4), np.float32)
        mask = np.zeros((S, capacity), bool)
    else:
        xyzi, mask = out
        if (xyzi.shape != (S, capacity, 4) or xyzi.dtype != np.float32
                or mask.shape != (S, capacity) or mask.dtype != bool
                or not (xyzi.flags.c_contiguous and mask.flags.c_contiguous)):
            raise ValueError("out must be C-contiguous xyzi [S, capacity, 4] "
                             "float32 and mask [S, capacity] bool")
    if S == 0:
        return xyzi, mask
    names = (ctypes.c_char_p * S)(*[p.encode() for p in paths])
    counts = np.zeros((S,), np.int64)
    rc = load().pack_scans(names, S, capacity, n_threads, _ptr(xyzi, _f32p),
                           _ptr(mask.view(np.uint8), _u8p),
                           _ptr(counts, _i64p))
    if rc != 0:
        bad = [p for p, c in zip(paths, counts) if c < 0]
        raise ValueError(f"could not read or parse {len(bad)} PCD file(s): "
                         f"{bad}")
    return xyzi, mask
