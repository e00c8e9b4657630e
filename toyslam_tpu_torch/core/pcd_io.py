"""PCD file reader/writer (host side, numpy; a copy of
``toyslam_tpu/core/pcd_io.py``, whose package imports JAX).

Reads the ascii, binary and binary_compressed (LZF) DATA encodings and
writes ascii or binary xyz[i] float32. The LZF decoder here is the
reference's Python one; its native ctypes decoder is not ported.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
             ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def _parse_header(data: bytes):
    header = {}
    offset = 0
    for line in data.split(b"\n"):
        offset += len(line) + 1
        text = line.decode("ascii", errors="replace").strip()
        if text.startswith("#") or not text:
            continue
        key, _, value = text.partition(" ")
        header[key.upper()] = value
        if key.upper() == "DATA":
            break
    return header, offset


def _lzf_decompress(src: bytes, expected: int) -> bytes:
    """LZF decompression of a PCL binary_compressed payload."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < expected:
        ctrl = src[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl + 1 bytes
            run = ctrl + 1
            out += src[i:i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += src[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - src[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt LZF stream: back-reference "
                                 "before start of output")
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    return bytes(out)


def read_pcd(path: str | Path) -> np.ndarray:
    """Read a PCD file -> float32 array [n, 4] (x, y, z, intensity).

    Missing intensity is filled with zeros; non-xyzi fields are dropped.
    """
    raw = Path(path).read_bytes()
    header, offset = _parse_header(raw)
    fields = header["FIELDS"].split()
    sizes = [int(s) for s in header["SIZE"].split()]
    types = header["TYPE"].split()
    counts = [int(c) for c in header.get(
        "COUNT", " ".join(["1"] * len(fields))).split()]
    n_points = int(header["POINTS"])
    data_mode = header["DATA"].lower()

    dtype_fields = []
    for name, size, typ, count in zip(fields, sizes, types, counts):
        base = _TYPE_MAP[(typ, size)]
        for c in range(count):
            fname = name if count == 1 else f"{name}_{c}"
            dtype_fields.append(
                (fname if fname != "_" else f"pad{len(dtype_fields)}", base))
    dtype = np.dtype(dtype_fields)

    if data_mode == "ascii":
        body = raw[offset:].decode("ascii")
        flat = np.array([float(v) for v in re.split(r"\s+", body.strip())])
        cols = flat.reshape(n_points, len(dtype_fields)).T
        rec = {name: cols[k].astype(base)
               for k, (name, base) in enumerate(dtype_fields)}
    elif data_mode == "binary":
        rec = np.frombuffer(raw, dtype=dtype, count=n_points, offset=offset)
    elif data_mode == "binary_compressed":
        if offset + 8 > len(raw):
            raise ValueError("truncated binary_compressed PCD header")
        comp_size, uncomp_size = np.frombuffer(raw, dtype="<u4", count=2,
                                               offset=offset)
        if int(comp_size) > len(raw) - offset - 8:
            raise ValueError("binary_compressed payload exceeds file size")
        payload = _lzf_decompress(raw[offset + 8: offset + 8 + comp_size],
                                 uncomp_size)
        if len(payload) < int(uncomp_size):
            raise ValueError("corrupt LZF stream in binary_compressed PCD")
        # binary_compressed is stored field-major (SoA)
        arrays, pos = {}, 0
        for fname, base in dtype_fields:
            width = np.dtype(base).itemsize
            arrays[fname] = np.frombuffer(payload, dtype=base,
                                          count=n_points, offset=pos)
            pos += width * n_points
        rec = arrays
    else:
        raise ValueError(f"unsupported PCD DATA mode: {data_mode}")

    def col(name):
        if isinstance(rec, dict):
            return rec.get(name)
        return rec[name] if name in (rec.dtype.names or ()) else None

    x, y, z = col("x"), col("y"), col("z")
    inten = col("intensity")
    if inten is None:
        inten = np.zeros_like(x)
    return np.stack([x, y, z, inten], axis=1).astype(np.float32)


def write_pcd(path: str | Path, points: np.ndarray,
              binary: bool = True) -> None:
    """Write an [n, 3] or [n, 4] array as a PCD v0.7 (xyz[i], float32)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    has_i = points.shape[1] >= 4
    fields = "x y z intensity" if has_i else "x y z"
    ncols = 4 if has_i else 3
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {fields}\nSIZE {' '.join(['4'] * ncols)}\n"
        f"TYPE {' '.join(['F'] * ncols)}\nCOUNT {' '.join(['1'] * ncols)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        body = points[:, :ncols]
        if binary:
            f.write(np.ascontiguousarray(body).tobytes())
        else:
            np.savetxt(f, body, fmt="%.8g")
