"""LZ4 frame codec, pure Python (the port's copy of
``toyslam_tpu/runtime/lz4f.py``).

ROS bags are commonly written with lz4-compressed chunks (rosbag's
``roslz4`` emits the standard LZ4 Frame format, magic ``0x184D2204``);
the reference replays such bags through the rosbag API
(``ndt_rosbag_mapping_node.cpp:36-47``), which links roslz4. This module
gives ``runtime/rosbag.py`` that capability without a binary dependency: a
full frame *decoder* (any writer: independent or dependent blocks, stored
blocks, optional content size / dict id / checksums; the header checksum
is verified, block and content xxh32s are skipped) and the greedy frame
*encoder* the bag writer uses. The encoder gives the JAX package's bytes
for the same input, so a bag written by either package is byte-equal.

The C decoder of ``csrc/host/bagpack.c`` (``runtime/native.
lz4f_decompress``) decodes the same frames to the same bytes.

Block format: every LZ4 block is a list of sequences ``[token |
literal-length ext | literals | offset u16 LE | match-length ext]``; the
match length is ``(token & 15) + 4``; the final sequence is literals
only. Length nibbles of 15 extend with 255-continued bytes.
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204
_SKIP_MAGIC_LO = 0x184D2A50  # skippable frames 0x184D2A50..5F


class LZ4Error(ValueError):
    pass


# ---------------------------------------------------------------------------
# Block decode
# ---------------------------------------------------------------------------


def _decode_block(src: bytes, out: bytearray) -> None:
    """Decode one LZ4 block, appending to ``out``.

    Matches may reference bytes already in ``out`` (including previous
    blocks' output, which is how block-dependent frames work), so the
    caller decodes every block of a frame into one growing buffer.
    """
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise LZ4Error("truncated literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise LZ4Error("literal run past block end")
        out += src[i:i + lit]
        i += lit
        if i == n:
            break  # final sequence: literals only
        if i + 2 > n:
            raise LZ4Error("truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise LZ4Error("invalid match offset 0")
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                if i >= n:
                    raise LZ4Error("truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise LZ4Error("match offset before output start")
        if offset >= mlen:
            out += out[start:start + mlen]
        else:
            # Overlapping match: the output repeats with period `offset`.
            pattern = bytes(out[start:start + offset])
            reps = mlen // offset + 1
            out += (pattern * reps)[:mlen]


# ---------------------------------------------------------------------------
# Frame decode
# ---------------------------------------------------------------------------


def decompress(data: bytes) -> bytes:
    """Decode all LZ4 frames in ``data`` (skippable frames skipped)."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise LZ4Error("truncated frame magic")
        (magic,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if _SKIP_MAGIC_LO <= magic <= _SKIP_MAGIC_LO + 15:
            if pos + 4 > n:
                raise LZ4Error("truncated skippable frame")
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4 + size
            continue
        if magic != _MAGIC:
            raise LZ4Error(f"bad LZ4 frame magic {magic:#x}")
        if pos + 2 > n:
            raise LZ4Error("truncated frame descriptor")
        desc_start = pos
        flg = data[pos]
        pos += 2  # FLG + BD
        if flg >> 6 != 1:
            raise LZ4Error(f"unsupported LZ4 frame version {flg >> 6}")
        b_checksum = (flg >> 4) & 1
        c_size = (flg >> 3) & 1
        c_checksum = (flg >> 2) & 1
        dict_id = flg & 1
        if c_size:
            pos += 8
        if dict_id:
            pos += 4
        if pos + 1 > n:
            raise LZ4Error("truncated frame header")
        hc = data[pos]
        expect = (_xxh32(data[desc_start:pos]) >> 8) & 0xFF
        if hc != expect:
            raise LZ4Error("LZ4 frame header checksum mismatch")
        pos += 1
        while True:
            if pos + 4 > n:
                raise LZ4Error("truncated block size")
            (bsize,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if bsize == 0:
                break  # EndMark
            stored = bsize >> 31
            bsize &= 0x7FFFFFFF
            if pos + bsize > n:
                raise LZ4Error("block past end of input")
            block = data[pos:pos + bsize]
            pos += bsize
            if stored:
                out += block
            else:
                _decode_block(block, out)
            if b_checksum:
                pos += 4  # xxh32, skipped
        if c_checksum:
            pos += 4  # xxh32, skipped
    return bytes(out)


# ---------------------------------------------------------------------------
# Greedy encoder
# ---------------------------------------------------------------------------

# Spec constraints: the last 5 bytes of a block are always literals, and
# no match may start within the last 12 bytes.
_MFLIMIT = 12
_LASTLITERALS = 5


def _emit_len(dst: bytearray, v: int) -> None:
    while v >= 255:
        dst.append(255)
        v -= 255
    dst.append(v)


def _compress_block(src: bytes) -> bytes:
    """Greedy hash-chainless LZ4 block compressor (one candidate per
    4-byte key, last writer wins). Valid output, modest ratio."""
    n = len(src)
    dst = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - _MFLIMIT
    while i < limit:
        key = src[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 0xFFFF:
            mlen = 4
            maxm = (n - _LASTLITERALS) - i
            while mlen < maxm and src[j + mlen] == src[i + mlen]:
                mlen += 1
            lit = i - anchor
            token = (min(lit, 15) << 4) | min(mlen - 4, 15)
            dst.append(token)
            if lit >= 15:
                _emit_len(dst, lit - 15)
            dst += src[anchor:i]
            dst += struct.pack("<H", i - j)
            if mlen - 4 >= 15:
                _emit_len(dst, mlen - 4 - 15)
            i += mlen
            anchor = i
        else:
            i += 1
    lit = n - anchor
    dst.append(min(lit, 15) << 4)
    if lit >= 15:
        _emit_len(dst, lit - 15)
    dst += src[anchor:]
    return bytes(dst)


def _xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (the checksum the LZ4 frame format uses)."""
    P1, P2, P3 = 2654435761, 2246822519, 3266489917
    P4, P5, M = 668265263, 374761393, 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v1, v2 = (seed + P1 + P2) & M, (seed + P2) & M
        v3, v4 = seed & M, (seed - P1) & M
        while i + 16 <= n:
            for k, v in enumerate((v1, v2, v3, v4)):
                (w,) = struct.unpack_from("<I", data, i + 4 * k)
                v = (rotl((v + w * P2) & M, 13) * P1) & M
                if k == 0:
                    v1 = v
                elif k == 1:
                    v2 = v
                elif k == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 4 <= n:
        (w,) = struct.unpack_from("<I", data, i)
        h = (rotl((h + w * P3) & M, 17) * P4) & M
        i += 4
    while i < n:
        h = (rotl((h + data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def compress(data: bytes, block_size: int = 1 << 16) -> bytes:
    """Encode ``data`` as one LZ4 frame with independent blocks.

    Blocks that don't shrink are stored raw (high bit of the block size),
    like every standard encoder. No block/content checksums (optional in
    the format); the header checksum is the real xxh32 per spec, so
    strict third-party decoders accept the frame.
    """
    out = bytearray()
    out += struct.pack("<I", _MAGIC)
    # FLG: version 01, block independence 1, no checksums/size/dict.
    desc = bytes((0x60, 0x40))  # FLG, BD (block max size id 4: 64 KiB)
    out += desc
    out.append((_xxh32(desc) >> 8) & 0xFF)
    for lo in range(0, len(data), block_size):
        block = data[lo:lo + block_size]
        comp = _compress_block(block)
        if len(comp) < len(block):
            out += struct.pack("<I", len(comp))
            out += comp
        else:
            out += struct.pack("<I", len(block) | 0x80000000)
            out += block
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)
