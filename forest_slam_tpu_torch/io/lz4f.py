"""Pure-Python LZ4 frame codec with xxh32 (the port's copy of io/lz4f.py).

ROS C++ reads and writes lz4-compressed bag chunks natively (roslz4 emits
the standard LZ4 Frame format, magic 0x184D2204), so the bag parser
(io/rosbag.py) takes them too, without the ``lz4`` pip module:

- ``decompress``: the full LZ4 Frame decoder (frame header, data blocks,
  compressed or stored, block and content xxHash32 checksums verified when
  the frame declares them; ``verify_checksums=False`` skips the
  pure-Python hash on trusted data; linked-block frames decode into one
  shared output buffer);
- ``compress``: an LZ4 Frame encoder with a greedy hash-table block
  compressor (valid, interoperable output; the ratio is not optimal).

Checksums are left out on write, and the frame header says so, so standard
decoders (the lz4 CLI, roslz4) read the output. Host-side Python: bag I/O
is the ingestion layer, never on the device path.
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204
_MAX_BLOCK = 4 * 1024 * 1024  # BD block-max 4 MiB (id 7)


def _read_varlen(src: bytes, i: int, base: int) -> tuple[int, int]:
    """LZ4 length extension: add bytes while they read 255."""
    n = base
    if base == 15:
        while True:
            b = src[i]
            i += 1
            n += b
            if b != 255:
                break
    return n, i


def _decompress_block(src: bytes, dst: bytearray) -> None:
    """LZ4 block format into ``dst`` (appended; matches may reference
    bytes already in dst — supports linked-block frames for free)."""
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len, i = _read_varlen(src, i, token >> 4)
        if lit_len:
            dst += src[i : i + lit_len]
            i += lit_len
        if i >= n:
            break  # last sequence: literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("lz4: zero match offset (corrupt block)")
        match_len, i = _read_varlen(src, i, token & 0xF)
        match_len += 4
        start = len(dst) - offset
        if start < 0:
            raise ValueError("lz4: match offset beyond output start")
        if offset >= match_len:
            dst += dst[start : start + match_len]
        else:
            # overlapping match: the pattern repeats with period `offset`
            pattern = dst[start:]
            reps = -(-match_len // offset)
            dst += (bytes(pattern) * reps)[:match_len]


def decompress(data: bytes, verify_checksums: bool = True) -> bytes:
    """Decode one LZ4 frame (trailing bytes after the EndMark ignored).

    Block/content xxHash32 checksums are verified when the frame header
    declares them (frames from this module's ``compress`` declare none,
    so verification costs nothing on our own output). A mismatch raises
    ``ValueError``. ``verify_checksums=False`` skips the pure-Python
    hash for trusted high-volume data.
    """
    if len(data) < 7 or struct.unpack("<I", data[:4])[0] != _MAGIC:
        raise ValueError("lz4: bad frame magic")
    flg = data[4]
    if (flg >> 6) != 1:
        raise ValueError(f"lz4: unsupported frame version {flg >> 6}")
    block_checksum = (flg >> 4) & 1
    content_size = (flg >> 3) & 1
    content_checksum = (flg >> 2) & 1
    dict_id = flg & 1
    i = 6  # magic + FLG + BD
    if content_size:
        i += 8
    if dict_id:
        i += 4
    i += 1  # header-checksum byte (not verified)
    out = bytearray()
    while True:
        if i + 4 > len(data):
            raise ValueError("lz4: truncated frame (no EndMark)")
        bsize = struct.unpack("<I", data[i : i + 4])[0]
        i += 4
        if bsize == 0:
            break  # EndMark
        stored = bsize >> 31
        bsize &= 0x7FFFFFFF
        if bsize > _MAX_BLOCK:
            raise ValueError("lz4: block larger than 4 MiB maximum")
        block = data[i : i + bsize]
        if len(block) != bsize:
            raise ValueError("lz4: truncated block")
        i += bsize
        if block_checksum:
            # xxh32 of the block bytes exactly as stored in the frame
            if i + 4 > len(data):
                raise ValueError("lz4: truncated block checksum")
            want = struct.unpack("<I", data[i : i + 4])[0]
            i += 4
            if verify_checksums and _xxh32(block) != want:
                raise ValueError("lz4: block checksum mismatch")
        if stored:
            out += block
        else:
            _decompress_block(block, out)
    if content_checksum:
        if i + 4 > len(data):
            raise ValueError("lz4: truncated content checksum")
        want = struct.unpack("<I", data[i : i + 4])[0]
        i += 4
        if verify_checksums and _xxh32(bytes(out)) != want:
            raise ValueError("lz4: content checksum mismatch")
    return bytes(out)


def _compress_block(src: bytes) -> bytes:
    """Greedy single-pass LZ4 block compressor (hash table on 4-byte
    prefixes). Emits a valid sequence stream; falls back caller-side to a
    stored block when it doesn't shrink."""
    n = len(src)
    out = bytearray()
    table: dict[int, int] = {}
    anchor = 0  # start of pending literals
    i = 0
    # the last 5 bytes must be literals; last match must start >= 12 bytes
    # from the end (LZ4 block format restrictions)
    limit = n - 12
    while i <= limit:
        key = src[i : i + 4]
        k = int.from_bytes(key, "little")
        cand = table.get(k)
        table[k] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand : cand + 4] == key:
            # extend the match forward (stop 5 bytes short of the end)
            m = i + 4
            c = cand + 4
            stop = n - 5
            while m < stop and src[m] == src[c]:
                m += 1
                c += 1
            lit_len = i - anchor
            match_len = (m - i) - 4  # stored biased by the 4-byte minmatch
            token_lit = 15 if lit_len >= 15 else lit_len
            token_match = 15 if match_len >= 15 else match_len
            out.append((token_lit << 4) | token_match)
            if lit_len >= 15:
                rem = lit_len - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)
            out += src[anchor:i]
            out += struct.pack("<H", i - cand)
            if match_len >= 15:
                rem = match_len - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)
            anchor = m
            i = m
        else:
            i += 1
    # trailing literals
    lit_len = n - anchor
    token_lit = 15 if lit_len >= 15 else lit_len
    out.append(token_lit << 4)
    if lit_len >= 15:
        rem = lit_len - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += src[anchor:]
    return bytes(out)


def compress(data: bytes, block_size: int = 4 * 1024 * 1024) -> bytes:
    """Encode one LZ4 frame: FLG = v01, block-independent, no checksums;
    BD = 4 MiB max block size."""
    out = bytearray(struct.pack("<I", _MAGIC))
    flg = (1 << 6) | (1 << 5)  # version 01, block independence
    bd = 7 << 4  # max block size id 7 = 4 MiB
    out.append(flg)
    out.append(bd)
    # header checksum: (xxh32(FLG..BD) >> 8) & 0xFF — we don't carry
    # xxHash; the lz4 spec's reference decoder only *warns* on HC
    # mismatch, and our own decoder skips it. Use the real value when
    # interop matters: compute over the 2 descriptor bytes.
    out.append(_header_checksum(bytes([flg, bd])))
    for s in range(0, len(data), block_size):
        chunk = data[s : s + block_size]
        comp = _compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp))
            out += comp
        else:  # stored block (high bit set)
            out += struct.pack("<I", len(chunk) | 0x80000000)
            out += chunk
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


def _xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32: frame-header checksum byte + block/content verification."""
    P1, P2, P3, P4, P5 = (
        2654435761, 2246822519, 3266489917, 668265263, 374761393,
    )
    mask = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & mask

    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & mask
        v2 = (seed + P2) & mask
        v3 = seed
        v4 = (seed - P1) & mask
        while i <= n - 16:
            k1, k2, k3, k4 = struct.unpack_from("<IIII", data, i)
            v1 = (rotl((v1 + k1 * P2) & mask, 13) * P1) & mask
            v2 = (rotl((v2 + k2 * P2) & mask, 13) * P1) & mask
            v3 = (rotl((v3 + k3 * P2) & mask, 13) * P1) & mask
            v4 = (rotl((v4 + k4 * P2) & mask, 13) * P1) & mask
            i += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & mask
    else:
        h = (seed + P5) & mask
    h = (h + n) & mask
    while i <= n - 4:
        (k,) = struct.unpack_from("<I", data, i)
        h = (rotl((h + k * P3) & mask, 17) * P4) & mask
        i += 4
    while i < n:
        h = (rotl((h + data[i] * P5) & mask, 11) * P1) & mask
        i += 1
    h ^= h >> 15
    h = (h * P2) & mask
    h ^= h >> 13
    h = (h * P3) & mask
    h ^= h >> 16
    return h


def _header_checksum(descriptor: bytes) -> int:
    return (_xxh32(descriptor) >> 8) & 0xFF
