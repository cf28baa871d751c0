"""The port's PNG writer: 8-bit gray, RGB and RGBA images with zlib and
struct (every row filter 0, one IDAT chunk). The sequence recorder and the
viewers write every PNG through it; PIL is not needed.

``decode_png`` reads back what ``encode_png`` writes (filter-0 rows,
non-interlaced, 8-bit), so that a caller can check that a written file
holds the array it rendered.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit non-interlaced PNG of a uint8 (H, W), (H, W, 3) or
    (H, W, 4) image: every row filter 0, one IDAT at zlib level 1 (any
    level decodes to the same bytes)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"need uint8, got {img.dtype}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in _COLOR_TYPE:
        raise ValueError(f"need 1, 3 or 4 channels, got {c}")
    raw = np.zeros((h, 1 + w * c), np.uint8)  # column 0: filter type 0
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_png_atomic(path: str, img: np.ndarray):
    """write_png to a temporary name, then rename: a reader polling `path`
    never sees a torn file."""
    tmp = path + ".tmp.png"
    write_png(tmp, img)
    os.replace(tmp, path)


def decode_png(data: bytes) -> np.ndarray:
    """The uint8 (H, W[, C]) image of a PNG as encode_png writes it. Raises
    ValueError on any other layout (interlaced, 16-bit, palette, or rows
    with a filter other than 0)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG layout {hdr}")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError("PNG rows use a filter other than 0")
    img = raw[:, 1:].reshape(h, w, c)
    return img[..., 0] if c == 1 else img
