"""8-bit RGB PNG files with the standard library alone (zlib + struct), so
the app writes its frames on a machine without PIL.

write_png stores each row with filter byte 0 (none); read_png reads back
exactly that form (non-interlaced 8-bit RGB, filter 0) and checks every
chunk's CRC.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img_u8: np.ndarray) -> None:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG at `path`."""
    img = np.ascontiguousarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, not "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """The [H, W, 3] uint8 image of a PNG that write_png wrote; raises
    ValueError on any other form or a damaged file."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not a non-interlaced 8-bit RGB PNG")
    w, h = header[0], header[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w * 3 + 1):
        raise ValueError(f"{path}: {rows.size} bytes of pixel rows for "
                         f"{w}x{h}")
    rows = rows.reshape(h, w * 3 + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row with a filter other than none")
    return rows[:, 1:].reshape(h, w, 3).copy()
