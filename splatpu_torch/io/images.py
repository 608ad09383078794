"""Image files: read and write through PIL where it is installed, else
through a small PNG codec of this module's own (stdlib ``zlib`` and numpy).

The codec reads 8-bit greyscale and RGB PNGs (colour types 0 and 2),
without interlacing, under any of the five scanline filters (None, Sub,
Up, Average, Paeth); it writes them with filter None.  That is what the
sequence layout and the frame export need: JPEG images come only from a
capture, and reading one without PIL raises ``ImportError`` naming PIL.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS_OF_COLOR_TYPE = {0: 1, 2: 3}  # greyscale, RGB


def have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes (filter None, zlib level 6)."""
    a = np.ascontiguousarray(image)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"PNG writes (H, W) or (H, W, 3) uint8, got {a.shape} {a.dtype}")
    h, w = a.shape[:2]
    color_type = 0 if a.ndim == 2 else 2
    rows = a.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def _paeth_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Paeth reconstruction, byte by byte (each depends on the one to its
    left)."""
    out = bytearray(len(filt))
    f, b = filt.tobytes(), prior.tobytes()
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        c = b[i - bpp] if i >= bpp else 0
        p = a + b[i] - c
        pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        out[i] = (f[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(filt: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(filt))
    f, b = filt.tobytes(), prior.tobytes()
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (f[i] + ((a + b[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, 3) uint8."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in CHANNELS_OF_COLOR_TYPE or interlace:
        raise ValueError(f"the PNG codec reads 8-bit grey or RGB without interlace, got depth"
                         f" {depth}, colour type {color_type}, interlace {interlace}")
    bpp = CHANNELS_OF_COLOR_TYPE[color_type]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, filt = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = filt
        elif kind == 1:  # Sub: a running sum per channel
            row = np.cumsum(filt.reshape(w, bpp), axis=0, dtype=np.uint64).astype(np.uint8)
            row = row.reshape(-1)
        elif kind == 2:  # Up
            row = (filt.astype(np.uint16) + prior).astype(np.uint8)
        elif kind == 3:
            row = _average_row(filt, prior, bpp)
        elif kind == 4:
            row = _paeth_row(filt, prior, bpp)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prior = row
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def read_image(path) -> np.ndarray:
    """An image file as a uint8 array, (H, W) or (H, W, 3): through PIL
    where it is installed (what ``np.asarray(Image.open(path))`` gives),
    else a PNG through this module's codec."""
    path = Path(path)
    if have_pil():
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im)
    if path.suffix.lower() != ".png":
        raise ImportError(f"reading {path.name} needs PIL (Pillow): only PNG is read without it")
    return decode_png(path.read_bytes())


def write_png(path, image: np.ndarray) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(image))
