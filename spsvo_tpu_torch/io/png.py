"""A small PNG codec for what KITTI odometry holds: 8-bit grayscale,
non-interlaced images. Standard library `zlib` plus numpy; no OpenCV.

`read_gray8` decodes all five row filters (None, Sub, Up, Average, Paeth)
and raises for any other colour type, bit depth or interlacing, naming what
the file has. `write_gray8` writes filter 0 (None) rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes, name: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        yield ctype, body
        pos += 12 + length


def _unfilter(ft: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Undo the row filters. ft (H,) filter type per row, F (H, W) filtered
    bytes (one byte per pixel)."""
    h, w = F.shape
    if not ft.any():
        return np.ascontiguousarray(F)
    if ft.max() > 4:
        raise ValueError(f"unknown PNG row filter {int(ft.max())}")
    if ft.max() <= 2:
        # None / Sub / Up rows are whole-row operations (uint8 wraps mod 256)
        out = np.empty_like(F)
        prev = np.zeros(w, np.uint8)
        for r in range(h):
            row = F[r]
            if ft[r] == 1:
                row = np.cumsum(row, dtype=np.uint8)
            elif ft[r] == 2:
                row = row + prev
            out[r] = prev = row
        return out
    # Average and Paeth predict from the pixel to the left, so a row cannot
    # be vectorised along x. An anti-diagonal d = r + c can: left (r, c-1)
    # and up (r-1, c) lie on d-1, up-left (r-1, c-1) on d-2. D[d+2, r+1]
    # holds pixel (r, d-r); row 0, column 0 and unwritten cells stay 0,
    # which is what the filters read outside the image.
    R, C = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    Fs = np.zeros((h + w - 1, h), np.int32)
    Fs[R + C, R] = F
    D = np.zeros((h + w + 1, h + 1), np.int32)
    m_sub, m_up, m_avg, m_paeth = ((ft == k).astype(np.int32)
                                   for k in (1, 2, 3, 4))
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = D[d + 1, lo + 1:hi + 1]
        b = D[d + 1, lo:hi]
        c = D[d, lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = (m_sub[lo:hi] * a + m_up[lo:hi] * b
                + m_avg[lo:hi] * ((a + b) >> 1) + m_paeth[lo:hi] * paeth)
        D[d + 2, lo + 1:hi + 1] = (Fs[d, lo:hi] + pred) & 255
    return D[R + C + 2, R + 1].astype(np.uint8)


def decode_gray8(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) uint8. Raises ValueError for anything but 8-bit
    grayscale, non-interlaced."""
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    ihdr = None
    idat = []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = ihdr
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(
            f"{name}: only 8-bit grayscale non-interlaced PNG is supported "
            f"(this file has colour type {colour}, bit depth {depth}, "
            f"interlace method {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data, expected "
                         f"{h * (w + 1)}")
    rows = raw.reshape(h, w + 1)
    return _unfilter(rows[:, 0], rows[:, 1:])


def encode_gray8(img: np.ndarray) -> bytes:
    """(H, W) uint8 -> PNG bytes, filter 0 on every row, zlib level 1."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a 2-D uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    raw = np.zeros((h, w + 1), np.uint8)
    raw[:, 1:] = img

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def read_gray8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray8(f.read(), path)


def write_gray8(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray8(img))
