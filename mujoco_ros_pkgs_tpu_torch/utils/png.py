"""PNG in the standard library (zlib): rendered frames out, height fields in.

Copied from mujoco_ros_pkgs_tpu/utils/png.py, which the port does not
import. `encode` / `write` give that module's bytes exactly (filter type 0
on every row, `zlib.compress(..., 6)`): camera frames, screenshots and the
watch view (the reference writes its screenshots with lodepng,
viewer.cpp:2231-2245). `decode` is widened to every filter type (none,
sub, up, average, Paeth) so that PNGs written by other tools load.
Non-interlaced 8- and 16-bit gray, RGB and RGBA images decode;
`luminance` reduces one to gray as PIL's convert("L") does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"

# PNG color types
_GRAY = 0
_RGB = 2
_RGBA = 6


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """An image array as PNG bytes:

    - (H, W, 3) uint8, or float scaled by 255 and clipped -> RGB8;
    - (H, W, 4) uint8 or float                          -> RGBA8;
    - (H, W) uint8                                      -> GRAY8;
    - (H, W) uint16, or float (metres: x 1000 to millimetres, clipped)
                                                        -> GRAY16.
    """
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        if img.dtype != np.uint8:
            img = np.clip(np.nan_to_num(np.asarray(img, np.float64)) * 255.0,
                          0, 255).astype(np.uint8)
        color, depth = (_RGB if img.shape[2] == 3 else _RGBA), 8
    elif img.ndim == 2:
        if img.dtype == np.uint8:
            color, depth = _GRAY, 8
        else:
            if img.dtype != np.uint16:
                img = np.clip(np.nan_to_num(np.asarray(img, np.float64)) * 1000.0,
                              0, 65535).astype(np.uint16)
            color, depth = _GRAY, 16
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    if depth == 16:
        raw, stride = img.astype(">u2").tobytes(), w * 2
    else:
        raw = np.ascontiguousarray(img).tobytes()
        stride = w * (1 if img.ndim == 2 else img.shape[2])
    lines = bytearray()
    for r in range(h):          # filter type 0 (none) on every scanline
        lines.append(0)
        lines += raw[r * stride:(r + 1) * stride]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(lines), 6))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(ft: int, line: bytearray, prev: bytearray, bpp: int) -> None:
    """Undo one scanline's filter in place (PNG spec section 9)."""
    n = len(line)
    if ft == 1:      # sub
        for i in range(bpp, n):
            line[i] = (line[i] + line[i - bpp]) & 0xFF
    elif ft == 2:    # up
        for i in range(n):
            line[i] = (line[i] + prev[i]) & 0xFF
    elif ft == 3:    # average
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ft == 4:    # Paeth
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            up_left = prev[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + _paeth(left, prev[i], up_left)) & 0xFF
    elif ft != 0:
        raise ValueError(f"PNG filter {ft} is not a PNG filter type")


def decode(data: bytes) -> np.ndarray:
    """(H, W) for gray, (H, W, 3) or (H, W, 4) for RGB(A); uint8 at 8 bits,
    uint16 at 16."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    ihdr = None
    idat = bytearray()
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG unsupported")
    if color not in (_GRAY, _RGB, _RGBA) or depth not in (8, 16):
        raise ValueError(f"PNG color type {color} at {depth} bits unsupported "
                         f"(8- or 16-bit gray, RGB, RGBA)")
    nch = {_GRAY: 1, _RGB: 3, _RGBA: 4}[color]
    bpp = nch * (depth // 8)
    stride = w * bpp
    raw = zlib.decompress(bytes(idat))
    out = bytearray()
    prev = bytearray(stride)
    for r in range(h):
        ft = raw[r * (stride + 1)]
        line = bytearray(raw[r * (stride + 1) + 1:(r + 1) * (stride + 1)])
        _unfilter(ft, line, prev, bpp)
        out += line
        prev = line
    shape = (h, w) if nch == 1 else (h, w, nch)
    if depth == 16:
        return np.frombuffer(bytes(out), dtype=">u2").astype(np.uint16).reshape(shape)
    return np.frombuffer(bytes(out), dtype=np.uint8).reshape(shape)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def luminance(img: np.ndarray) -> np.ndarray:
    """Gray values of a decoded image: a gray image as it is, RGB(A) by
    ITU-R 601-2 luma in PIL's fixed point ((19595 R + 38470 G + 7471 B +
    0x8000) >> 16; alpha ignored)."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(img.dtype)
