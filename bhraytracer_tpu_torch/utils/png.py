"""Minimal PNG codec (pure numpy + stdlib zlib); the port's copy of
bhraytracer_tpu/utils/png.py.

Replaces the reference's vendored LodePNG (BHRayTracer/LoadPNG/lodepng.cpp):
decode is used for image textures (Texture.cpp:70-77), encode for saving the
8-bit RGB render (scene.h:628-644). Supports the subset a renderer needs:
8-bit grey / RGB / palette / RGBA (alpha dropped on decode-to-RGB), no
interlacing, and writes 8-bit RGB or grey.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an 8-bit PNG. image: (H, W) grey or (H, W, 3) RGB uint8."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8 data")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # Filter type 0 (None) per scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1
    ).tobytes()
    data = _PNG_SIG
    data += _chunk(b"IHDR", ihdr)
    data += _chunk(b"IDAT", zlib.compress(raw, 6))
    data += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters. raw: (h, 1+stride) uint8 rows w/ filter byte.

    Dispatches to the port's native C++ helper (native/bhrt_native.cpp,
    bhrt_png_unfilter) when it builds (the Python Paeth loop is far too
    slow for MP-class textures); without it (no g++), the Python loop,
    which is bit-identical, as scene/obj_loader.py falls back to its
    Python parser.
    """
    from bhraytracer_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is not None:
        raw_c = np.ascontiguousarray(raw)
        out = np.zeros((h, stride), np.uint8)
        rc = lib.bhrt_png_unfilter(
            raw_c.ctypes.data, out.ctypes.data, h, stride, bpp
        )
        if rc == 0:
            return out
    return _unfilter_py(raw, h, stride, bpp)


def _unfilter_py(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Pure-Python unfilter fallback (slow on Average/Paeth-heavy images)."""
    out = np.zeros((h, stride), np.uint16)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.uint16)
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.uint16)
        if ftype == 0:
            out[y] = line
        elif ftype == 2:  # Up
            out[y] = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):  # Sub / Average / Paeth need a scan
            cur = out[y]
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    v = line[x] + a
                elif ftype == 3:
                    v = line[x] + ((a + b) >> 1)
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = int(a) + int(b) - int(c)
                    pa, pb, pc = abs(p - int(a)), abs(p - int(b)), abs(p - int(c))
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    v = line[x] + pred
                cur[x] = v & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to (H, W, 3) uint8 RGB (alpha dropped, grey/palette
    expanded) — the same contract as lodepng::decode(..., LCT_RGB)
    (Texture.cpp:70)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    palette = None
    w = h = bitdepth = colortype = interlace = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, colortype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if interlace:
        raise NotImplementedError("interlaced PNG not supported")
    if bitdepth != 8:
        raise NotImplementedError(f"PNG bit depth {bitdepth} not supported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colortype]
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + stride)
    img = _unfilter(raw, h, stride, channels).reshape(h, w, channels)
    if colortype == 3:
        img = palette[img[:, :, 0]]
    elif channels == 1:
        img = np.repeat(img, 3, axis=2)
    elif channels == 2:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    elif channels == 4:
        img = img[:, :, :3]
    return np.ascontiguousarray(img)
