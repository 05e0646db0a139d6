"""Binary PPM (P6) reader, matching the reference's LoadPPM (Texture.cpp:33-54);
a copy of bhraytracer_tpu/utils/ppm.py."""

from __future__ import annotations

import numpy as np


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM into (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, dims, maxval; '#' comments allowed between tokens.
    tokens = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] not in (0x0A, 0x0D):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    if tokens[0] != b"P6":
        raise ValueError(f"{path}: not a binary PPM")
    w, h = int(tokens[1]), int(tokens[2])
    pos += 1  # single whitespace after maxval
    img = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos)
    return img.reshape(h, w, 3).copy()
