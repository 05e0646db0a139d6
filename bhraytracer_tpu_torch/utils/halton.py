"""Halton low-discrepancy sequence (reference: scene.h:137-146), a copy of
bhraytracer_tpu/utils/halton.py.

Used for the multi-tap texture filter (scene.h:316-337): the tap table is
made once on the host (ops/texturing.py caches it per device).
"""

from __future__ import annotations

import numpy as np


def halton(index: int, base: int) -> float:
    r, f = 0.0, 1.0 / base
    i = index
    while i > 0:
        r += f * (i % base)
        f /= base
        i //= base
    return r


def texture_filter_taps(n: int) -> np.ndarray:
    """The reference's elliptic filter taps (scene.h:322-334): tap 0 is the
    center; taps 1..n-1 are Halton(2)/Halton(3) points warped to a disc.

    Returns (n, 2) float32 offsets in (duvw0, duvw1) space.
    """
    taps = np.zeros((n, 2), np.float32)
    for i in range(1, n):
        x = halton(i, 2)
        y = halton(i, 3)
        r = np.sqrt(x) * 0.5
        taps[i, 0] = r * np.sin(y * np.pi * 2)
        taps[i, 1] = r * np.cos(y * np.pi * 2)
    return taps
