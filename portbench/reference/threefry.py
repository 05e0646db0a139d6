"""A frozen copy of the counter-based threefry2x32 draw that keys the
renderer's samples (the same bits as ``jax.random`` with partitionable
threefry, the draw the renderer under test uses).

The reference keys its samples with the draw the program is specified to
use, so that both sides shade each task with the same uniforms; nothing of
the program is imported. Words are uint32 values held in int64 tensors.

  - ``prng_key(s) = (0, s mod 2**32)``;
  - ``fold_in(k, d) = threefry2x32(k, (0, d))``;
  - the bits of flat index i are ``x0 ^ x1`` of
    ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
  - ``uniform = bitcast_f32((bits >> 9) | 0x3F800000) - 1``.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block cipher on broadcastable int64
    tensors of uint32 words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """fold_in of an int or an int64 tensor broadcasting over the keys."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def uniform_at(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) float32 at the flat counters (any int64 shape) of
    the stream of each key in the batch (..., 2): (..., *counters.shape)."""
    c = counters.to(torch.int64)
    kshape = key.shape[:-1]
    k0 = key[..., 0].reshape(kshape + (1,) * c.dim())
    k1 = key[..., 1].reshape(kshape + (1,) * c.dim())
    y0, y1 = threefry2x32(k0, k1, c >> 32, c & _M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform_table(key: torch.Tensor, rows: torch.Tensor, cols: int):
    """Rows `rows` of the (N, cols) table drawn from `key`: element (r, j)
    is counter r * cols + j."""
    j = torch.arange(cols, dtype=torch.int64, device=rows.device)
    return uniform_at(key, rows.to(torch.int64)[:, None] * cols + j[None, :])
