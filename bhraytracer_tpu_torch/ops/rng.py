"""Counter-based threefry2x32 RNG, bit-exact with ``jax.random``.

The integrator's lane pairing (per-level uniform tables, raygen jitter,
glossy-refraction draws) is keyed by threefry streams; reproducing the same
bits makes lane-for-lane parity with the JAX package possible. This matches
``jax.random`` with ``jax_threefry_partitionable`` on (the default since jax
0.5):

  - a key is a pair of uint32 words; ``prng_key(s) = (0, s)``;
  - ``fold_in(k, d) = threefry2x32(k, (0, d))``;
  - the bits of flat index i are ``x0 ^ x1`` of
    ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
  - ``uniform = bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

Words are held in int64 tensors masked to 32 bits (torch's uint32 support
is partial), so the same code runs on the CPU and on the card. A key is an
int64 tensor of shape (..., 2): a batch of keys draws a batch of streams in
one call. Element i of a draw comes from counter i alone, so a draw of
some rows of a table (`uniform_rows`) costs those rows only: a rank of a
sharded render draws the rows its lanes hold of the table one process
would draw over all lanes.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block cipher on broadcastable int64
    tensors holding uint32 words. Returns (y0, y1)."""
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
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``. `data` is an int or an int64 tensor that
    broadcasts against the key batch."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def _counter_bits(key: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """(..., m) uint32 words (as int64) of the flat counters i (m,)."""
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          i >> 32, i & _M32)
    return y0 ^ y1


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) uint32 words (as int64) of the flat index stream 0..n-1."""
    return _counter_bits(key, torch.arange(n, dtype=torch.int64,
                                           device=key.device))


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    bits = (bits >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32. A key batch
    of shape (..., 2) gives (..., *shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for s in shape:
        n *= s
    return _to_uniform(random_bits(key, n)).reshape(key.shape[:-1] + shape)


def uniform_rows(key: torch.Tensor, rows: torch.Tensor,
                 k: int | None = None) -> torch.Tensor:
    """Rows `rows` ((m,) int64, any order) of ``uniform(key, (N, k))``, or
    of ``uniform(key, (N,))`` where k is None, for any N above the rows,
    without drawing the others: counters rows*k + j, or rows. A key batch
    (..., 2) gives (..., m, k) or (..., m)."""
    rows = rows.to(torch.int64)
    if k is None:
        return _to_uniform(_counter_bits(key, rows))
    i = (rows[:, None] * k + torch.arange(k, dtype=torch.int64,
                                         device=rows.device)).reshape(-1)
    return _to_uniform(_counter_bits(key, i)).reshape(
        key.shape[:-1] + (rows.shape[0], k))
