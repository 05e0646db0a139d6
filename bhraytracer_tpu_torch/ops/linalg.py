"""Small batched vector helpers on trailing-dim-3 tensors.

The NaN-safe guards of bhraytracer_tpu/ops/linalg.py are kept as they are:
they fix the forward values (the floors show in the results), and the
gradient port will need them.
"""

from __future__ import annotations

import torch

BIG = 1.0e30


def dot(a, b, keepdim: bool = False):
    """(a0*b0 + a1*b1) + a2*b2, in that order."""
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s.unsqueeze(-1) if keepdim else s


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def safe_sqrt(x):
    # Floor strictly above 0 (an infinite sqrt slope at 0 poisons gradients).
    return torch.sqrt(torch.clamp_min(x, 1e-24))


def safe_pow(x, p):
    """x**p, and 0 where x <= 0."""
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), p), 0.0)


def safe_div(a, b, eps: float = 1e-30):
    return a / torch.where(b.abs() < eps, torch.where(b < 0, -eps, eps), b)


def norm(a, keepdim: bool = False):
    return safe_sqrt(dot(a, a, keepdim=keepdim))


def normalize(a):
    return a / torch.clamp_min(norm(a, keepdim=True), 1e-30)


def acos_safe(x):
    """ACosSafe (cyCore.h:193): arccos of x clamped to [-1, 1]."""
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def mat_vec(m, v):
    """Batched (..., 3, 3) @ (..., 3), row by row as a dot."""
    return torch.stack([dot(m[..., i, :], v) for i in range(3)], -1)


def mat_t_vec(m, v):
    """Batched transpose(m) @ v (the reference's TransposeMult)."""
    return torch.stack([dot(m[..., :, i], v) for i in range(3)], -1)
