"""Monte-Carlo direction samplers (the port of bhraytracer_tpu/ops/sampling.py).

Stateless: every function takes explicit uniform variates (ops/rng.py)
instead of the reference's shared rand() (MtlBlinn.cpp:42-49). The fused
shade kernel (ops/shade.py) carries its own algebraic forms of the same
samplers, as bhraytracer_tpu/ops/pallas_shade.py does; these serve the
refraction chain's glossy resampling and the unfused shading functions.
"""

from __future__ import annotations

import math

import torch

from bhraytracer_tpu_torch.ops.linalg import cross, normalize, safe_sqrt

TWO_PI = 2.0 * math.pi


def crossing_vector(v):
    """GetRandomCrossingVector (MtlBlinn.cpp:591-600): (0,0,1) unless v is
    (anti)parallel to it, then (1,0,0). |v x (0,0,1)|^2 = v_y^2 + v_x^2."""
    degen = (v[..., 1] * v[..., 1] + v[..., 0] * v[..., 0] < 1e-12).to(v.dtype)
    return torch.stack([degen, torch.zeros_like(degen), 1.0 - degen], -1)


def _frame_axes(n):
    """axis1 = crossing x N, axis2 = axis1 x N, both normalised
    (MtlBlinn.cpp:612-613)."""
    a1 = normalize(cross(crossing_vector(n), n))
    a2 = normalize(cross(a1, n))
    return a1, a2


def sample_along_normal(n, radius, u1, u2):
    """Uniform disc of radius `radius` around the tip of n
    (MtlBlinn.cpp:602-617)."""
    r = torch.sqrt(u1) * radius
    theta = u2 * TWO_PI
    a1, a2 = _frame_axes(n)
    return (n + a1 * (r * torch.cos(theta))[..., None]
            + a2 * (r * torch.sin(theta))[..., None])


def sample_along_light_direction(n, glossiness, u1, u2):
    """Lobe sample around (unnormalised) n with exponent `glossiness`
    (MtlBlinn.cpp:619-635), acos/tan eliminated algebraically. Returns
    (dir, cos_theta); dir is not normalised (reference parity)."""
    c = torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (glossiness + 1.0))
    r = (safe_sqrt(torch.clamp_min(1.0 - c * c, 0.0))
         / torch.clamp_min(c, 1e-30))
    phi = u2 * TWO_PI
    a1, a2 = _frame_axes(n)
    d = (n + a1 * (r * torch.cos(phi))[..., None]
         + a2 * (r * torch.sin(phi))[..., None])
    return d, c


def sample_in_semisphere(n, u1, u2):
    """Hemisphere sample around normalised n (MtlBlinn.cpp:697-716), in
    half-angle form. Returns (dir, sin_2theta)."""
    a_y = normalize(cross(n, crossing_vector(n)))
    a_x = cross(n, a_y)
    phi = u1 * TWO_PI
    ct = safe_sqrt(torch.clamp_min(1.0 - u2, 0.0))
    st = safe_sqrt(torch.clamp_min(u2, 0.0))
    d = ((st * torch.cos(phi))[..., None] * a_x
         + (st * torch.sin(phi))[..., None] * a_y + ct[..., None] * n)
    return d, 2.0 * st * ct
