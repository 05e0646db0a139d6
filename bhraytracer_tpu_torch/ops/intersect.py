"""Primitive intersection tests, vectorised over ray batches (the port of
bhraytracer_tpu/ops/intersect.py).

  - unit sphere (Sphere.cpp:8-75): front/back/both side selection,
    inside-the-sphere = back-face hit, tangent (disc == 0) = miss;
  - unit plane z = 0, |x|,|y| <= 1 (Plane.cpp:8-77);
  - triangle by dominant-axis projection and signed areas
    (TriObj.cpp:68-189), with the grazing-angle cull.

`hit_side` is "front" | "back" | "both" (HIT_* flags, scene.h:57-60). The
stream kernels (ops/stream.py, csrc/stream.cu) carry their own forms of
these tests, with the affine-barycentric triangle test; the forms here are
the reference's, which the tests hold the stream twins to, and
`resolve_hit` recomputes a hit's barycentrics with `triangle_areas`.
"""

from __future__ import annotations

import torch

from bhraytracer_tpu_torch.ops.linalg import BIG, cross, dot, norm, safe_sqrt

# cos-based grazing-angle cull for triangles (TriObj.cpp:12).
PERP_EPS = 0.001745


def sphere_intersect(o, d, hit_side: str):
    """Unit sphere at origin; o, d (..., 3). Returns (t, front), t = BIG on
    a miss."""
    a = dot(d, d)
    b = 2.0 * dot(d, o)
    c = dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc > 0.0
    sq = safe_sqrt(disc)
    inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-30)
    t1 = (-b + sq) * inv2a  # far root
    t2 = (-b - sq) * inv2a  # near root
    both_pos = t2 > 0.0
    inside = t1 * t2 <= 0.0
    if hit_side == "front":
        t = torch.where(both_pos, t2, BIG)
        front = torch.ones_like(ok)
    elif hit_side == "back":
        t = torch.where(both_pos | inside, t1, BIG)
        front = torch.zeros_like(ok)
    else:
        t = torch.where(both_pos, t2, torch.where(inside, t1, BIG))
        front = both_pos
    return torch.where(ok & (t > 0.0), t, BIG), front


def plane_intersect(o, d, hit_side: str):
    """Unit plane z = 0, x,y in [-1,1]. Returns (t, front)."""
    dz = d[..., 2]
    t = -o[..., 2] / torch.where(dz == 0.0, 1e-30, dz)
    x = o[..., 0] + t * d[..., 0]
    y = o[..., 1] + t * d[..., 1]
    in_extent = (x.abs() <= 1.0) & (y.abs() <= 1.0)
    front = dz < 0.0
    ok = (dz != 0.0) & (t > 0.0) & in_extent
    if hit_side == "front":
        ok &= front
    elif hit_side == "back":
        ok &= ~front
    return torch.where(ok, t, BIG), front


def triangle_intersect(v0, v1, v2, o, d, hit_side: str):
    """Dominant-axis triangle test (TriObj.cpp:68-189). Inputs broadcast
    to (..., 3). Returns (t, front), t = BIG on a miss."""
    vn = cross(v1 - v0, v2 - v0)
    tdiv = dot(vn, d)
    pd = tdiv / torch.clamp_min(norm(vn) * norm(d), 1e-30)
    ok = pd.abs() >= PERP_EPS
    t = (dot(vn, v0) - dot(vn, o)) / torch.where(tdiv == 0.0, 1e-30, tdiv)
    ok &= t > 0.0
    front = tdiv < 0.0
    if hit_side == "front":
        ok &= front
    elif hit_side == "back":
        ok &= ~front
    a0, a1, a2 = triangle_areas(v0, v1, v2, o + t[..., None] * d, vn)
    ok &= (((a0 >= 0.0) & (a1 >= 0.0) & (a2 >= 0.0))
           | ((a0 < 0.0) & (a1 < 0.0) & (a2 < 0.0)))
    return torch.where(ok, t, BIG), front


def triangle_areas(v0, v1, v2, x, vn):
    """Signed projected half-areas of x against the triangle's edges, on
    the dominant axis of |vn| (TriObj.cpp:105-168)."""
    avn = vn.abs()
    ax, ay, az = avn[..., 0], avn[..., 1], avn[..., 2]
    use_x = (ax >= ay) & (ax >= az)
    use_y = ~use_x & (ay >= ax) & (ay >= az)

    def proj(p):
        c0 = torch.where(use_x, p[..., 1], p[..., 0])
        c1 = torch.where(use_x | use_y, p[..., 2], p[..., 1])
        return c0, c1

    (p0x, p0y), (p1x, p1y), (p2x, p2y), (qx, qy) = (
        proj(v0), proj(v1), proj(v2), proj(x))

    def cross2(ax_, ay_, bx_, by_):
        return ax_ * by_ - ay_ * bx_

    a0 = cross2(p1x - qx, p1y - qy, p2x - qx, p2y - qy) * 0.5
    a1 = cross2(p2x - qx, p2y - qy, p0x - qx, p0y - qy) * 0.5
    a2 = cross2(p0x - qx, p0y - qy, p1x - qx, p1y - qy) * 0.5
    return a0, a1, a2
