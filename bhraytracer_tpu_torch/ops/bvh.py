"""BVH closest-hit and occlusion traces with the analytic fold (kernels 4
and 5).

Ports the packet kernels `bvh_closest_pallas` / `bvh_anyhit_pallas` of
bhraytracer_tpu/ops/pallas_bvh.py and the per-row-stack kernels
`bvh_closest_divergent` / `bvh_anyhit_divergent` of pallas_bvh_divergent.py:
on the card both become one thread per ray with its own stack
(csrc/bvh.cu). They read two tables of the pack (scene/pack.py):

  - `bvh_nodes` (B,16): [bmin (3), bmax (3), left, count, code, pad (7)],
    code = axis + 3 when the left child sits on the high side;
  - `bvh_faces` (F,16) in leaf order: [v0 v1 v2 (9), n (3), n.v0, 1/|n|,
    pad (2)], n the unnormalised face normal.

The triangle test is the reference's dominant-axis projected-area test
with the grazing cull (_tri_test, pallas_bvh.py:104-156), not the stream
kernels' affine-barycentric one: the two differ within rounding of an
edge. Ties are order-free (lowest face at equal t; a mesh face replaces
the analytic winner only when strictly closer), so the traversal's result
is the brute-force minimum over all faces, and the `_ref` twins, which the
wrappers take for CPU tensors, are brute-force loops over every face with
the same test. Results come in the port's (t, key) contract
(ops/stream.py).
"""

from __future__ import annotations

import torch

from bhraytracer_tpu_torch.ops import kernels
from bhraytracer_tpu_torch.ops.intersect import PERP_EPS
from bhraytracer_tpu_torch.ops.stream import (
    SIDES,
    anyhit_over_faces,
    check_inputs,
    closest_over_faces,
)

STACK_DEPTH = 64  # per-ray traversal stack (pallas_bvh.py:39)


def _tri_test(faces, o, d, inv_dlen, side):
    """(R, C) (t, front, ok) of a ray block against a BVH face-row block
    (_tri_test, pallas_bvh.py:104-156)."""
    f = [faces[:, j][None, :] for j in range(14)]
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = f[:9]
    nx, ny, nz, ndot0, inv_nlen = f[9:14]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    tdiv = nx * dx + ny * dy + nz * dz
    pd = tdiv * (inv_nlen * inv_dlen[:, None])
    ok = pd.abs() >= PERP_EPS
    ndoto = nx * ox + ny * oy + nz * oz
    t = (ndot0 - ndoto) / torch.where(tdiv == 0.0, 1e-30, tdiv)
    ok &= t > 0.0
    front = tdiv < 0.0
    if side == 0:
        ok &= front
    elif side == 1:
        ok &= ~front
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    anx, any_, anz = nx.abs(), ny.abs(), nz.abs()
    use_x = (anx >= any_) & (anx >= anz)
    use_y = ~use_x & (any_ >= anx) & (any_ >= anz)

    def pick(ax, ay, az):
        return torch.where(use_x, ax, torch.where(use_y, ay, az))

    p0u, p0v = pick(v0y, v0x, v0x), pick(v0z, v0z, v0y)
    p1u, p1v = pick(v1y, v1x, v1x), pick(v1z, v1z, v1y)
    p2u, p2v = pick(v2y, v2x, v2x), pick(v2z, v2z, v2y)
    pxu, pxv = pick(hy, hx, hx), pick(hz, hz, hy)
    a0 = (p1u - pxu) * (p2v - pxv) - (p1v - pxv) * (p2u - pxu)
    a1 = (p2u - pxu) * (p0v - pxv) - (p2v - pxv) * (p0u - pxu)
    a2 = (p0u - pxu) * (p1v - pxv) - (p0v - pxv) * (p1u - pxu)
    ok &= (((a0 >= 0.0) & (a1 >= 0.0) & (a2 >= 0.0))
           | ((a0 < 0.0) & (a1 < 0.0) & (a2 < 0.0)))
    return t, front, ok


def bvh_closest_ref(faces, sph, pln, o, d, t_init, side: int):
    """Plain PyTorch twin of the closest-hit kernel: every face, no tree."""
    return closest_over_faces(_tri_test, faces, sph, pln, o, d, t_init, side)


def bvh_anyhit_ref(faces, sph, pln, o, d, t_max, t_min: float,
                   ana_bias: float, plane_world_bug: bool):
    """Plain PyTorch twin of the occlusion kernel: every face, no tree."""
    return anyhit_over_faces(_tri_test, faces, sph, pln, o, d, t_max, t_min,
                             ana_bias, plane_world_bug)


def _check(nodes, faces, depth, sph, pln, o, d, aux):
    check_inputs(faces, sph, pln, o, d, aux, row_multiple=1)
    kernels.require(nodes.dtype == torch.float32 and nodes.is_contiguous()
                    and nodes.dim() == 2 and nodes.shape[1] == 16,
                    f"nodes: {nodes.dtype} {tuple(nodes.shape)}")
    kernels.require(nodes.device == o.device, "nodes: not on the rays' device")
    kernels.require(depth + 2 <= STACK_DEPTH,
                    f"BVH depth {depth} exceeds the kernel's stack of "
                    f"{STACK_DEPTH}")


def bvh_closest(nodes, faces, depth: int, sph, pln, o, d, t_init, side: str,
                counts=None):
    """Closest hit of (N,3) rays o, d over the BVH (nodes, faces; `depth` the
    tree's depth) and the analytic tables, seeded by t_init:
    (t (N,) f32, key (N,) i32). A CUDA `counts` (N,2) int32 receives each
    ray's box and triangle test counts."""
    _check(nodes, faces, depth, sph, pln, o, d, t_init)
    kernels.check_counts(counts, o, (o.shape[0], 2))
    s = SIDES[side]
    if o.device.type == "cpu":
        return bvh_closest_ref(faces, sph, pln, o, d, t_init, s)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    key = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        kernels.launch("bhrt_bvh_closest", nodes, faces, sph, sph.shape[0],
                       pln, pln.shape[0], o, d, t_init, s, n, t, key, counts)
    return t, key


def bvh_anyhit(nodes, faces, depth: int, sph, pln, o, d, t_max, t_min: float,
               ana_bias: float = 0.0, plane_world_bug: bool = False,
               counts=None):
    """Occlusion (N,) bool of (N,3) rays within t_max (front mesh faces
    beyond t_min, analytic occluders beyond ana_bias). `counts` as in
    bvh_closest."""
    _check(nodes, faces, depth, sph, pln, o, d, t_max)
    kernels.check_counts(counts, o, (o.shape[0], 2))
    if o.device.type == "cpu":
        return bvh_anyhit_ref(faces, sph, pln, o, d, t_max, t_min, ana_bias,
                              plane_world_bug)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        kernels.launch("bhrt_bvh_anyhit", nodes, faces, sph, sph.shape[0],
                       pln, pln.shape[0], o, d, t_max, float(t_min),
                       float(ana_bias), int(plane_world_bug), n, occ, counts)
    return occ
