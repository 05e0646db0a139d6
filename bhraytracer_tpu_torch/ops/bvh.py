"""BVH closest-hit and occlusion traces with the analytic fold (kernels 4
and 5).

Ports the packet kernels `bvh_closest_pallas` / `bvh_anyhit_pallas` of
bhraytracer_tpu/ops/pallas_bvh.py and the per-row-stack kernels
`bvh_closest_divergent` / `bvh_anyhit_divergent` of pallas_bvh_divergent.py:
on the card both become one thread per ray with its own stack
(csrc/bvh.cu). They read two tables of the pack (scene/pack.py):

  - `bvh_pairs` (B+1,8): [bmin (3), bmax (3), code, mag] of node r at row
    r + 1, after an empty pad row, so the children `left`, `left + 1` of
    every inner node (`left` odd) fill one aligned 64-byte line
    (scene/pack.py:pair_table): `code` (int32 bits) is an inner node's
    `left` or a leaf's `leaf_code`, `mag` the box's widening scale;
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
(ops/stream.py). `bvh_walk_ref` walks the tree as the kernels do, ray by
ray, with their pruning and their per-ray box and triangle test counts:
the tests and chip_smoke.py hold the kernels' counts and the brute-force
results to it.
"""

from __future__ import annotations

import torch

from bhraytracer_tpu_torch.ops import kernels
from bhraytracer_tpu_torch.ops import cull
from bhraytracer_tpu_torch.ops.intersect import PERP_EPS
from bhraytracer_tpu_torch.ops.stream import (
    SIDES,
    _analytic_anyhit,
    _analytic_closest,
    _inv_dlen,
    anyhit_over_faces,
    check_inputs,
    closest_over_faces,
)

STACK_DEPTH = 64  # per-ray traversal stack (pallas_bvh.py:39)
# Leaf entry codes ~(first face | count << COUNT_SHIFT) (csrc/bvh.cu:
# kCountShift): nodes and faces below MAX_INDEX, leaves of fewer than
# LEAF_FACES faces.
COUNT_SHIFT = 24
MAX_INDEX = 1 << COUNT_SHIFT
LEAF_FACES = 128


def _tri_test(faces, o, d, inv_dlen, side):
    """(R, C) (t, front, ok) of a ray block against a BVH face-row block
    (_tri_test, pallas_bvh.py:104-156)."""
    return _tri_cols([faces[:, j][None, :] for j in range(14)], o[:, 0:1],
                     o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3],
                     inv_dlen[:, None], side)


def _tri_cols(f, ox, oy, oz, dx, dy, dz, inv_dlen, side):
    """_tri_test on broadcastable columns: f the 14 face-row columns, then
    the ray's."""
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = f[:9]
    nx, ny, nz, ndot0, inv_nlen = f[9:14]
    tdiv = nx * dx + ny * dy + nz * dz
    pd = tdiv * (inv_nlen * inv_dlen)
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


def leaf_code(first, count):
    """The entry code of a leaf of `count` faces from `first`; an inner
    node's is its `left`."""
    return ~(first | (count << COUNT_SHIFT))


def bvh_walk_ref(pairs, faces, sph, pln, o, d, t, side: int = 2,
                 shadow=None):
    """Plain PyTorch twin of the kernels' walk (csrc/bvh.cu), ray by ray,
    for the tests and chip_smoke.py: the root's box, then at each inner node
    both children's boxes from its pair, entered at t_lo <= the ray's cap,
    the nearer taken first (the left at equal t), the farther pushed with
    its t_lo; a popped entry beyond the cap dropped; a leaf's faces in
    order. The cap is the best t so far (closest hits) or t_max.

    Closest hits (`shadow` None, `t` the seeds t_init): returns (t, key,
    counts). Occlusion (`shadow` = (t_min, ana_bias, plane_world_bug), `t`
    the t_max): front faces at t in (t_min, t_max) and the analytic
    occluders; a ray stops at its first occluder; returns (occ, counts).
    counts (N, 2) int32 are each ray's box and triangle tests, as the
    kernels count them."""
    n, dev = o.shape[0], o.device
    inv_dlen = _inv_dlen(d)
    if shadow is None:
        ana_t, ana_code, ana_front = _analytic_closest(side, sph, pln, o, d,
                                                       t)
        cap = ana_t.clone()
        done = torch.zeros(n, dtype=torch.bool, device=dev)
    else:
        t_min, ana_bias, plane_world_bug = shadow
        cap = t.clone()
        done = _analytic_anyhit(sph, pln, o, d, t, ana_bias,
                                plane_world_bug)
    occ = done.clone()
    best_face = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_front = torch.zeros(n, dtype=torch.int64, device=dev)
    n_box = (~done).long()
    n_tri = torch.zeros(n, dtype=torch.int64, device=dev)
    st_code = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    st_t = torch.zeros((n, STACK_DEPTH), dtype=o.dtype, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)

    codes = pairs[:, 6].contiguous().view(torch.int32).long()
    root = pairs[1:2].expand(n, -1)
    t_lo, crosses = cull.slab_entry(root, o, d)
    cur = torch.where(~done & crosses & (t_lo <= cap), codes[1], 0)
    while True:
        pop = torch.zeros(n, dtype=torch.bool, device=dev)
        # Inner nodes: both children from the pair, the nearer next.
        li = (cur > 0).nonzero()[:, 0]
        if li.numel():
            n_box[li] += 2
            ol, dl, cl = o[li], d[li], cap[li]
            kids = []
            for r in (cur[li] + 1, cur[li] + 2):  # the pair's two rows
                tl, x = cull.slab_entry(pairs[r], ol, dl)
                kids.append((tl, x & (tl <= cl), codes[r]))
            (t1, h1, c1), (t2, h2, c2) = kids
            both = h1 & h2
            first = t1 <= t2
            pi = li[both]
            st_code[pi, sp[pi]] = torch.where(first, c2, c1)[both]
            st_t[pi, sp[pi]] = torch.where(first, t2, t1)[both]
            sp[pi] += 1
            cur[li] = torch.where(both, torch.where(first, c1, c2),
                                  torch.where(h1, c1, torch.where(h2, c2, 0)))
            pop[li] = ~(h1 | h2)
        # Leaves: their faces in order, then the next entry.
        fi = (cur < 0).nonzero()[:, 0]
        if fi.numel():
            x = ~cur[fi]
            first, count = x & (MAX_INDEX - 1), x >> COUNT_SHIFT
            if shadow is None:
                n_tri[fi] += count
            live = torch.ones_like(fi, dtype=torch.bool)
            for j in range(int(count.max())):
                m = live & (j < count)
                li, f = fi[m], (first + j)[m]
                if shadow is None:
                    ft, front, ok = _tri_cols(
                        [faces[f, k] for k in range(14)], *o[li].unbind(1),
                        *d[li].unbind(1), inv_dlen[li], side)
                    bt, bf = cap[li], best_face[li]
                    upd = ok & ((ft < bt) | ((ft == bt) & (bf >= 0)
                                             & (f < bf)))
                    cap[li] = torch.where(upd, ft, bt)
                    best_face[li] = torch.where(upd, f, bf)
                    best_front[li] = torch.where(upd, front.long(),
                                                 best_front[li])
                else:
                    n_tri[li] += 1
                    ft, _, ok = _tri_cols(
                        [faces[f, k] for k in range(14)], *o[li].unbind(1),
                        *d[li].unbind(1), inv_dlen[li], 0)
                    hit = ok & (ft > t_min) & (ft < cap[li])
                    occ[li] |= hit
                    live[m] = ~hit
            cur[fi] = 0
            pop[fi] = live
        if not pop.any():
            if not (cur != 0).any():
                break
            continue
        # Pops, dropping entries beyond the cap (closest hits only).
        while pop.any():
            pi = (pop & (sp == 0)).nonzero()[:, 0]
            pop[pi] = False
            pi = pop.nonzero()[:, 0]
            sp[pi] -= 1
            code, tt = st_code[pi, sp[pi]], st_t[pi, sp[pi]]
            keep = tt <= cap[pi] if shadow is None else torch.ones_like(
                pop[pi])
            cur[pi[keep]] = code[keep]
            pop[pi[keep]] = False
    counts = torch.stack([n_box, n_tri], 1).to(torch.int32)
    if shadow is not None:
        return occ, counts
    mesh = best_face >= 0
    return (torch.where(mesh, cap, ana_t),
            torch.where(mesh, best_face * 2 + best_front,
                        ana_code.long() * 2 + ana_front).to(torch.int32),
            counts)


def _check(pairs, faces, depth, sph, pln, o, d, aux):
    check_inputs(faces, sph, pln, o, d, aux, row_multiple=1)
    kernels.check_table("pairs", pairs, 8)
    kernels.require(pairs.shape[0] % 2 == 0 and pairs.shape[0] >= 2,
                    f"pairs: {pairs.shape[0]} rows, not a pad row and "
                    "whole sibling pairs")
    kernels.require(pairs.device == o.device, "pairs: not on the rays' device")
    if o.device.type == "cuda":
        kernels.require(pairs.data_ptr() % 64 == 0,
                        "pairs: not 64-byte aligned")
    kernels.require(depth + 2 <= STACK_DEPTH,
                    f"BVH depth {depth} exceeds the kernel's stack of "
                    f"{STACK_DEPTH}")


def bvh_closest(pairs, faces, depth: int, sph, pln, o, d, t_init, side: str,
                counts=None):
    """Closest hit of (N,3) rays o, d over the BVH (its pair table `pairs`
    and `faces`; `depth` the tree's depth) and the analytic tables, seeded
    by t_init: (t (N,) f32, key (N,) i32). A CUDA `counts` (N,2) int32
    receives each ray's box and triangle test counts."""
    _check(pairs, faces, depth, sph, pln, o, d, t_init)
    kernels.check_counts(counts, o, (o.shape[0], 2))
    s = SIDES[side]
    if o.device.type == "cpu":
        return bvh_closest_ref(faces, sph, pln, o, d, t_init, s)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    key = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        kernels.launch("bhrt_bvh_closest", pairs, faces, sph, sph.shape[0],
                       pln, pln.shape[0], o, d, t_init, s, n, t, key, counts)
    return t, key


def bvh_anyhit(pairs, faces, depth: int, sph, pln, o, d, t_max, t_min: float,
               ana_bias: float = 0.0, plane_world_bug: bool = False,
               counts=None):
    """Occlusion (N,) bool of (N,3) rays within t_max (front mesh faces
    beyond t_min, analytic occluders beyond ana_bias). `counts` as in
    bvh_closest."""
    _check(pairs, faces, depth, sph, pln, o, d, t_max)
    kernels.check_counts(counts, o, (o.shape[0], 2))
    if o.device.type == "cpu":
        return bvh_anyhit_ref(faces, sph, pln, o, d, t_max, t_min, ana_bias,
                              plane_world_bug)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        kernels.launch("bhrt_bvh_anyhit", pairs, faces, sph, sph.shape[0],
                       pln, pln.shape[0], o, d, t_max, float(t_min),
                       float(ana_bias), int(plane_world_bug), n, occ, counts)
    return occ
