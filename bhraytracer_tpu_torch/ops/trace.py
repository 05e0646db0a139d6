"""Scene tracing: closest hit, occlusion, and hit resolution.

Every trace is routed as bhraytracer_tpu/ops/trace.py:486-767 routes it
(`trace_route`), with the analytic instances folded into each kernel:

  - mesh scenes with reorder=False (level-0 camera rays and their shadow
    rays, which arrive coherent) go through the BVH kernels (ops/bvh.py);
  - reorder=True on meshes of at most STREAM_MAX_FACES faces goes through
    the flat stream kernels (ops/stream.py);
  - reorder=True on bigger meshes is sorted by `coherence_order`, traced by
    the grouped stream kernels (ops/stream_hbm.py) and unsorted
    (trace.py:95-105, 126-137), up to the max_faces() whose box tables fit
    their shared memory; above it, the BVH kernels, which have no face
    limit, take reorder=True too (the reference streams such meshes from
    HBM: face ids may differ at equal-t seams, as between its own stream
    and BVH routes);
  - mesh-free scenes go through the analytic kernels (ops/analytic.py), as
    the reference's `not fold_analytic` branch (trace.py:530-543).

On the card these are hand-written CUDA kernels; on the CPU their twins.
All routes return the (t, key) contract of ops/stream.py, decoded by
`decode_key`. The reference's XLA traversals and treelet scans are TPU
forms and have no counterpart.

`resolve_hit` recomputes the surface interaction from the discrete hit ids
(bhraytracer_tpu/ops/trace.py:793-995): the full form for shading, with
texture coordinates and the plane's ray differentials, and the minimal
form for the refraction chain and the photon build.

Gradients (RenderConfig.differentiable) follow the JAX package's
hit-ID-frozen estimator (bhraytracer_tpu/ops/trace.py:14-17): every trace
runs on detached rays and tables, so no kernel or twin is differentiated,
and `resolve_hit` recomputes the interaction differentiably from the ids.
`rows_from_pools` rebuilds the mesh resolve rows from the vertex, normal
and uv pools, so that vertex gradients reach `pack.verts`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bhraytracer_tpu_torch.ops.analytic import analytic_anyhit, analytic_closest
from bhraytracer_tpu_torch.ops.bvh import STACK_DEPTH, bvh_anyhit, bvh_closest
from bhraytracer_tpu_torch.ops.compact import inverse_permutation, lookup_rows
from bhraytracer_tpu_torch.ops.cull import cluster_tables
from bhraytracer_tpu_torch.ops.intersect import triangle_areas
from bhraytracer_tpu_torch.ops.linalg import (
    BIG,
    cross,
    dot,
    mat_t_vec,
    mat_vec,
    normalize,
    safe_sqrt,
)
from bhraytracer_tpu_torch.ops.stream import (
    STREAM_MAX_FACES,
    instance_table,
    stream_anyhit,
    stream_closest,
)
from bhraytracer_tpu_torch.ops.stream_hbm import (
    max_faces,
    stream_anyhit_hbm,
    stream_closest_hbm,
)

KIND_SPHERE, KIND_PLANE, KIND_MESH = 0, 1, 2
# TriObj.cpp Bias (TriObj.cpp:9), in world t units (frame-invariant).
MESH_SHADOW_BIAS = 1e-4


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) f32, BIG on a miss
    kind: torch.Tensor  # (N,) i32
    inst: torch.Tensor  # (N,) i32
    face: torch.Tensor  # (N,) i32 global face id (mesh hits), -1 else
    front: torch.Tensor  # (N,) bool
    hit: torch.Tensor  # (N,) bool


class Surface(NamedTuple):
    p: torch.Tensor  # (N,3) world hit point
    n: torch.Tensor  # (N,3) world shading normal (normalised, never flipped)
    uvw: torch.Tensor  # (N,3)
    duvw: torch.Tensor  # (N,2,3)
    mtl: torch.Tensor  # (N,) i32
    z: torch.Tensor  # (N,) ray parameter
    front: torch.Tensor  # (N,) bool


def analytic_tables(pack):
    """(sphere rows (S,12), plane rows (P,12)) of the real instances, of any
    number. Built once, and kept in pack.cache; traces are not
    differentiated, so the tables carry no gradient."""
    if "analytic_tables" not in pack.cache:
        with torch.no_grad():
            pack.cache["analytic_tables"] = (
                instance_table(pack.sph_itm[:pack.n_sph],
                               pack.sph_pos[:pack.n_sph]),
                instance_table(pack.pln_itm[:pack.n_pln],
                               pack.pln_pos[:pack.n_pln]))
    return pack.cache["analytic_tables"]


def check_traceable(pack) -> None:
    """Every scene routes somewhere; the BVH kernels refuse a tree deeper
    than their per-ray stack."""
    if pack.n_msh and pack.bvh_depth + 2 > STACK_DEPTH:
        raise NotImplementedError(
            f"BVH depth {pack.bvh_depth}: the BVH kernels' stack holds "
            f"trees of depth up to {STACK_DEPTH - 2}")


def trace_route(pack, reorder: bool) -> str:
    """The kernel pair a trace takes: "analytic", "bvh", "stream" or
    "stream_hbm" (_stream_enabled / _stream_uses_hbm, bhraytracer_tpu/ops/
    trace.py:186-223 and 530-543, for a pack without treelets), and "bvh"
    where the reference would stream a mesh above max_faces() faces."""
    if not pack.n_msh:
        return "analytic"
    n_faces = pack.face_v.shape[0]
    if not reorder or n_faces > max_faces():
        return "bvh"
    if n_faces <= STREAM_MAX_FACES:
        return "stream"
    return "stream_hbm"


# Coarse origin cells per axis of the coherence key (pallas_bvh.py:52).
CELL_RES = 4


def coherence_order(pack, o, d, t_init) -> torch.Tensor:
    """Stable sort order of the rays (_coherence_order, pallas_bvh.py:
    274-309): lanes that miss the root box, or meet it beyond t_init, go
    last; the others group by direction octant, then by a coarse origin
    cell of the root box."""
    bmin, bmax = pack.bvh_bmin[0], pack.bvh_bmax[0]
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    ta = (bmin[None, :] - o) * inv
    tb = (bmax[None, :] - o) * inv
    tlo = torch.minimum(ta, tb).amax(1)
    thi = torch.maximum(ta, tb).amin(1)
    live = (tlo <= thi) & (thi >= 0.0) & (tlo < t_init)
    oct_ = ((d[:, 0] > 0).to(torch.int32) + 2 * (d[:, 1] > 0).to(torch.int32)
            + 4 * (d[:, 2] > 0).to(torch.int32))
    r = CELL_RES
    ext = torch.clamp_min(bmax - bmin, 1e-6)
    cell = torch.clamp((o - bmin[None, :]) / ext[None, :] * r, 0.0, r - 1.0)
    cell = cell.to(torch.int32)
    cell_id = cell[:, 0] + r * cell[:, 1] + r * r * cell[:, 2]
    key = torch.where(live, oct_ * (r * r * r) + cell_id, 8 * r * r * r)
    return torch.argsort(key, stable=True)


def decode_key(pack, t, key) -> Hit:
    """Hit from the stream kernels' packed key (trace.py:597-609): face =
    key >> 1, front = key & 1, analytic codes -(2 + inst*4 + kind*2 +
    front)."""
    face = key >> 1
    front = (key & 1).bool()
    ana = face <= -2
    code = (-face) - 2
    mface = face.clamp(0, pack.face_inst.shape[0] - 1)
    minst = pack.face_inst[mface.long()]
    return Hit(t=t,
               kind=torch.where(ana, (code >> 1) & 1, KIND_MESH).to(torch.int32),
               inst=torch.where(ana, code >> 2, minst).to(torch.int32),
               face=torch.where(ana, -1, face).to(torch.int32),
               front=front,
               hit=t < BIG)


def trace_closest(pack, o, d, hit_side: str = "front",
                  reorder: bool = True) -> Hit:
    """Closest hit over all instances. o, d: (N,3) world rays. reorder=False
    takes the BVH kernel, for rays that arrive coherent (trace_route). The
    rays are detached: the hit is discrete (trace.py:464-465)."""
    sph, pln = analytic_tables(pack)
    o, d = o.detach().contiguous(), d.detach().contiguous()
    route = trace_route(pack, reorder)
    if route == "analytic":
        return decode_key(pack, *analytic_closest(sph, pln, o, d, hit_side))
    t_init = torch.full((o.shape[0],), BIG, dtype=torch.float32,
                        device=o.device)
    if route == "bvh":
        t, key = bvh_closest(pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth,
                             sph, pln, o, d, t_init, hit_side)
    elif route == "stream_hbm":
        order = coherence_order(pack, o, d, t_init)
        t, key = stream_closest_hbm(*cluster_tables(pack), sph, pln,
                                    o[order], d[order], t_init[order],
                                    hit_side)
        inv = inverse_permutation(order)
        t, key = t[inv], key[inv]
    else:
        t, key = stream_closest(pack.stream_rows, sph, pln, o, d, t_init,
                                hit_side, boxes=cluster_tables(pack)[1:])
    return decode_key(pack, t, key)


def trace_shadow(pack, o, d, t_max, shadow_bias: float,
                 plane_extent_bug: bool = False, reorder: bool = True):
    """Boolean occlusion (ShadowRayRecursive, GenLight.cpp:15-69): front
    mesh faces in (MESH_SHADOW_BIAS, t_max), analytic occluders in
    (shadow_bias, t_max). `plane_extent_bug` reproduces the reference's
    plane frame mix-up (GenLight.cpp:37-40). Routed as trace_closest, on
    detached rays and t_max (trace.py:497-499)."""
    sph, pln = analytic_tables(pack)
    o, d = o.detach().contiguous(), d.detach().contiguous()
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=o.device).detach()
    t_max = t_max.expand(o.shape[0]).contiguous()
    kw = dict(ana_bias=shadow_bias, plane_world_bug=plane_extent_bug)
    route = trace_route(pack, reorder)
    if route == "analytic":
        return analytic_anyhit(sph, pln, o, d, t_max, **kw)
    if route == "bvh":
        return bvh_anyhit(pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth, sph,
                          pln, o, d, t_max, MESH_SHADOW_BIAS, **kw)
    if route == "stream_hbm":
        order = coherence_order(pack, o, d, t_max)
        occ = stream_anyhit_hbm(*cluster_tables(pack), sph, pln, o[order],
                                d[order], t_max[order], MESH_SHADOW_BIAS, **kw)
        return occ[inverse_permutation(order)]
    return stream_anyhit(pack.stream_rows, sph, pln, o, d, t_max,
                         MESH_SHADOW_BIAS, boxes=cluster_tables(pack)[1:],
                         **kw)


def rows_from_pools(pack) -> torch.Tensor:
    """The packed (F,32) resolve rows rebuilt from the vertex, normal and
    uv pools (bhraytracer_tpu/ops/trace.py:775-790): the same values as
    `pack.resolve_rows`, but gathered from `pack.verts`, `pack.normals`
    and `pack.uvs`, so that a differentiable render that swaps them in
    carries gradients back to those pools."""
    f = pack.face_v.shape[0]
    vt3 = pack.verts[pack.face_v.long()].reshape(f, 9)
    nt3 = pack.normals[pack.face_vn.long()].reshape(f, 9)
    ut3 = pack.uvs[pack.face_vt.long()].reshape(f, 9)
    mtl = pack.face_mtl.float()[:, None]
    return torch.cat([vt3, nt3, ut3, mtl, vt3.new_zeros((f, 4))], 1)


def resolve_hit(pack, o, d, hit: Hit, dd_x=None, dd_y=None,
                minimal: bool = False) -> Surface:
    """Recompute the surface interaction from discrete hit ids
    (bhraytracer_tpu/ops/trace.py:793-995, fast_rows=True: the mesh branch
    reads the packed (F,32) `resolve_rows` table, copies of the vertex,
    normal and uv pools; a differentiable render swaps in rows_from_pools).

    dd_x/dd_y are the camera pixel deltas (3,), which the plane's ray
    differentials use for secondary rays too (Plane.cpp:51-70, via the
    reference's dd_x/dd_y globals); None stands for zeros. duvw is computed
    only where the scene has texture maps to filter. `minimal=True`
    computes only p, n, z and mtl (the refraction chain's and the photon
    build's needs): uvw and duvw are zero."""
    n = o.shape[0]
    kind = hit.kind
    z3 = o.new_zeros((n, 3))
    want_duvw = pack.n_texmaps > 0 and not minimal
    branches = {}

    if pack.n_sph:
        si = hit.inst.clamp(0, pack.sph_itm.shape[0] - 1).long()
        s_itm = pack.sph_itm[si]
        ol = mat_vec(s_itm, o - pack.sph_pos[si])
        dl = mat_vec(s_itm, d)
        a = dot(dl, dl)
        b = 2.0 * dot(dl, ol)
        c = dot(ol, ol) - 1.0
        sq = safe_sqrt(b * b - 4.0 * a * c)
        inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-30)
        t_s = torch.where(hit.front, (-b - sq) * inv2a, (-b + sq) * inv2a)
        p_s = ol + t_s[:, None] * dl
        if minimal:
            uv_s = z3
        else:
            # The sphere's uv is not differentiated (trace.py:842).
            dn = normalize(p_s.detach())
            uv_s = torch.stack([
                0.5 + torch.atan2(dn[:, 1], dn[:, 0]) / (2.0 * torch.pi),
                0.5 - torch.asin(torch.clamp(dn[:, 2], -1.0, 1.0)) / torch.pi,
                o.new_zeros(n)], -1)
        # N = local hit point (Sphere.cpp:57).
        branches[KIND_SPHERE] = (t_s, p_s, p_s, uv_s, z3, z3,
                                 pack.sph_mtl[si], pack.sph_tm[si], s_itm,
                                 pack.sph_pos[si])

    if pack.n_pln:
        pi = hit.inst.clamp(0, pack.pln_itm.shape[0] - 1).long()
        p_itm = pack.pln_itm[pi]
        ol = mat_vec(p_itm, o - pack.pln_pos[pi])
        dl = mat_vec(p_itm, d)
        para = dl[:, 2].abs() < 1e-12
        t_p = (torch.where(para, 0.0, -ol[:, 2])
               / torch.where(para, 1.0, dl[:, 2]))
        p_p = ol + t_p[:, None] * dl
        n_p = torch.zeros_like(p_p)
        n_p[:, 2] = 1.0
        uv_p = z3 if minimal else torch.stack(
            [(1.0 + p_p[:, 0]) * 0.5, (1.0 + p_p[:, 1]) * 0.5,
             o.new_zeros(n)], -1)
        if want_duvw:
            # Ray differentials (Plane.cpp:51-70): the LOCAL ray direction
            # mixed with the WORLD-frame camera deltas, verbatim.
            nd = normalize(dl)
            scaled_t = t_p * torch.sqrt(torch.clamp_min(dot(dl, dl), 1e-30))
            nd_n = dot(nd, n_p)
            nd_n = torch.where(nd_n == 0, 1e-30, nd_n)

            def plane_duvw(dd):
                dd = z3 if dd is None else dd.expand(n, 3)
                ddir = dd - dot(nd, dd, keepdim=True) * nd
                dt = -(scaled_t * dot(ddir, n_p) / nd_n)
                return (scaled_t[:, None] * ddir + dt[:, None] * nd) * 0.5

            d0, d1 = plane_duvw(dd_x), plane_duvw(dd_y)
        else:
            d0 = d1 = z3
        branches[KIND_PLANE] = (t_p, p_p, n_p, uv_p, d0, d1,
                                pack.pln_mtl[pi], pack.pln_tm[pi], p_itm,
                                pack.pln_pos[pi])

    if pack.n_msh:
        mi = hit.inst.clamp(0, pack.msh_itm.shape[0] - 1).long()
        m_itm = pack.msh_itm[mi]
        ol = mat_vec(m_itm, o - pack.msh_pos[mi])
        dl = mat_vec(m_itm, d)
        rows = lookup_rows(pack.resolve_rows,
                           hit.face.clamp(0, pack.face_v.shape[0] - 1))
        v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        vn = cross(v1 - v0, v2 - v0)
        tdiv = dot(vn, dl)
        # Junk lanes (non-mesh, miss) may be near-parallel: zero them.
        graze = tdiv.abs() < 1e-12
        t_m = (torch.where(graze, 0.0, dot(vn, v0) - dot(vn, ol))
               / torch.where(graze, 1.0, tdiv))
        p_m = ol + t_m[:, None] * dl
        a0, a1, a2 = triangle_areas(v0, v1, v2, p_m, vn)
        asum = a0 + a1 + a2
        asum = torch.where(asum.abs() < 1e-30, 1e-30, asum)
        b0, b1, b2 = ((a / asum)[:, None] for a in (a0, a1, a2))
        n_m = b0 * rows[:, 9:12] + b1 * rows[:, 12:15] + b2 * rows[:, 15:18]
        uv_m = z3 if minimal else (b0 * rows[:, 18:21] + b1 * rows[:, 21:24]
                                   + b2 * rows[:, 24:27])
        m_ml = pack.msh_mtl[mi]
        branches[KIND_MESH] = (t_m, p_m, n_m, uv_m, z3, z3,
                               torch.where(m_ml >= 0, m_ml,
                                           rows[:, 27].to(torch.int32)),
                               pack.msh_tm[mi], m_itm, pack.msh_pos[mi])

    if not branches:
        return Surface(p=z3, n=z3, uvw=z3, duvw=o.new_zeros((n, 2, 3)),
                       mtl=torch.zeros_like(kind), z=o.new_zeros(n),
                       front=hit.front)

    kinds = sorted(branches)

    def sel(i):
        out = branches[kinds[0]][i]
        for kd in kinds[1:]:
            m = (kind == kd).reshape((n,) + (1,) * (out.dim() - 1))
            out = torch.where(m, branches[kd][i], out)
        return out

    t, p_l, n_l, mtl, tm, itm, pos = (sel(i) for i in (0, 1, 2, 6, 7, 8, 9))
    uvw = z3 if minimal else sel(3)
    duvw = (torch.stack([sel(4), sel(5)], 1) if want_duvw
            else o.new_zeros((n, 2, 3)))
    # FromNodeCoords (scene.h:497-501): p -> tm p + pos, N -> itm^T N.
    return Surface(p=mat_vec(tm, p_l) + pos, n=normalize(mat_t_vec(itm, n_l)),
                   uvw=uvw, duvw=duvw, mtl=mtl, z=t, front=hit.front)
