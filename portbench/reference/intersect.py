"""Closest hits and occlusion of ray batches against the reference scene,
worked out from the primitives alone.

Semantics (the reference renderer's Sphere.cpp, Plane.cpp, TriObj.cpp and
GenLight.cpp):

  - unit sphere in its node's frame: no hit where the discriminant is not
    positive; "front" takes the near root when both roots are positive,
    "both" also the far root from inside (a back-face hit);
  - unit square z = 0, |x|, |y| <= 1: front where the ray runs against +z;
  - triangle: the plane through it, culled where |cos| between the ray and
    the face normal is under PERP_EPS, then the signed projected areas on
    the normal's dominant axis, all of one sign; front where the ray runs
    against the normal v01 x v02;
  - closest: the least t > 0; among faces at equal t the lowest face id;
    a face replaces a sphere or plane only where strictly closer;
  - occlusion: a sphere's near root in (ana_bias, t_max), a plane in
    (ana_bias, t_max) on either side, a front face in (MESH_BIAS, t_max).

Triangles are culled by the reference's own clusters (`MeshClusters`):
faces in Morton order of their centroids, CLUSTER faces a cluster, each
cluster's box, and a ray tests the faces of the clusters whose box it
enters. The cull drops no face a ray can hit, so results equal the brute
force over all faces, which the tests hold it to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1.0e30
PERP_EPS = 0.001745
MESH_BIAS = 1e-4
CLUSTER = 64
KIND_SPHERE, KIND_PLANE, KIND_MESH = 0, 1, 2
_PAIRS = 1 << 17  # (ray, cluster) pairs a step
_RAYS = 1 << 15  # rays a step of the cluster test


class Hits(NamedTuple):
    t: torch.Tensor  # (N,) BIG on a miss
    kind: torch.Tensor  # (N,) int64
    idx: torch.Tensor  # (N,) int64 instance (sphere, plane) or face
    front: torch.Tensor  # (N,) bool
    hit: torch.Tensor  # (N,) bool


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def local_ray(row, o, d):
    """The ray in a node's frame: (inv (o - pos), inv d) for a row
    [inv (9), pos (3)]."""
    m = row[:9].reshape(3, 3)
    return mat_vec(m, o - row[9:12]), mat_vec(m, d)


def mat_vec(m, v):
    """m v for a (..., 3, 3) or (3, 3) m and (..., 3) v, as sums of
    products (no matrix unit, so no reduced-precision path)."""
    return (m * v[..., None, :]).sum(-1)


def sphere_hit(row, o, d, side: str):
    """(t, front) of the unit sphere of `row`; t = BIG on a miss."""
    ol, dl = local_ray(row, o, d)
    a = _dot(dl, dl)
    b = 2.0 * _dot(dl, ol)
    c = _dot(ol, ol) - 1.0
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-30)
    far = (-b + sq) * inv2a
    near = (-b - sq) * inv2a
    both_pos = near > 0.0
    inside = far * near <= 0.0
    if side == "front":
        t, front = torch.where(both_pos, near, BIG), torch.ones_like(both_pos)
    else:
        t = torch.where(both_pos, near, torch.where(inside, far, BIG))
        front = both_pos
    return torch.where((disc > 0.0) & (t > 0.0), t, BIG), front


def plane_hit(row, o, d, side: str):
    ol, dl = local_ray(row, o, d)
    dz = dl[:, 2]
    t = -ol[:, 2] / torch.where(dz == 0.0, 1e-30, dz)
    x = ol[:, 0] + t * dl[:, 0]
    y = ol[:, 1] + t * dl[:, 1]
    front = dz < 0.0
    ok = (dz != 0.0) & (t > 0.0) & (x.abs() <= 1.0) & (y.abs() <= 1.0)
    if side == "front":
        ok = ok & front
    return torch.where(ok, t, BIG), front


class MeshClusters:
    """The reference's own face clusters of the scene's triangles, with the
    per-face quantities the test reads."""

    def __init__(self, tri: torch.Tensor):
        self.n_faces = f = tri.shape[0]
        dt, dev = tri.dtype, tri.device
        if f == 0:
            return
        c = tri.float().mean(1)
        lo, hi = c.amin(0), c.amax(0)
        q = ((c - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023.0).long().clamp(0, 1023)
        code = torch.zeros(f, dtype=torch.int64, device=dev)
        for bit in range(10):
            for axis in range(3):
                code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
        order = torch.argsort(code, stable=True)
        pad = (-f) % CLUSTER
        self.order = torch.cat([order, order[-1:].expand(pad)])  # (C*CLUSTER,)
        v = tri[self.order]  # (C*CLUSTER, 3, 3)
        self.n_clusters = v.shape[0] // CLUSTER
        vc = v.reshape(self.n_clusters, CLUSTER * 3, 3)
        # Boxes padded by a millionth of the mesh's extent, so that no
        # rounding of the slab test drops a face a ray meets.
        pad_w = (tri.reshape(-1, 3).amax(0) - tri.reshape(-1, 3).amin(0)).amax() * 1e-6 + 1e-6
        self.box_lo = vc.amin(1) - pad_w
        self.box_hi = vc.amax(1) + pad_w
        self.root_lo = self.box_lo.amin(0)
        self.root_hi = self.box_hi.amax(0)
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        vn = _cross(v1 - v0, v2 - v0)
        self.vn = vn
        self.inv_vn_len = 1.0 / torch.clamp_min(torch.sqrt(torch.clamp_min(_dot(vn, vn), 1e-24)), 1e-30)
        self.vn_v0 = _dot(vn, v0)
        avn = vn.abs()
        use_x = (avn[:, 0] >= avn[:, 1]) & (avn[:, 0] >= avn[:, 2])
        use_y = ~use_x & (avn[:, 1] >= avn[:, 0]) & (avn[:, 1] >= avn[:, 2])
        # Projection: (y, z) on the x axis, (x, z) on y, (x, y) on z.
        self.ax0 = torch.where(use_x, 1, 0).to(torch.int64)
        self.ax1 = torch.where(use_x | use_y, 2, 1).to(torch.int64)
        pv = torch.stack([torch.stack([vk.gather(1, self.ax0[:, None])[:, 0],
                                       vk.gather(1, self.ax1[:, None])[:, 0]], -1)
                          for vk in (v0, v1, v2)], 1)  # (F, 3, 2)
        self.pv = pv.to(dt)

    def _slab(self, o, inv_d, lo, hi):
        ta = (lo - o) * inv_d
        tb = (hi - o) * inv_d
        return torch.minimum(ta, tb).amax(-1), torch.maximum(ta, tb).amin(-1)

    def face_test(self, faces, o, d, side: str):
        """(t, front, ok) of rays o, d (P,3) against faces (P, K)."""
        vn = self.vn[faces]
        tdiv = _dot(vn, d[:, None, :])
        dlen = torch.sqrt(torch.clamp_min(_dot(d, d), 1e-24))[:, None]
        pd = tdiv * self.inv_vn_len[faces] / torch.clamp_min(dlen, 1e-30)
        ok = pd.abs() >= PERP_EPS
        t = (self.vn_v0[faces] - _dot(vn, o[:, None, :])) / torch.where(tdiv == 0.0, 1e-30, tdiv)
        ok = ok & (t > 0.0)
        front = tdiv < 0.0
        if side == "front":
            ok = ok & front
        a0i, a1i = self.ax0[faces], self.ax1[faces]
        qx = o.gather(1, a0i) + t * d.gather(1, a0i)
        qy = o.gather(1, a1i) + t * d.gather(1, a1i)
        pv = self.pv[faces]  # (P, K, 3, 2)
        px, py = pv[..., 0] - qx[..., None], pv[..., 1] - qy[..., None]
        a0 = (px[..., 1] * py[..., 2] - py[..., 1] * px[..., 2]) * 0.5
        a1 = (px[..., 2] * py[..., 0] - py[..., 2] * px[..., 0]) * 0.5
        a2 = (px[..., 0] * py[..., 1] - py[..., 0] * px[..., 1]) * 0.5
        ok = ok & (((a0 >= 0.0) & (a1 >= 0.0) & (a2 >= 0.0))
                   | ((a0 < 0.0) & (a1 < 0.0) & (a2 < 0.0)))
        return t, front, ok

    def _pairs(self, o, d, t_far):
        """Yield (ray index, cluster) pairs, in steps, whose cluster box the
        ray enters before t_far."""
        inv_d = 1.0 / torch.where(d == 0.0, 1e-30, d)
        lo, hi = self._slab(o, inv_d, self.root_lo, self.root_hi)
        live = torch.nonzero((lo <= hi) & (hi >= 0.0) & (lo < t_far)).reshape(-1)
        for s in range(0, live.shape[0], _RAYS):
            r = live[s:s + _RAYS]
            lo, hi = self._slab(o[r, None, :], inv_d[r, None, :], self.box_lo, self.box_hi)
            m = (lo <= hi) & (hi >= 0.0) & (lo < t_far[r, None])
            ri, ci = torch.nonzero(m, as_tuple=True)
            for p in range(0, ri.shape[0], _PAIRS):
                yield r[ri[p:p + _PAIRS]], ci[p:p + _PAIRS]

    def _faces(self, ci):
        k = ci[:, None] * CLUSTER + torch.arange(CLUSTER, device=ci.device)
        return self.order[k]

    def closest(self, o, d, side: str, t_best):
        """(t, face) of the closest face hit of each ray strictly below
        t_best, the lowest face id among faces at that t; (BIG, -1) where
        none."""
        n = o.shape[0]
        bt = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
        bf = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        if self.n_faces == 0:
            return bt, bf
        rays, tmins, fmins = [], [], []
        for ri, ci in self._pairs(o, d, t_best):
            faces = self._faces(ci)
            t, _, ok = self.face_test(faces, o[ri], d[ri], side)
            tc = torch.where(ok, t, BIG)
            pmin = tc.amin(1)
            # The lowest face of the cluster at its least t.
            fmin = torch.where(tc == pmin[:, None], faces, 1 << 40).amin(1)
            keep = pmin < BIG
            rays.append(ri[keep])
            tmins.append(pmin[keep])
            fmins.append(fmin[keep])
        if not rays:
            return bt, bf
        ri, tmin, fmin = torch.cat(rays), torch.cat(tmins), torch.cat(fmins)
        bt.scatter_reduce_(0, ri, tmin, "amin")
        at = tmin == bt[ri]
        best = torch.full((n,), 1 << 40, dtype=torch.int64, device=o.device)
        best.scatter_reduce_(0, ri[at], fmin[at], "amin")
        ok = (bt < t_best) & (best < (1 << 40))
        return torch.where(ok, bt, BIG), torch.where(ok, best, -1)

    def anyhit(self, o, d, t_max):
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        if self.n_faces == 0:
            return occ
        for ri, ci in self._pairs(o, d, t_max):
            t, _, ok = self.face_test(self._faces(ci), o[ri], d[ri], "front")
            h = (ok & (t > MESH_BIAS) & (t < t_max[ri][:, None])).any(1)
            occ[ri[h]] = True
        return occ


class Tracer:
    """Closest hits and occlusion against one Scene."""

    def __init__(self, scene):
        self.scene = scene
        self.mesh = MeshClusters(scene.tri().detach())

    def closest(self, o, d, side: str) -> Hits:
        sc = self.scene
        n = o.shape[0]
        bt = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
        kind = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        idx = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        front = torch.zeros(n, dtype=torch.bool, device=o.device)
        for k in range(sc.sph.shape[0]):
            t, fr = sphere_hit(sc.sph[k], o, d, side)
            u = t < bt
            bt = torch.where(u, t, bt)
            kind = torch.where(u, KIND_SPHERE, kind)
            idx = torch.where(u, k, idx)
            front = torch.where(u, fr, front)
        for k in range(sc.pln.shape[0]):
            t, fr = plane_hit(sc.pln[k], o, d, side)
            u = t < bt
            bt = torch.where(u, t, bt)
            kind = torch.where(u, KIND_PLANE, kind)
            idx = torch.where(u, k, idx)
            front = torch.where(u, fr, front)
        mt, mf = self.mesh.closest(o, d, side, bt)
        u = mf >= 0
        if u.any():
            fr = _dot(self.mesh.vn[mf.clamp_min(0)], d) < 0.0
            bt = torch.where(u, mt, bt)
            kind = torch.where(u, KIND_MESH, kind)
            idx = torch.where(u, mf, idx)
            front = torch.where(u, fr, front)
        return Hits(t=bt, kind=kind, idx=idx, front=front, hit=bt < BIG)

    def occluded(self, o, d, t_max, ana_bias: float):
        sc = self.scene
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for k in range(sc.sph.shape[0]):
            ol, dl = local_ray(sc.sph[k], o, d)
            a = _dot(dl, dl)
            b = 2.0 * _dot(dl, ol)
            c = _dot(ol, ol) - 1.0
            disc = b * b - 4.0 * a * c
            near = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / torch.clamp_min(2.0 * a, 1e-30)
            occ |= (disc > 0.0) & (near > ana_bias) & (near < t_max)
        for k in range(sc.pln.shape[0]):
            ol, dl = local_ray(sc.pln[k], o, d)
            dz = dl[:, 2]
            t = -ol[:, 2] / torch.where(dz == 0.0, 1e-30, dz)
            x = ol[:, 0] + t * dl[:, 0]
            y = ol[:, 1] + t * dl[:, 1]
            occ |= ((dz != 0.0) & (t >= 0.0) & (x.abs() <= 1.0) & (y.abs() <= 1.0)
                    & (t > ana_bias) & (t < t_max))
        rest = torch.nonzero(~occ).reshape(-1)
        if rest.numel():
            occ[rest] = self.mesh.anyhit(o[rest], d[rest], t_max[rest])
        return occ
