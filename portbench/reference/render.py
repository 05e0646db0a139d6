"""The plain reference of one progressive pass: a wavefront path tracer
written from the reference renderer's semantics (Main.cpp's camera and
pixel loop, MtlBlinn.cpp's Blinn shading, light sampling, Fresnel
refraction chain with total internal reflection and Beer-Lambert
absorption, and its GI bounce), in plain PyTorch on any device and dtype.

It imports nothing of the program under test. It reproduces the renderer's
specified sample layout, so that each shade task draws the uniforms the
program's draws: the samples are the frozen threefry draw
(reference/threefry.py), keyed

  - pass key:   fold_in(fold_in(PRNGKey(seed), pass), 0) (one chunk: the
    whole frame);
  - camera jitter: fold_in(pass key, 0), counters lane * 2 + j;
  - level l:    fold_in(fold_in(pass key, 1), 100 + l); its shade table
    fold_in(level key, 1), counters slot * 13 + j; its refraction chain
    fold_in(level key, 2);

and a level's tasks sit in slots: [GI children, one per parent slot] ++
[refraction children, the parents that refract, in slot order, up to the
level's capacity]. The chain runs the renderer's two stages (full-width
trips, then the stragglers in a tail of 1/tail_divisor width), and a pass
whose levels drop tasks is rendered again with the renderer's escalated
capacities (`escalated`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import threefry as tf
from portbench.reference.intersect import (
    BIG,
    KIND_MESH,
    KIND_PLANE,
    KIND_SPHERE,
    Tracer,
    mat_vec,
)

TWO_PI = 2.0 * math.pi
NAN_PURPLE = (1.0, 0.0, 1.0)
CASE_NONE, CASE_FRONT, CASE_OUT, CASE_MISS = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Settings:
    """The render settings a pass runs (the configuration's depths and the
    renderer's defaults for the rest)."""

    gi_bounces: int = 3
    extra_refr_levels: int = 2
    tir_bounces: int = 16
    refr_capacity: float = 0.25
    tir_head_trips: int = 1
    tir_tail_divisor: int = 8
    tir_tail_compaction: bool = True
    bias: float = 1e-4
    shadow_bias: float = 1e-5
    refr_gloss_tries: int = 4

    @property
    def max_levels(self) -> int:
        return self.gi_bounces + 1 + self.extra_refr_levels

    def refr_cap(self, n: int) -> int:
        k = int(math.ceil(n * self.refr_capacity))
        return min(n, max(128, (k + 127) // 128 * 128))


def escalated(s: Settings, esc: int) -> Settings:
    """The settings of the esc-th re-render of a pass that dropped tasks:
    capacities doubled per retry, lossless as the last resort."""
    if s.refr_capacity * (2 ** esc) >= 1.0 or esc > 3:
        return dataclasses.replace(s, refr_capacity=1.0, tir_tail_compaction=False)
    return dataclasses.replace(
        s, refr_capacity=min(1.0, s.refr_capacity * (2 ** esc)),
        tir_head_trips=max(s.tir_head_trips, 3),
        tir_tail_divisor=max(1, s.tir_tail_divisor >> esc))


# ---------------------------------------------------------------------------
# vector helpers
# ---------------------------------------------------------------------------


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a):
    n = torch.sqrt(torch.clamp_min(dot(a, a), 1e-24))
    return a / torch.clamp_min(n, 1e-30)[..., None]


def safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 1e-24))


def safe_pow(x, p):
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), p), 0.0)


def safe_div(a, b):
    return a / torch.where(b.abs() < 1e-30, torch.where(b < 0, -1e-30, 1e-30), b)


def crossing_vector(v):
    """(0,0,1), or (1,0,0) where v is (anti)parallel to it."""
    degen = (v[..., 1] * v[..., 1] + v[..., 0] * v[..., 0] < 1e-12).to(v.dtype)
    return torch.stack([degen, torch.zeros_like(degen), 1.0 - degen], -1)


def frame_axes(n):
    a1 = normalize(cross(crossing_vector(n), n))
    return a1, normalize(cross(a1, n))


def along_lobe(n, gloss, u1, u2):
    """A direction around the (unnormalised) axis n in a cos^gloss lobe:
    (direction, cos of its angle)."""
    c = torch.clamp_max(torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (gloss + 1.0)), 1.0)
    r = safe_sqrt(torch.clamp_min(1.0 - c * c, 0.0)) / torch.clamp_min(c, 1e-30)
    phi = u2 * TWO_PI
    a1, a2 = frame_axes(n)
    return n + a1 * (r * torch.cos(phi))[..., None] + a2 * (r * torch.sin(phi))[..., None], c


def on_disc(n, radius, u1, u2):
    """A point of the disc of `radius` around the tip of n, normal to n."""
    r = torch.sqrt(u1) * radius
    th = u2 * TWO_PI
    a1, a2 = frame_axes(n)
    return n + a1 * (r * torch.cos(th))[..., None] + a2 * (r * torch.sin(th))[..., None]


def in_hemisphere(n, u1, u2):
    """A cosine-weighted direction around the unit normal n: (direction,
    sin 2 theta)."""
    a_y = normalize(cross(n, crossing_vector(n)))
    a_x = cross(n, a_y)
    phi = u1 * TWO_PI
    x = torch.clamp(1.0 - 2.0 * u2, -1.0, 1.0)
    ct = torch.sqrt(torch.clamp_min((1.0 + x) * 0.5, 0.0))
    st = torch.sqrt(torch.clamp_min((1.0 - x) * 0.5, 0.0))
    d = (a_x * (st * torch.cos(phi))[..., None] + a_y * (st * torch.sin(phi))[..., None]
         + n * ct[..., None])
    return d, torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))


def clamp_white(c):
    return torch.clamp_max(c, 1.0)


def env_valid(dirs):
    """Where the environment lookup is defined (|z| <= 1 and x, y not both
    0); elsewhere a miss adds nothing."""
    return (dirs[:, 2].abs() <= 1.0) & ((dirs[:, 0].abs() + dirs[:, 1].abs()) > 0.0)


def stable_partition(mask, k: int):
    """(k,) indices: the mask's lanes first, then the others, each in
    order, truncated to k."""
    m = mask.to(torch.int64)
    n = mask.shape[0]
    c = torch.cumsum(m, 0)
    n_true = c[-1:] if n else c
    pos = torch.where(mask, c - 1, n_true + torch.cumsum(1 - m, 0) - 1)
    out = torch.empty(n, dtype=torch.int64, device=mask.device)
    out[pos] = torch.arange(n, device=mask.device)
    return out[:k]


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------


class Renderer:
    """Renders passes of one scene at one size."""

    def __init__(self, scene, width: int, height: int, tracer=None):
        self.sc = scene
        self.tr = Tracer(scene) if tracer is None else tracer
        self.width, self.height = width, height
        self.dt, self.dev = scene.dtype, scene.device

    def vec(self, v):
        return torch.tensor(v, dtype=self.dt, device=self.dev)

    def surface(self, o, d, h):
        """(p, unit normal, material, t) of the hits h of rays o, d, t
        worked out again from the hit primitive (so that it is a function
        of the scene's tensors): the sphere's root on the hit's side, the
        plane's z = 0, the triangle's plane; p = o + t d. The sphere's
        normal is its local hit point mapped by the inverse transpose, the
        plane's +z mapped so, the triangle's the vertex normals weighted
        by the projected-area barycentrics."""
        sc = self.sc
        n_hits = o.shape[0]
        t = torch.zeros(n_hits, dtype=self.dt, device=self.dev)
        n = torch.zeros_like(o)
        mtl = torch.zeros_like(h.kind)
        for kind, rows, mtls in ((KIND_SPHERE, sc.sph, sc.sph_mtl),
                                 (KIND_PLANE, sc.pln, sc.pln_mtl)):
            sel = torch.nonzero(h.kind == kind).reshape(-1)
            if not sel.numel():
                continue
            r = rows[h.idx[sel]]
            inv = r[:, :9].reshape(-1, 3, 3)
            ol = mat_vec(inv, o[sel] - r[:, 9:12])
            dl = mat_vec(inv, d[sel])
            if kind == KIND_SPHERE:
                a = dot(dl, dl)
                b = 2.0 * dot(dl, ol)
                c = dot(ol, ol) - 1.0
                sq = safe_sqrt(b * b - 4.0 * a * c)
                inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-30)
                tk = torch.where(h.front[sel], (-b - sq) * inv2a, (-b + sq) * inv2a)
                nl = ol + tk[:, None] * dl
            else:
                para = dl[:, 2].abs() < 1e-12
                tk = torch.where(para, 0.0, -ol[:, 2]) / torch.where(para, 1.0, dl[:, 2])
                nl = torch.zeros_like(ol)
                nl[:, 2] = 1.0
            t = t.index_put((sel,), tk)
            n = n.index_put((sel,), normalize(mat_vec(inv.transpose(1, 2), nl)))
            mtl[sel] = mtls[h.idx[sel]]
        sel = torch.nonzero(h.kind == KIND_MESH).reshape(-1)
        if sel.numel():
            f = h.idx[sel]
            v = sc.verts[sc.faces[f]]  # (k, 3 corners, 3), node frame
            w = (sc.face_lin[f][:, None, :, :] * v[:, :, None, :]).sum(-1) + sc.face_pos[f][:, None, :]
            v0, v1, v2 = w[:, 0], w[:, 1], w[:, 2]
            vn = cross(v1 - v0, v2 - v0)
            tdiv = dot(vn, d[sel])
            graze = tdiv.abs() < 1e-12
            tk = (torch.where(graze, 0.0, dot(vn, v0) - dot(vn, o[sel]))
                  / torch.where(graze, 1.0, tdiv))
            q = o[sel] + tk[:, None] * d[sel]
            avn = vn.detach().abs()
            use_x = (avn[:, 0] >= avn[:, 1]) & (avn[:, 0] >= avn[:, 2])
            use_y = ~use_x & (avn[:, 1] >= avn[:, 0]) & (avn[:, 1] >= avn[:, 2])

            def proj(x):
                return (torch.where(use_x, x[:, 1], x[:, 0]),
                        torch.where(use_x | use_y, x[:, 2], x[:, 1]))

            (p0x, p0y), (p1x, p1y), (p2x, p2y), (qx, qy) = proj(v0), proj(v1), proj(v2), proj(q)
            a0 = ((p1x - qx) * (p2y - qy) - (p1y - qy) * (p2x - qx)) * 0.5
            a1 = ((p2x - qx) * (p0y - qy) - (p2y - qy) * (p0x - qx)) * 0.5
            a2 = ((p0x - qx) * (p1y - qy) - (p0y - qy) * (p1x - qx)) * 0.5
            asum = a0 + a1 + a2
            asum = torch.where(asum.abs() < 1e-30, 1e-30, asum)
            vnm = sc.tri_n[f]
            nm = ((a0 / asum)[:, None] * vnm[:, 0] + (a1 / asum)[:, None] * vnm[:, 1]
                  + (a2 / asum)[:, None] * vnm[:, 2])
            t = t.index_put((sel,), tk)
            n = n.index_put((sel,), normalize(nm))
            mtl[sel] = sc.tri_mtl[f]
        return o + t[:, None] * d, n, mtl, t

    # -----------------------------------------------------------------------
    # one level's shading of its hit tasks
    # -----------------------------------------------------------------------

    def shade(self, o, d, h, u, s: Settings):
        """Shading of hit tasks: dict of the direct term, Fresnel-weighted
        refraction colour, GI child and the surface."""
        sc = self.sc
        p, n, mtl, z = self.surface(o, d, h)
        diffuse, specular = sc.diffuse[mtl], sc.specular[mtl]
        gloss, refraction, ior = sc.gloss[mtl], sc.refraction[mtl], sc.ior[mtl]
        vv = normalize(o - p)
        cos_phi1 = torch.clamp(dot(n, vv), 0.0, 1.0)
        r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
        fres = r0 + (1.0 - r0) * safe_pow(1.0 - cos_phi1, 5.0)
        new_spec = clamp_white(specular + fres[:, None] * refraction)
        refr_eff = (1.0 - fres)[:, None] * refraction

        # One light, picked by its share of the gray intensity.
        nl = sc.light_prob.shape[0]
        lsel = torch.full_like(mtl, nl - 1)
        found = torch.zeros_like(cos_phi1, dtype=torch.bool)
        for k in range(nl):
            ok = u[:, 7] <= sc.light_prob[k]
            lsel = torch.where(ok & ~found, k, lsel)
            found = found | ok
        lkind = sc.light_kind[lsel]
        inten, lvec, lsize = sc.light_intensity[lsel], sc.light_vec[lsel], sc.light_size[lsel]
        is_point, is_direct = lkind == 2, lkind == 1

        # The shading direction toward the light: the diffuse lobe or the
        # light's disc, chosen by their weights.
        kd = diffuse.amax(1)
        ks = new_spec.amax(1)
        vl_c = lvec - p
        d_vl, d_cos = along_lobe(normalize(vl_c), gloss, u[:, 0], u[:, 1])
        p_diffuse = safe_pow(d_cos, gloss)
        big_r = torch.sqrt(u[:, 2]) * lsize
        th = u[:, 3] * TWO_PI
        a1 = normalize(cross(crossing_vector(vl_c), vl_c))
        a2 = normalize(cross(a1, vl_c))
        s_vl = vl_c + a1 * (big_r * torch.cos(th))[:, None] + a2 * (big_r * torch.sin(th))[:, None]
        p_specular = 2.0 * u[:, 2] / torch.clamp_min(big_r * big_r, 1e-30)
        pd = kd * p_diffuse
        pd_norm = safe_div(pd, pd + ks * p_specular)
        use_spec = u[:, 4] >= pd_norm
        use_spec = (use_spec & ~((ks == 0.0) & (kd != 0.0))) | ((ks != 0.0) & (kd == 0.0))
        vl_point = torch.where(use_spec[:, None], normalize(s_vl), normalize(d_vl))
        vl_other = torch.where(is_direct[:, None], -normalize(lvec), 0.0)
        vl = torch.where(is_point[:, None], vl_point, vl_other)
        cos_theta = dot(vl, n)

        # Illuminate: a shadow ray to a point of the light's disc, or along
        # a direct light.
        center = lvec - p
        rr = dot(center, center)
        sdir = torch.where((lsize > 0.0)[:, None], on_disc(center, lsize, u[:, 5], u[:, 6]), center)
        sh_d = torch.where(is_point[:, None], sdir, -lvec)
        gate = (cos_theta > 0.0) & (is_point | is_direct)
        tmax = torch.where(is_point, 1.0, BIG).to(self.dt)
        occ = torch.zeros_like(gate)
        gi = torch.nonzero(gate).reshape(-1)
        if gi.numel():
            occ[gi] = self.tr.occluded(p[gi].detach(), sh_d[gi].detach(), tmax[gi], s.shadow_bias)
        rr0 = is_point & (rr == 0.0)
        irr = torch.where(is_point[:, None],
                          torch.where(rr0[:, None], BIG, inten / torch.clamp_min(rr, 1e-30)[:, None]),
                          inten)
        vis = torch.where(occ & gate, 0.0, 1.0).to(self.dt)
        irr = irr * torch.where(rr0, 1.0, vis)[:, None]
        hn = torch.clamp_min(dot(normalize(vl + vv), n), 0.0)
        brdf_cos = diffuse * cos_theta[:, None] + new_spec * safe_pow(hn, gloss)[:, None]
        direct = clamp_white(torch.where((cos_theta > 0.0)[:, None], irr * brdf_cos, 0.0))
        direct = torch.where(torch.isnan(direct[:, 0:1]), 0.0, direct)

        # The GI lobe: the cosine hemisphere or the mirror lobe.
        d_dir, p_dt = in_hemisphere(n, u[:, 8], u[:, 9])
        d_dir = normalize(d_dir)
        vr = n * (2.0 * dot(n, vv))[:, None] - vv
        s_dir, s_cos = along_lobe(vr, gloss, u[:, 10], u[:, 11])
        p_st = safe_pow(s_cos, gloss)
        gi_spec = u[:, 12] >= safe_div(kd * p_dt, kd * p_dt + ks * p_st)
        gi_d = torch.where(gi_spec[:, None], s_dir, d_dir)
        albedo = torch.where(gi_spec[:, None], new_spec, diffuse)
        env = torch.where(env_valid(gi_d)[:, None], sc.environment * albedo, 0.0)
        degen = (gi_d[:, 0] == gi_d[:, 1]) & (gi_d[:, 0] == 0.0)
        gi_env = torch.where(degen[:, None], self.vec(NAN_PURPLE), env)
        return dict(p=p, n=n, mtl=mtl, z=z, vv=vv, cos_phi1=cos_phi1, refr_eff=refr_eff,
                    direct=direct, n_shadow=gate.sum(), gi_o=p + n * s.bias, gi_d=gi_d,
                    gi_albedo=albedo, gi_env=gi_env)

    # -----------------------------------------------------------------------
    # the refraction chain
    # -----------------------------------------------------------------------

    def glossy_refraction(self, vt, vn, rgloss, key, tag: int, want_negative: bool,
                          counters, s: Settings):
        """Up to refr_gloss_tries lobe samples around vt on the wanted side
        of vn (try k draws fold_in(key, tag + 2k) and fold_in(key, tag + 2k
        + 1) at the tasks' counters); the perfect direction otherwise."""
        keys = tf.fold_in(key, tag + torch.arange(2 * s.refr_gloss_tries, device=self.dev))
        us = tf.uniform_at(keys, counters).to(self.dt)
        chosen = normalize(vt)
        found = torch.zeros(vt.shape[0], dtype=torch.bool, device=self.dev)
        for k in range(s.refr_gloss_tries):
            cand, _ = along_lobe(vt, rgloss, us[2 * k], us[2 * k + 1])
            sign = dot(cand, vn)
            ok = (sign < 0.0) if want_negative else (sign > 0.0)
            chosen = torch.where((ok & ~found)[:, None], normalize(cand), chosen)
            found = found | ok
        return torch.where(((rgloss > 0.0) & found)[:, None], chosen, normalize(vt))

    def chain(self, p, vn, vv, cos_phi1, mtl, valid, bounce, key, width: int, s: Settings):
        """The enter / TIR / exit chain of the refraction slots (width
        slots, `valid` of them real): (case, child o, child d, bounce left,
        dropped, live trips). Out of place, so that autograd can follow
        it."""
        sc = self.sc
        ior = sc.ior[mtl]
        gloss = sc.gloss[mtl]
        rgloss = torch.where(gloss > 50.0, gloss, 0.0)
        slots = torch.arange(width, device=self.dev)
        sin1 = safe_sqrt(1.0 - cos_phi1 * cos_phi1)
        sin2 = sin1 / torch.clamp_min(ior, 1e-6)
        cos2 = safe_sqrt(1.0 - sin2 * sin2)
        vt = -cos2[:, None] * vn + normalize(cross(vn, cross(vn, vv))) * sin2[:, None]
        vt = self.glossy_refraction(vt, vn, rgloss, key, 20, True, slots, s)
        trip_key = tf.fold_in(key, 40)
        st = dict(p=p, nrm=vn, d=vt, bounce=bounce, settled=~valid,
                  case=torch.zeros(width, dtype=torch.int64, device=self.dev),
                  out_o=p, out_d=vt)

        def put(name, idx, val):
            st[name] = st[name].index_put((idx,), val)

        def trip(it, lanes, counters):
            """One trip of the lanes `lanes` still live; their number."""
            live = lanes[~st["settled"][lanes]]
            if not live.numel():
                return 0
            ro = st["p"][live] - st["nrm"][live] * s.bias
            rd = st["d"][live]
            h = self.tr.closest(ro.detach(), rd.detach(), "both")
            hp = torch.nonzero(h.hit).reshape(-1)
            pp = torch.zeros_like(ro)
            pn = torch.zeros_like(ro)
            if hp.numel():
                sub = type(h)(*(x[hp] for x in h))
                q, qn, _, _ = self.surface(ro[hp], rd[hp], sub)
                pp = pp.index_put((hp,), q)
                pn = pn.index_put((hp,), qn)
            miss = ~h.hit
            fh = h.hit & h.front
            bh = h.hit & ~h.front
            vv2 = -normalize(rd)
            c1 = dot(vv2, -pn)
            s2 = ior[live] * safe_sqrt(1.0 - c1 * c1)
            going_out = s2 <= 1.0
            c2 = safe_sqrt(1.0 - s2 * s2)
            vt2 = pn * c2[:, None] + normalize(cross(pn, cross(pn, vv2))) * s2[:, None]
            vt2 = self.glossy_refraction(vt2, pn, rgloss[live], tf.fold_in(trip_key, it), 0,
                                         False, counters[live], s)
            bl = st["bounce"][live]
            exhausted = bl <= 0
            exit_now = bh & going_out
            tir = bh & ~going_out & ~exhausted
            dead = bh & ~going_out & exhausted
            case = st["case"][live]
            case = torch.where(miss, CASE_MISS, case)
            case = torch.where(fh, CASE_FRONT, case)
            case = torch.where(exit_now, CASE_OUT, case)
            case = torch.where(dead, CASE_NONE, case)
            tr = tir[:, None]
            put("case", live, case)
            put("p", live, torch.where(tr, pp, st["p"][live]))
            put("nrm", live, torch.where(tr, pn, st["nrm"][live]))
            put("d", live, torch.where(tr, -2.0 * c1[:, None] * pn - vv2, st["d"][live]))
            put("bounce", live, torch.where(tir, bl - 1, bl))
            put("settled", live, miss | fh | exit_now | dead)
            put("out_o", live, torch.where(fh[:, None], ro, torch.where(
                exit_now[:, None], pp + pn * s.bias, st["out_o"][live])))
            put("out_d", live, torch.where(fh[:, None], rd, torch.where(
                exit_now[:, None], normalize(vt2), st["out_d"][live])))
            return live.numel()

        segs = 0
        it = 0
        head = min(s.tir_head_trips, s.tir_bounces + 1)
        while it < head and bool((~st["settled"]).any()):
            segs += trip(it, slots, slots)
            it += 1
        k2 = max(128, -(-width // s.tir_tail_divisor) // 128 * 128)
        dropped = 0
        if s.tir_tail_compaction and k2 < width:
            unsettled = ~st["settled"]
            sel = stable_partition(unsettled, k2)
            tail_slot = torch.full((width,), -1, dtype=torch.int64, device=self.dev)
            tail_slot[sel] = torch.arange(sel.shape[0], device=self.dev)
            kept = sel[unsettled[sel]]
            dropped = int(unsettled.sum()) - kept.numel()
            # Unsettled slots beyond the tail stay unsettled, with case NONE.
            while True:
                n_live = trip(it, kept, tail_slot)
                if not n_live:
                    break
                segs += n_live
                it += 1
        else:
            while bool((~st["settled"]).any()):
                segs += trip(it, slots, slots)
                it += 1
        return st["case"], st["out_o"], st["out_d"], st["bounce"], dropped, segs

    # -----------------------------------------------------------------------
    # levels, combine, pass
    # -----------------------------------------------------------------------

    def level(self, o, d, active, bounce, lvl: int, key, s: Settings):
        n = o.shape[0]
        dt, dev = self.dt, self.dev
        ai = torch.nonzero(active).reshape(-1)
        ha = self.tr.closest(o[ai].detach(), d[ai].detach(), "front")
        si = ai[ha.hit]
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        hit[si] = True
        hs = type(ha)(*(x[ha.hit] for x in ha))
        u = tf.uniform_table(tf.fold_in(key, 1), si, 13).to(dt)
        sh = self.shade(o[si], d[si], hs, u, s)

        def full(x, fill=0.0):
            base = torch.full((n,) + x.shape[1:], fill, dtype=x.dtype, device=dev)
            return base.index_put((si,), x)

        z = full(sh["z"], BIG)
        direct, refr_eff = full(sh["direct"]), full(sh["refr_eff"])
        cand = hit & (refr_eff != 0.0).any(1) & (bounce > 0)
        k_cap = s.refr_cap(n)
        sel = stable_partition(cand, k_cap)
        valid = cand[sel]
        p, nrm, mtl = full(sh["p"]), full(sh["n"]), full(sh["mtl"])
        vv, cos_phi1 = full(sh["vv"]), full(sh["cos_phi1"])
        case, ro, rd, bleft, drop_tir, chain_segs = self.chain(
            p[sel], nrm[sel], vv[sel], cos_phi1[sel], mtl[sel], valid, bounce[sel],
            tf.fold_in(key, 2), k_cap, s)
        has_child = ((case == CASE_FRONT) | (case == CASE_OUT)) & valid
        is_out = (case == CASE_OUT)[:, None]
        refr_mult = torch.where(is_out, refr_eff[sel], 1.0)
        refr_absorb = torch.where(is_out, self.sc.absorption[mtl[sel]], 0.0)
        refr_env = torch.where(env_valid(rd)[:, None], refr_mult * self.sc.environment, 0.0)
        refr_add = torch.where((case == CASE_MISS)[:, None], self.vec(NAN_PURPLE), 0.0)
        gi_on = s.gi_bounces - lvl >= 0
        rec = dict(active=active, hit=hit, z=z, direct=direct, sel=sel, valid=valid,
                   has_child=has_child, refr_mult=refr_mult, refr_absorb=refr_absorb,
                   refr_env=refr_env, refr_add=refr_add, gi_on=gi_on,
                   cand=cand, drop_refr=int(cand.sum()) - int(valid.sum()), drop_tir=drop_tir,
                   segs=int(active.sum()) + int(sh["n_shadow"]) + chain_segs)
        if gi_on:
            rec["gi_albedo"] = full(sh["gi_albedo"])
            rec["gi_env"] = full(sh["gi_env"])
            co = torch.cat([full(sh["gi_o"]), ro])
            cd = torch.cat([full(sh["gi_d"]), rd])
            ca = torch.cat([hit, has_child])
            cb = torch.cat([bounce, bleft])
        else:
            co, cd, ca, cb = ro, rd, has_child, bleft
        return rec, (co, cd, ca, cb)

    def combine(self, rec, c_rad, c_z, c_hit, s: Settings):
        n = rec["active"].shape[0]
        g = n if rec["gi_on"] else 0
        r_rad, r_z, r_hit = c_rad[g:], c_z[g:], c_hit[g:]
        absorb = torch.exp(-rec["refr_absorb"] * r_z[:, None])
        refr = torch.where(rec["has_child"][:, None],
                           torch.where(r_hit[:, None], clamp_white(rec["refr_mult"] * absorb * r_rad),
                                       clamp_white(rec["refr_env"])),
                           clamp_white(rec["refr_add"]))
        refr = torch.where(rec["valid"][:, None], refr, 0.0)
        out = torch.zeros((n, 3), dtype=self.dt, device=self.dev).index_put((rec["sel"],), refr)
        sat = (out >= 1.0).all(1)
        purple = self.vec(NAN_PURPLE)
        if rec["gi_on"]:
            g_rad, g_z, g_hit = c_rad[:g], c_z[:g], c_hit[:g]
            term = torch.where((g_hit & (g_z > s.bias))[:, None], g_rad * rec["gi_albedo"], 0.0)
            gi = torch.where(g_hit[:, None], term, rec["gi_env"])
            gi = clamp_white(torch.where(torch.isnan(gi[:, 0:1]), purple, gi))
            out = out + torch.where(sat[:, None], 0.0, gi)
            sat = (out >= 1.0).all(1)
        out = out + torch.where(sat[:, None], 0.0, rec["direct"])
        out = torch.where(torch.isnan(out[:, 0:1]), purple, out)
        return torch.where((rec["active"] & rec["hit"])[:, None], out, 0.0)

    def camera_rays(self, u):
        """Jittered rays through the image plane at distance focaldist;
        pixel positions are corners (the reference's integer division)."""
        sc = self.sc
        w, h = self.width, self.height
        n = w * h
        lane = torch.arange(n, device=self.dev)
        px, py = (lane % w).to(self.dt), (lane // w).to(self.dt)
        tan_h = math.tan(sc.fov / 2.0 * 3.14159265 / 180.0)
        ell = sc.focaldist
        hh = 2.0 * ell * tan_h
        ww = w / float(h) * hh
        cam_z = -sc.cam_dir
        cam_y = sc.cam_up
        cam_x = cross(cam_y, cam_z)
        top_left = sc.cam_pos - cam_z * ell + cam_y * (hh / 2.0) - cam_x * (ww / 2.0)
        dd_x, dd_y = cam_x * (ww / w), cam_y * (hh / h)
        center = top_left[None, :] + px[:, None] * dd_x[None, :] - py[:, None] * dd_y[None, :]
        plen = torch.sqrt(dot(dd_x, dd_x))
        jit = (normalize(dd_x)[None, :] * ((u[:, 0] * 2.0 - 1.0) * plen / 2.0)[:, None]
               + normalize(dd_y)[None, :] * ((u[:, 1] * 2.0 - 1.0) * plen / 2.0)[:, None])
        target = center + jit
        return sc.cam_pos.expand(target.shape).clone(), target - sc.cam_pos

    def chunk(self, ck, s: Settings):
        """(radiance (N,3), stats dict) of the whole frame as one chunk."""
        n = self.width * self.height
        lanes = torch.arange(n, device=self.dev)
        u = tf.uniform_table(tf.fold_in(ck, 0), lanes, 2).to(self.dt)
        o, d = self.camera_rays(u)
        active = torch.ones(n, dtype=torch.bool, device=self.dev)
        bounce = torch.full((n,), s.tir_bounces, dtype=torch.int64, device=self.dev)
        k1 = tf.fold_in(ck, 1)
        recs = []
        # The pixel each task belongs to, and the pixels with a refraction
        # candidate anywhere in their tree: only those share slots, and so
        # samples, with other pixels.
        owner = lanes
        involved = torch.zeros(n, dtype=torch.bool, device=self.dev)
        for lvl in range(s.max_levels):
            rec, (o, d, active, bounce) = self.level(o, d, active, bounce, lvl,
                                                     tf.fold_in(k1, 100 + lvl), s)
            recs.append(rec)
            involved[owner[rec["cand"]]] = True
            owner = (torch.cat([owner, owner[rec["sel"]]]) if rec["gi_on"]
                     else owner[rec["sel"]])
        m = o.shape[0]
        c_rad = torch.zeros((m, 3), dtype=self.dt, device=self.dev)
        c_z = torch.full((m,), BIG, dtype=self.dt, device=self.dev)
        c_hit = torch.zeros(m, dtype=torch.bool, device=self.dev)
        for rec in reversed(recs):
            c_rad = self.combine(rec, c_rad, c_z, c_hit, s)
            c_z, c_hit = rec["z"], rec["hit"]
        rad = torch.where(recs[0]["hit"][:, None], c_rad, self.sc.background)
        stats = {k: int(sum(int(r[k]) for r in recs)) for k in ("drop_refr", "drop_tir", "segs")}
        stats["involved"] = involved
        return rad, stats

    def render_pass(self, seed: int, sample: int, s: Settings):
        """(image (H, W, 3) linear radiance, stats) of pass `sample`: the
        frame's one sample at offset `sample`, re-rendered with escalated
        settings while it drops tasks. stats["involved"] (H, W) marks the
        pixels whose tree has a refraction candidate."""
        ck = tf.fold_in(tf.fold_in(tf.prng_key(seed, self.dev), sample), 0)
        run, esc = s, 0
        while True:
            rad, stats = self.chunk(ck, run)
            if not (stats["drop_refr"] or stats["drop_tir"]):
                break
            esc += 1
            run = escalated(s, esc)
        stats["escalations"] = esc
        stats["involved"] = stats["involved"].reshape(self.height, self.width)
        return rad.reshape(self.height, self.width, 3), stats
