"""Fused shade setup (kernel 3): resolve + material + Fresnel + light
sampling + BRDF + GI lobe per lane.

Ports `shade_setup` of bhraytracer_tpu/ops/pallas_shade.py formula for
formula (`_shade_kernel`, :208-448), with its `_safe_pow`, `_safe_div` and
`_crossing_vector` guards and its algebraic sampler forms. Inputs and
outputs are structure-of-arrays planes:

  planes (6,N) f32   [ox oy oz dx dy dz]
  hits   (4,N) i32   [kind, inst, face, front | shade << 1]
  u      (13,N) f32  the level's uniform table, transposed
  out    (37,N) f32  [p 3, n 3, z, mtl, shadow_o 3, shadow_d 3, shadow_tmax,
                      gate, rr0, cos_theta, irr 3, brdf_cos 3, gi_o 3,
                      gi_d 3, gi_albedo 3, refr_eff 3, cos_phi1]

The mesh branch gathers its face's resolve row (F,32) by face id itself;
the instance (I,22), material (M,11) and light (L,9) tables are those of
`shade_tables` (pallas_shade.py:455-486).

`shade_setup` dispatches on the device: a CUDA tensor goes to the kernel in
csrc/shade.cu, a CPU tensor to `shade_setup_ref`, the plain PyTorch twin
that computes the same formulas in the same order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bhraytracer_tpu_torch.ops import kernels
from bhraytracer_tpu_torch.ops.linalg import BIG

TWO_PI = 2.0 * math.pi
MAX_INST = 32
MAX_MTL = 32
MAX_LIGHTS = 8
N_OUT = 37
_MISS_O = (1.0e8, 1.0e8, 1.0e8)
_MISS_D = (0.0, 0.0, 1.0)


class ShadeSetup(NamedTuple):
    """Per-lane outputs (pallas_shade.py:60-78); (N,3) fields are views of
    the output planes."""
    p: torch.Tensor
    n: torch.Tensor
    z: torch.Tensor
    mtl: torch.Tensor  # (N,) i32
    shadow_o: torch.Tensor
    shadow_d: torch.Tensor
    shadow_tmax: torch.Tensor
    gate: torch.Tensor  # (N,) bool: lanes whose visibility can zero direct
    rr0: torch.Tensor  # (N,) bool: point light at zero distance
    cos_theta: torch.Tensor
    irr: torch.Tensor  # irradiance without the visibility factor
    brdf_cos: torch.Tensor
    gi_o: torch.Tensor
    gi_d: torch.Tensor
    gi_albedo: torch.Tensor
    refr_eff: torch.Tensor
    cos_phi1: torch.Tensor


def check_supported(pack) -> None:
    """The fused kernel's gate (pallas_shade.py:501-511)."""
    n_inst = pack.n_sph + pack.n_pln + pack.n_msh
    if not (0 < n_inst <= MAX_INST and pack.mtl_gloss.shape[0] <= MAX_MTL
            and 0 < pack.n_lights <= MAX_LIGHTS):
        raise NotImplementedError(
            f"{n_inst} instances, {pack.mtl_gloss.shape[0]} materials, "
            f"{pack.n_lights} lights: the fused shade kernel takes 1-{MAX_INST}"
            f" instances, <= {MAX_MTL} materials and 1-{MAX_LIGHTS} lights; "
            "larger scenes need the unfused shading path (ROADMAP Queue 1, "
            "item 8)")


def shade_tables(pack):
    """(inst (I,22), mtl (M,11), light (L,9)) float32 row tables:
    inst [itm 9, tm 9, pos 3, mtl] over [spheres | planes | meshes], mtl
    [diffuse 3, specular 3, gloss, refraction 3, ior], light [kind,
    intensity 3, vec 3, size, selection probability]."""
    parts = []
    for itm, tm, pos, mtl, nk in (
            (pack.sph_itm, pack.sph_tm, pack.sph_pos, pack.sph_mtl, pack.n_sph),
            (pack.pln_itm, pack.pln_tm, pack.pln_pos, pack.pln_mtl, pack.n_pln),
            (pack.msh_itm, pack.msh_tm, pack.msh_pos, pack.msh_mtl, pack.n_msh)):
        if nk:
            parts.append(torch.cat([itm.reshape(-1, 9), tm.reshape(-1, 9), pos,
                                    mtl[:, None].float()], 1))
    inst = torch.cat(parts).float()
    mtl = torch.cat([pack.mtl_diffuse, pack.mtl_specular,
                     pack.mtl_gloss[:, None], pack.mtl_refraction,
                     pack.mtl_ior[:, None]], 1).float()
    li = pack.light_intensity
    gray = (li[:, 0] + li[:, 1] + li[:, 2]) / 3.0
    probs = gray / torch.clamp_min(gray.sum(), 1e-30)
    light = torch.cat([pack.light_kind[:, None].float(), li, pack.light_vec,
                       pack.light_size[:, None], probs[:, None]], 1).float()
    return inst.contiguous(), mtl.contiguous(), light.contiguous()


# ---------------------------------------------------------------------------
# component-triple helpers (pallas_shade.py:86-191)
# ---------------------------------------------------------------------------


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _normalize3(a):
    n = torch.clamp_min(torch.sqrt(torch.clamp_min(_dot3(a, a), 1e-24)), 1e-30)
    return (a[0] / n, a[1] / n, a[2] / n)


def _safe_pow(x, p):
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), p), 0.0)


def _safe_div(a, b):
    return a / torch.where(b.abs() < 1e-30, torch.where(b < 0, -1e-30, 1e-30), b)


def _crossing_vector(v):
    cz = (v[1], -v[0], torch.zeros_like(v[0]))
    degen = _dot3(cz, cz) < 1e-12
    one, zero = torch.ones_like(v[0]), torch.zeros_like(v[0])
    return (torch.where(degen, one, zero), zero, torch.where(degen, zero, one))


def _frame_axes(n):
    a1 = _normalize3(_cross3(_crossing_vector(n), n))
    return a1, _normalize3(_cross3(a1, n))


def _sample_along_normal(n, radius, u1, u2):
    r = torch.sqrt(u1) * radius
    th = u2 * TWO_PI
    a1, a2 = _frame_axes(n)
    return _add3(n, _add3(_scale3(a1, r * torch.cos(th)),
                          _scale3(a2, r * torch.sin(th))))


def _sample_along_light_direction(n, gloss, u1, u2):
    c = torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (gloss + 1.0))
    c = torch.clamp_max(c, 1.0)
    r = torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0)) / c
    phi = u2 * TWO_PI
    a1, a2 = _frame_axes(n)
    return _add3(n, _add3(_scale3(a1, r * torch.cos(phi)),
                          _scale3(a2, r * torch.sin(phi)))), c


def _sample_in_semisphere(n, u1, u2):
    a_y = _normalize3(_cross3(n, _crossing_vector(n)))
    a_x = _cross3(n, a_y)
    phi = u1 * TWO_PI
    x = torch.clamp(1.0 - 2.0 * u2, -1.0, 1.0)
    ct = torch.sqrt(torch.clamp_min((1.0 + x) * 0.5, 0.0))
    st = torch.sqrt(torch.clamp_min((1.0 - x) * 0.5, 0.0))
    sin2t = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    d = _add3(_add3(_scale3(a_x, st * torch.cos(phi)),
                    _scale3(a_y, st * torch.sin(phi))), _scale3(n, ct))
    return d, sin2t


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------


def shade_setup_ref(planes, hits, u, resolve_rows, inst_tab, n_sph: int,
                    n_pln: int, n_msh: int, mtl_tab, light_tab, bias: float):
    """Plain PyTorch twin of the shade kernel: (37,N) output planes."""
    o = (planes[0], planes[1], planes[2])
    d = (planes[3], planes[4], planes[5])
    kind, inst, face, flags = hits[0], hits[1], hits[2], hits[3]
    front = (flags & 1) != 0
    shade = (flags & 2) != 0
    n_inst = max(1, n_sph + n_pln + n_msh)

    flat = inst + torch.where(kind == 0, 0, torch.where(kind == 1, n_sph,
                                                        n_sph + n_pln))
    irow = inst_tab[flat.clamp(0, n_inst - 1).long()].T
    itm, tm = irow[0:9], irow[9:18]
    pos = (irow[18], irow[19], irow[20])
    imtl = irow[21]

    s = _sub3(o, pos)
    ol = (itm[0] * s[0] + itm[1] * s[1] + itm[2] * s[2],
          itm[3] * s[0] + itm[4] * s[1] + itm[5] * s[2],
          itm[6] * s[0] + itm[7] * s[1] + itm[8] * s[2])
    dl = (itm[0] * d[0] + itm[1] * d[1] + itm[2] * d[2],
          itm[3] * d[0] + itm[4] * d[1] + itm[5] * d[2],
          itm[6] * d[0] + itm[7] * d[1] + itm[8] * d[2])

    zero = torch.zeros_like(o[0])
    t_l, p_l, n_l = zero, (zero, zero, zero), (zero, zero, zero + 1.0)
    mtl_id = imtl

    if n_sph:
        a = _dot3(dl, dl)
        b = 2.0 * _dot3(dl, ol)
        c = _dot3(ol, ol) - 1.0
        sq = torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, 1e-24))
        inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-30)
        t_s = torch.where(front, (-b - sq) * inv2a, (-b + sq) * inv2a)
        p_s = _add3(ol, _scale3(dl, t_s))
        is_s = kind == 0
        t_l = torch.where(is_s, t_s, t_l)
        p_l = _where3(is_s, p_s, p_l)
        n_l = _where3(is_s, p_s, n_l)

    if n_pln:
        para = dl[2].abs() < 1e-12
        t_p = torch.where(para, 0.0, -ol[2]) / torch.where(para, 1.0, dl[2])
        p_p = _add3(ol, _scale3(dl, t_p))
        is_p = kind == 1
        t_l = torch.where(is_p, t_p, t_l)
        p_l = _where3(is_p, p_p, p_l)
        n_l = _where3(is_p, (zero, zero, zero + 1.0), n_l)

    if n_msh:
        rows = resolve_rows[face.clamp(0, resolve_rows.shape[0] - 1).long()].T
        v0 = (rows[0], rows[1], rows[2])
        v1 = (rows[3], rows[4], rows[5])
        v2 = (rows[6], rows[7], rows[8])
        vn = _cross3(_sub3(v1, v0), _sub3(v2, v0))
        tdiv = _dot3(vn, dl)
        graze = tdiv.abs() < 1e-12
        t_m = (torch.where(graze, 0.0, _dot3(vn, v0) - _dot3(vn, ol))
               / torch.where(graze, 1.0, tdiv))
        p_m = _add3(ol, _scale3(dl, t_m))
        avx, avy, avz = vn[0].abs(), vn[1].abs(), vn[2].abs()
        use_x = (avx >= avy) & (avx >= avz)
        use_y = ~use_x & (avy >= avx) & (avy >= avz)

        def proj(p):
            return (torch.where(use_x, p[1], p[0]),
                    torch.where(use_x, p[2], torch.where(use_y, p[2], p[1])))

        p0x, p0y = proj(v0)
        p1x, p1y = proj(v1)
        p2x, p2y = proj(v2)
        pxx, pxy = proj(p_m)

        def cr2(ax, ay, bx, by):
            return ax * by - ay * bx

        a0 = cr2(p1x - pxx, p1y - pxy, p2x - pxx, p2y - pxy) * 0.5
        a1_ = cr2(p2x - pxx, p2y - pxy, p0x - pxx, p0y - pxy) * 0.5
        a2_ = cr2(p0x - pxx, p0y - pxy, p1x - pxx, p1y - pxy) * 0.5
        asum = a0 + a1_ + a2_
        inv_asum = 1.0 / torch.where(asum.abs() < 1e-30, 1e-30, asum)
        b0, b1, b2 = a0 * inv_asum, a1_ * inv_asum, a2_ * inv_asum
        vn0 = (rows[9], rows[10], rows[11])
        vn1 = (rows[12], rows[13], rows[14])
        vn2 = (rows[15], rows[16], rows[17])
        n_m = _add3(_add3(_scale3(vn0, b0), _scale3(vn1, b1)),
                    _scale3(vn2, b2))
        is_m = kind == 2
        t_l = torch.where(is_m, t_m, t_l)
        p_l = _where3(is_m, p_m, p_l)
        n_l = _where3(is_m, n_m, n_l)
        mtl_id = torch.where(is_m, torch.where(imtl >= 0.0, imtl, rows[27]),
                             mtl_id)

    p_w = (tm[0] * p_l[0] + tm[1] * p_l[1] + tm[2] * p_l[2] + pos[0],
           tm[3] * p_l[0] + tm[4] * p_l[1] + tm[5] * p_l[2] + pos[1],
           tm[6] * p_l[0] + tm[7] * p_l[1] + tm[8] * p_l[2] + pos[2])
    n_w = _normalize3((itm[0] * n_l[0] + itm[3] * n_l[1] + itm[6] * n_l[2],
                       itm[1] * n_l[0] + itm[4] * n_l[1] + itm[7] * n_l[2],
                       itm[2] * n_l[0] + itm[5] * n_l[1] + itm[8] * n_l[2]))
    z = t_l

    # ---- material row + Schlick Fresnel (MtlBlinn.cpp:107-114) ----
    n_mtl = mtl_tab.shape[0]
    mrow = mtl_tab[mtl_id.clamp(0.0, float(n_mtl - 1)).long()].T
    diffuse = (mrow[0], mrow[1], mrow[2])
    specular = (mrow[3], mrow[4], mrow[5])
    gloss = mrow[6]
    refraction = (mrow[7], mrow[8], mrow[9])
    ior = mrow[10]

    vv = _normalize3(_sub3(o, p_w))
    cos_phi1 = torch.clamp(_dot3(n_w, vv), 0.0, 1.0)
    r0b = (1.0 - ior) / (1.0 + ior)
    r0 = r0b * r0b
    fres = r0 + (1.0 - r0) * _safe_pow(1.0 - cos_phi1, 5.0)
    new_spec = tuple(torch.clamp_max(specular[k] + fres * refraction[k], 1.0)
                     for k in range(3))
    refr_eff = tuple((1.0 - fres) * refraction[k] for k in range(3))

    # ---- one-light selection (MtlBlinn.cpp:309-315) ----
    n_lights = light_tab.shape[0]
    lsel = torch.full_like(kind, n_lights - 1)
    found = torch.zeros_like(shade)
    for k in range(n_lights):
        ok = u[7] <= light_tab[k, 8]
        lsel = torch.where(ok & ~found, k, lsel)
        found = found | ok
    lrow = light_tab[lsel.long()].T
    lkind = lrow[0]
    intensity = (lrow[1], lrow[2], lrow[3])
    lvec = (lrow[4], lrow[5], lrow[6])
    lsize = lrow[7]
    is_point = lkind == 2.0
    is_direct = lkind == 1.0

    # ---- GetSampleInLight (MtlBlinn.cpp:637-695) ----
    kd = torch.maximum(diffuse[0], torch.maximum(diffuse[1], diffuse[2]))
    ks = torch.maximum(new_spec[0], torch.maximum(new_spec[1], new_spec[2]))
    vl_c = _sub3(lvec, p_w)
    d_vl, d_cos = _sample_along_light_direction(_normalize3(vl_c), gloss,
                                                u[0], u[1])
    p_diffuse = _safe_pow(d_cos, gloss)
    big_r = torch.sqrt(u[2]) * lsize
    th = u[3] * TWO_PI
    a1 = _normalize3(_cross3(_crossing_vector(vl_c), vl_c))
    a2 = _normalize3(_cross3(a1, vl_c))
    s_vl = _add3(vl_c, _add3(_scale3(a1, big_r * torch.cos(th)),
                             _scale3(a2, big_r * torch.sin(th))))
    p_specular = 2.0 * u[2] / torch.clamp_min(big_r * big_r, 1e-30)
    pd = kd * p_diffuse
    ps = ks * p_specular
    pd_norm = _safe_div(pd, pd + ps)
    use_spec = u[4] >= pd_norm
    only_diffuse = (ks == 0.0) & (kd != 0.0)
    only_spec = (ks != 0.0) & (kd == 0.0)
    use_spec = (use_spec & ~only_diffuse) | only_spec
    vl_point = _where3(use_spec, _normalize3(s_vl), _normalize3(d_vl))
    nlvec = _normalize3(lvec)
    vl_other = _where3(is_direct, (-nlvec[0], -nlvec[1], -nlvec[2]),
                       (zero, zero, zero))
    vl = _where3(is_point, vl_point, vl_other)
    cos_theta = _dot3(vl, n_w)

    # ---- Illuminate, pre-visibility half (PointLight.cpp:7-18) ----
    center = _sub3(lvec, p_w)
    rr = _dot3(center, center)
    sdir = _sample_along_normal(center, lsize, u[5], u[6])
    sdir = _where3(lsize > 0.0, sdir, center)
    sh_d = _where3(is_point, sdir, (-lvec[0], -lvec[1], -lvec[2]))
    cand = shade & (cos_theta > 0.0) & (is_point | is_direct)
    sh_o = tuple(torch.where(cand, p_w[k], _MISS_O[k]) for k in range(3))
    sh_d = tuple(torch.where(cand, sh_d[k], _MISS_D[k]) for k in range(3))
    tmax = torch.where(cand, torch.where(is_point, 1.0, BIG), 0.0)
    rr0 = is_point & (rr == 0.0)
    inv_rr = 1.0 / torch.clamp_min(rr, 1e-30)
    irr = tuple(torch.where(is_point,
                            torch.where(rr0, BIG, intensity[k] * inv_rr),
                            intensity[k]) for k in range(3))

    # ---- BRDF * cos (MtlBlinn.cpp:317-327) ----
    vh = _normalize3(_add3(vl, vv))
    hn = torch.clamp_min(_dot3(vh, n_w), 0.0)
    spec_pow = _safe_pow(hn, gloss)
    brdf_cos = tuple(diffuse[k] * cos_theta + new_spec[k] * spec_pow
                     for k in range(3))

    # ---- GI lobe (MtlBlinn.cpp:354-433) ----
    d_dir, p_dt = _sample_in_semisphere(n_w, u[8], u[9])
    d_dir = _normalize3(d_dir)
    vr = _sub3(_scale3(n_w, 2.0 * _dot3(n_w, vv)), vv)
    s_dir, gi_scos = _sample_along_light_direction(vr, gloss, u[10], u[11])
    p_st = _safe_pow(gi_scos, gloss)
    gi_pd = _safe_div(kd * p_dt, kd * p_dt + ks * p_st)
    gi_spec = u[12] >= gi_pd
    gi_d = _where3(gi_spec, s_dir, d_dir)
    gi_o = _add3(p_w, _scale3(n_w, bias))
    albedo = _where3(gi_spec, new_spec, diffuse)

    return torch.stack([
        *p_w, *n_w, z, mtl_id,
        *sh_o, *sh_d, tmax, cand.float(), rr0.float(),
        cos_theta, *irr, *brdf_cos,
        *gi_o, *gi_d, *albedo,
        *refr_eff, cos_phi1])


# ---------------------------------------------------------------------------
# public entry points: kernel on CUDA, twin on CPU
# ---------------------------------------------------------------------------


def shade_planes(planes, hits, u, resolve_rows, inst_tab, n_sph: int,
                 n_pln: int, n_msh: int, mtl_tab, light_tab, bias: float):
    """The (37,N) output planes for SoA inputs (see module doc)."""
    n = planes.shape[1]
    dev = planes.device
    for name, x, dtype, shape in (
            ("planes", planes, torch.float32, (6, n)),
            ("hits", hits, torch.int32, (4, n)),
            ("u", u, torch.float32, (13, n)),
            ("resolve_rows", resolve_rows, torch.float32,
             (resolve_rows.shape[0], 32)),
            ("inst_tab", inst_tab, torch.float32, (inst_tab.shape[0], 22)),
            ("mtl_tab", mtl_tab, torch.float32, (mtl_tab.shape[0], 11)),
            ("light_tab", light_tab, torch.float32, (light_tab.shape[0], 9))):
        kernels.require(x.dtype == dtype, f"{name}: {dtype} expected")
        kernels.require(x.device == dev, f"{name}: on {x.device}, planes on {dev}")
        kernels.require(tuple(x.shape) == shape, f"{name}: shape {tuple(x.shape)}")
        kernels.require(x.is_contiguous(), f"{name}: not contiguous")
    kernels.require(inst_tab.shape[0] == max(1, n_sph + n_pln + n_msh)
                    and inst_tab.shape[0] <= MAX_INST, "inst_tab rows")
    kernels.require(0 < mtl_tab.shape[0] <= MAX_MTL, "mtl_tab rows")
    kernels.require(0 < light_tab.shape[0] <= MAX_LIGHTS, "light_tab rows")
    kernels.require(resolve_rows.shape[0] > 0, "resolve_rows is empty")
    kernels.require(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    if dev.type == "cpu":
        return shade_setup_ref(planes, hits, u, resolve_rows, inst_tab, n_sph,
                               n_pln, n_msh, mtl_tab, light_tab, bias)
    out = torch.empty((N_OUT, n), dtype=torch.float32, device=dev)
    if n:
        kernels.launch("bhrt_shade_setup", planes, hits, u, resolve_rows,
                       resolve_rows.shape[0], inst_tab, n_sph, n_pln, n_msh,
                       mtl_tab, mtl_tab.shape[0], light_tab,
                       light_tab.shape[0], float(bias), n, out)
    return out


def shade_inputs(o, d, hit, shade, u_tab):
    """(planes, hits, u) SoA inputs from (N,·) rays, a Hit and the (N,13)
    uniform table."""
    planes = torch.cat([o.T, d.T]).contiguous()
    flags = hit.front.to(torch.int32) | (shade.to(torch.int32) << 1)
    hits = torch.stack([hit.kind.to(torch.int32), hit.inst.to(torch.int32),
                        hit.face.to(torch.int32), flags]).contiguous()
    return planes, hits, u_tab.T.contiguous()


def split_planes(out) -> ShadeSetup:
    def v3(k):
        return out[k:k + 3].T

    return ShadeSetup(
        p=v3(0), n=v3(3), z=out[6], mtl=out[7].to(torch.int32),
        shadow_o=v3(8), shadow_d=v3(11), shadow_tmax=out[14],
        gate=out[15] > 0.0, rr0=out[16] > 0.0,
        cos_theta=out[17], irr=v3(18), brdf_cos=v3(21),
        gi_o=v3(24), gi_d=v3(27), gi_albedo=v3(30),
        refr_eff=v3(33), cos_phi1=out[36])


def shade_setup(pack, cfg, o, d, hit, shade, u_tab) -> ShadeSetup:
    """The fused shade setup over (N,) lanes; `shade` = active & hit.hit."""
    inst, mtl, light = shade_tables(pack)
    out = shade_planes(*shade_inputs(o, d, hit, shade, u_tab),
                       pack.resolve_rows, inst, pack.n_sph, pack.n_pln,
                       pack.n_msh, mtl, light, cfg.bias)
    return split_planes(out)
