"""The wavefront path-tracing integrator, forward render (the port of
bhraytracer_tpu/models/pathtracer.py).

A bounded-depth tree wavefront: level l is a flat batch of shade tasks;
`_shade_level` traces them, runs the fused shade setup (kernel 3), the
shadow trace, the compacted refraction/TIR chain (one closest trace per
trip) and the GI sample, and emits the next level's tasks. With texture
maps, a caustic photon map attached, or tables beyond the fused kernel's
(more than 32 instances or materials, no lights or more than 8), the shade
step is the unfused composition, with textured colours (ops/texturing.py)
and, with a map, the photon gather in its direct term (models/photonmap.py,
kernel 10), as the reference's fused kernel gates itself off there
(pallas_shade.py:501-511).
Level 0's closest and shadow traces take reorder=False, so they go through
the BVH kernels (4-5) on mesh scenes; every other trace takes reorder=True:
the flat stream kernels (1-2), the grouped ones (6-7) above 8192 faces, or
the BVH kernels again above the grouped kernels' 197,632 faces
(ops/trace.py:trace_route; bhraytracer_tpu/models/pathtracer.py:683-726,
816-821); mesh-free scenes take the analytic kernels (8-9). A backward
sweep (`_combine_tree`) combines radiance bottom-up with the reference's
per-stage clamp and early-out semantics (MtlBlinn.cpp:79-83, 117-131).

RNG is the JAX package's threefry chain, bit for bit (ops/rng.py): chunk
key fold_in(fold_in(PRNGKey(seed), sample), start), raygen key
fold_in(ck, 0), level key fold_in(fold_in(ck, 1), 100 + level), per-level
uniforms fold_in(level_key, 1), chain key fold_in(level_key, 2).

The device is the pack's: on the card every trace and shade setup is a
hand-written CUDA kernel; on the CPU the same code runs their twins.

Gradients (cfg.differentiable): `_render_chunk` is a plain function of
the pack's and the camera's tensors, and torch.autograd differentiates it
as JAX differentiates the reference's `_render_chunk`: traces run on
detached rays (ops/trace.py), so the kernels run forward only, and the
shading math recomputes everything continuous from the frozen hit ids;
the shade step is unfused, mesh hits resolve through rows rebuilt from
the vertex pools (`rows_from_pools`), and every scatter is out of place.
The refraction chain keeps its while loops: the JAX package's fixed-trip
scans are a fixpoint of the same trips, so the values are equal.

Lane frames (`frame=`, ops/compact.py:LaneFrame): a rank of a sharded
train step renders some of the lanes of one process's chunk, and its
frame gives their global rows. Every draw then takes its rows of the
table one process would draw (rng.uniform_rows), every compaction keeps
and numbers the candidates as one process would (global_partition, one
exchange of counts a compaction), capacities come from the global
widths, and a rank builds its kept candidates alone: no filler slots,
which no output reads. Without a frame, a chunk is the one process.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.models.denoiser import denoise, load_pretrained
from bhraytracer_tpu_torch.models.photonmap import (
    build_photon_map,
    gather_irradiance,
)
from bhraytracer_tpu_torch.ops import rng
from bhraytracer_tpu_torch.ops.camera import (
    camera_basis,
    from_scene_camera,
    gen_rays,
)
from bhraytracer_tpu_torch.ops.compact import (
    global_partition,
    lookup_rows,
    partition_indices,
)
from bhraytracer_tpu_torch.ops.linalg import (
    BIG,
    cross,
    dot,
    normalize,
    safe_div,
    safe_pow,
    safe_sqrt,
)
from bhraytracer_tpu_torch.ops.sampling import (
    crossing_vector,
    sample_along_light_direction,
    sample_along_normal,
    sample_in_semisphere,
)
from bhraytracer_tpu_torch.ops.shade import shade_setup, shade_setup_supported
from bhraytracer_tpu_torch.ops.texturing import (
    sample_background,
    sample_environment,
    textured_color,
)
from bhraytracer_tpu_torch.ops.trace import (
    Surface,
    check_traceable,
    resolve_hit,
    rows_from_pools,
    trace_closest,
    trace_shadow,
)
from bhraytracer_tpu_torch.utils.checkpoint import (
    load_render_state,
    save_render_state,
)

NAN_PURPLE = (1.0, 0.0, 1.0)  # Color::NANPurple (cyColor.h:130)
_MISS_O = (1.0e8, 1.0e8, 1.0e8)  # canonical miss ray for dead lanes
_MISS_D = (0.0, 0.0, 1.0)

_CASE_NONE = 0  # no refraction / budget exhausted -> black
_CASE_FRONT = 1  # chain hit a front face: child Shade of that hit
_CASE_OUT = 2  # exited the medium: child tinted by refraction * absorption
_CASE_MISS = 3  # inner trace escaped the scene -> NANPurple sentinel


class LevelRecord(NamedTuple):
    """Per-task values saved at each tree level for the backward combine
    (field docs: bhraytracer_tpu/models/pathtracer.py:96-136)."""

    active: torch.Tensor  # (N,)
    hit: torch.Tensor  # (N,)
    z: torch.Tensor  # (N,)
    direct: torch.Tensor  # (N,3)
    gi_albedo: torch.Tensor  # (N,3)
    gi_env: torch.Tensor  # (N,3)
    refr_sel: torch.Tensor  # (K,) parent lane of each refraction slot
    refr_valid: torch.Tensor  # (K,)
    refr_has_child: torch.Tensor  # (K,)
    refr_mult: torch.Tensor  # (K,3)
    refr_absorb: torch.Tensor  # (K,3)
    refr_env: torch.Tensor  # (K,3)
    refr_add: torch.Tensor  # (K,3)
    gi_sel: torch.Tensor  # (G,) parent lane of each GI slot
    gi_valid: torch.Tensor  # (G,)
    drop_refr: torch.Tensor  # () refraction candidates beyond capacity
    drop_tir: torch.Tensor  # () TIR stragglers beyond the tail width
    drop_gi: torch.Tensor  # () live GI lanes beyond capacity
    # Active traced segments: live closest hits + issued shadow rays + live
    # chain trips (the benchmark's unit of work).
    segs: torch.Tensor  # ()


class Tasks(NamedTuple):
    o: torch.Tensor  # (N,3)
    d: torch.Tensor  # (N,3)
    active: torch.Tensor  # (N,) bool
    bounce: torch.Tensor  # (N,) i32 remaining reflect/refract budget


class ChunkStats(NamedTuple):
    """Summed over a chunk's shade tree: ints from render_image, 0-dim
    int64 tensors from trace_radiance / _render_chunk."""

    drop_refr: int
    drop_tir: int
    drop_gi: int
    segments: int


class Shading(NamedTuple):
    """What a level needs from its shade step (pathtracer.py:707-774)."""

    surf: Surface
    direct: torch.Tensor  # (N,3) clamped direct-light term
    n_shadow: torch.Tensor  # () lanes that issued a shadow query
    refr_eff: torch.Tensor  # (N,3) Fresnel-weighted refraction colour
    cos_phi1: torch.Tensor  # (N,)
    gi_o: torch.Tensor  # (N,3) GI child ray
    gi_d: torch.Tensor  # (N,3)
    gi_albedo: torch.Tensor  # (N,3) lobe albedo multiplying the GI child
    gi_env: torch.Tensor  # (N,3) contribution if the GI child misses


class Mtl(NamedTuple):
    diffuse: torch.Tensor
    diffuse_tm: torch.Tensor
    specular: torch.Tensor
    specular_tm: torch.Tensor
    gloss: torch.Tensor
    refraction: torch.Tensor
    refr_gloss: torch.Tensor
    ior: torch.Tensor
    absorption: torch.Tensor


def _vec(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _clamp_white(c):
    """ClampColorToWhite (MtlBlinn.cpp:79-83)."""
    return torch.clamp_max(c, 1.0)


def _fetch_mtl(pack, mtl_id) -> Mtl:
    i = mtl_id.clamp(0, pack.mtl_gloss.shape[0] - 1)
    return Mtl(*(lookup_rows(t, i) for t in (
        pack.mtl_diffuse, pack.mtl_diffuse_tm, pack.mtl_specular,
        pack.mtl_specular_tm, pack.mtl_gloss, pack.mtl_refraction,
        pack.mtl_refr_gloss, pack.mtl_ior, pack.mtl_absorption)))


# ---------------------------------------------------------------------------
# direct light and GI lobe, unfused (MtlBlinn.cpp:304-433)
# ---------------------------------------------------------------------------


def _select_light(pack, u):
    """One-light selection: the first light (ascending-intensity order)
    whose own share is >= u, else the last (MtlBlinn.cpp:309-315, no 1/pmf
    compensation, as the reference)."""
    gray = pack.light_intensity.sum(1) / 3.0
    probs = gray / torch.clamp_min(gray.sum(), 1e-30)
    ok = u[:, None] <= probs[None, :]
    return torch.where(ok.any(1), ok.to(torch.int32).argmax(1),
                       pack.light_kind.shape[0] - 1)


def _sample_in_light(pack, lidx, surf: Surface, mtl: Mtl, new_spec_color, u):
    """GetSampleInLight (MtlBlinn.cpp:637-695): the shading direction vL.
    u: (N, >=5) uniform columns."""
    kind, lvec, lsize = (lookup_rows(t, lidx) for t in (
        pack.light_kind, pack.light_vec, pack.light_size))
    kd = mtl.diffuse.amax(1)
    ks = new_spec_color.amax(1)
    vl_c = lvec - surf.p
    d_vl, d_cos = sample_along_light_direction(normalize(vl_c), mtl.gloss,
                                               u[:, 0], u[:, 1])
    p_diffuse = safe_pow(d_cos, mtl.gloss)
    r = u[:, 2]
    big_r = torch.sqrt(r) * lsize
    th = u[:, 3] * 2.0 * torch.pi
    a1 = normalize(cross(crossing_vector(vl_c), vl_c))
    a2 = normalize(cross(a1, vl_c))
    s_vl = (vl_c + a1 * (big_r * torch.cos(th))[:, None]
            + a2 * (big_r * torch.sin(th))[:, None])
    p_specular = 2.0 * r / torch.clamp_min(big_r * big_r, 1e-30)
    pd = kd * p_diffuse
    pd_norm = safe_div(pd, pd + ks * p_specular)
    use_spec = u[:, 4] >= pd_norm
    use_spec = use_spec & ~((ks == 0) & (kd != 0)) | ((ks != 0) & (kd == 0))
    vl_point = torch.where(use_spec[:, None], normalize(s_vl), normalize(d_vl))
    # Non-point lights: -Direction(p) (ambient -> zero vector).
    vl_other = torch.where((kind == 1)[:, None], -normalize(lvec), 0.0)
    return torch.where((kind == 2)[:, None], vl_point, vl_other)


def _illuminate(pack, cfg: RenderConfig, lidx, p, u, mask,
                reorder: bool = True):
    """Light::Illuminate with one shadow trace (lights.h:46-64,
    PointLight.cpp:7-18). Returns (irradiance (N,3), lanes that issued a
    real shadow query)."""
    kind, lvec, lsize, intensity = (lookup_rows(t, lidx) for t in (
        pack.light_kind, pack.light_vec, pack.light_size,
        pack.light_intensity))
    center_dir = lvec - p
    rr = dot(center_dir, center_dir)
    sdir = sample_along_normal(center_dir, lsize, u[:, 0], u[:, 1])
    sdir = torch.where((lsize > 0)[:, None], sdir, center_dir)
    is_point, is_direct = kind == 2, kind == 1
    cand = mask & (is_point | is_direct)
    shadow_o = torch.where(cand[:, None], p, _vec(_MISS_O, p))
    shadow_d = torch.where(cand[:, None],
                           torch.where(is_point[:, None], sdir, -lvec),
                           _vec(_MISS_D, p))
    t_max = torch.where(cand, torch.where(is_point, 1.0, BIG), 0.0)
    occ = trace_shadow(pack, shadow_o, shadow_d, t_max, cfg.shadow_bias,
                       plane_extent_bug=cfg.parity_plane_shadow_bug,
                       reorder=reorder)
    vis = torch.where(occ & cand, 0.0, 1.0)[:, None]
    irr_point = torch.where((rr == 0.0)[:, None], BIG,
                            intensity * vis / torch.clamp_min(rr, 1e-30)[:, None])
    irr = torch.where(is_point[:, None], irr_point,
                      torch.where(is_direct[:, None], intensity * vis,
                                  intensity))
    return irr, cand.sum()


def _surface_colors(pack, cfg: RenderConfig, surf: Surface, mtl: Mtl,
                    new_spec_color):
    """The textured diffuse and specular colours of the hit (TexturedColor,
    scene.h:410-411), computed once for the direct and the GI terms (the
    JAX package computes the same values in each, pathtracer.py:314-319,
    365-370); the untextured colours where the scene has no texture maps."""
    taps = cfg.texture_sample_count
    return (textured_color(pack, mtl.diffuse, mtl.diffuse_tm, surf.uvw,
                           surf.duvw, taps=taps),
            textured_color(pack, new_spec_color, mtl.specular_tm, surf.uvw,
                           surf.duvw, taps=taps))


def _direct_light(pack, cfg: RenderConfig, surf: Surface, mtl: Mtl,
                  new_spec_color, diff, spec, vn, vv, u, mask,
                  reorder: bool = True, pmap=None):
    """PathTracing_DiffuseNSpecular (MtlBlinn.cpp:304-351): (clamped direct
    term (N,3), shadow queries). The light pick takes the untextured
    colours (mtl.diffuse, new_spec_color), the BRDF the textured ones
    (diff, spec: _surface_colors). With a photon map, the caustic gather
    is added before the clamp (MtlBlinn.cpp:329-342)."""
    lidx = _select_light(pack, u[:, 7])
    vl = _sample_in_light(pack, lidx, surf, mtl, new_spec_color, u)
    cos_theta = dot(vl, vn)
    irrad, n_shadow = _illuminate(pack, cfg, lidx, surf.p, u[:, 5:7],
                                  mask & (cos_theta > 0), reorder)
    hn = torch.clamp_min(dot(normalize(vl + vv), vn), 0.0)
    brdf_cos = (diff * cos_theta[:, None]
                + spec * safe_pow(hn, mtl.gloss)[:, None])
    out = torch.where((cos_theta > 0)[:, None], irrad * brdf_cos, 0.0)
    if pmap is not None:
        c_irr, c_vl = gather_irradiance(pmap, surf.p, vn,
                                        k=cfg.photon_gather_max)
        c_cos = -dot(c_vl, vn)
        c_hn = torch.clamp_min(dot(normalize(c_vl + vv), vn), 0.0)
        c_brdf = diff + spec * (
            safe_pow(c_hn, mtl.gloss) / torch.clamp_min(c_cos, 1e-30))[:, None]
        out = out + torch.where((c_cos > 0)[:, None], c_brdf * c_irr, 0.0)
    out = _clamp_white(out)
    # NaN in direct -> black (MtlBlinn.cpp:344-347).
    return torch.where(torch.isnan(out[:, 0:1]), 0.0, out), n_shadow


def _gi_env(pack, gi_d, albedo):
    """The GI child's contribution if it misses, with the degenerate-
    direction sentinel (MtlBlinn.cpp:411-423)."""
    env, valid = sample_environment(pack, gi_d)
    env_term = torch.where(valid[:, None], env * albedo, 0.0)
    degen = (gi_d[:, 0] == gi_d[:, 1]) & (gi_d[:, 0] == 0.0)
    return torch.where(degen[:, None], _vec(NAN_PURPLE, gi_d), env_term)


def _gi_sample(pack, cfg: RenderConfig, surf: Surface, mtl: Mtl,
               new_spec_color, diff, spec, vn, vv, u):
    """PathTracing_GlobalIllumination's lobe (MtlBlinn.cpp:354-433): (gi_o,
    gi_dir, albedo, env_term). The lobe choice takes the untextured
    colours, the albedo the textured ones (diff, spec)."""
    kd = mtl.diffuse.amax(1)
    ks = new_spec_color.amax(1)
    d_dir, p_dt = sample_in_semisphere(vn, u[:, 0], u[:, 1])
    d_dir = normalize(d_dir)
    vr = 2.0 * dot(vn, vv, keepdim=True) * vn - vv
    s_dir, s_cos = sample_along_light_direction(vr, mtl.gloss, u[:, 2],
                                                u[:, 3])
    p_st = safe_pow(s_cos, mtl.gloss)
    use_spec = u[:, 4] >= safe_div(kd * p_dt, kd * p_dt + ks * p_st)
    gi_dir = torch.where(use_spec[:, None], s_dir, d_dir)  # spec unnormalised
    albedo = torch.where(use_spec[:, None], spec, diff)
    return (surf.p + vn * cfg.bias, gi_dir, albedo,
            _gi_env(pack, gi_dir, albedo))


# ---------------------------------------------------------------------------
# the shade step of a level: fused kernel, or the functions above
# ---------------------------------------------------------------------------


def _shade_fused(pack, cfg: RenderConfig, o, d, hit, shade, u_tab,
                 reorder: bool = True) -> Shading:
    """The fused shade setup (kernel 3 on the card, its twin on the CPU);
    only the shadow trace and its visibility fold stay outside
    (pathtracer.py:710-735). The main path's shade step. `reorder` routes
    the shadow trace (ops/trace.py:trace_route)."""
    n = o.shape[0]
    fo = shade_setup(pack, cfg, o, d, hit, shade, u_tab)
    surf = Surface(p=fo.p, n=fo.n, uvw=o.new_zeros((n, 3)),
                   duvw=o.new_zeros((n, 2, 3)), mtl=fo.mtl, z=fo.z,
                   front=hit.front)
    occ = trace_shadow(pack, fo.shadow_o, fo.shadow_d, fo.shadow_tmax,
                       cfg.shadow_bias,
                       plane_extent_bug=cfg.parity_plane_shadow_bug,
                       reorder=reorder)
    vis = torch.where(occ & fo.gate, 0.0, 1.0)
    # The point-light r^2 == 0 branch keeps BIG whatever the visibility.
    irr = fo.irr * torch.where(fo.rr0, 1.0, vis)[:, None]
    direct = torch.where((fo.cos_theta > 0.0)[:, None], irr * fo.brdf_cos, 0.0)
    direct = _clamp_white(direct)
    direct = torch.where(torch.isnan(direct[:, 0:1]), 0.0, direct)
    return Shading(surf=surf, direct=direct, n_shadow=fo.gate.sum(),
                   refr_eff=fo.refr_eff, cos_phi1=fo.cos_phi1, gi_o=fo.gi_o,
                   gi_d=fo.gi_d, gi_albedo=fo.gi_albedo,
                   gi_env=_gi_env(pack, fo.gi_d, fo.gi_albedo))


def _shade_unfused(pack, cfg: RenderConfig, o, d, hit, shade, u_tab,
                   reorder: bool = True, pmap=None, dd_x=None,
                   dd_y=None) -> Shading:
    """The same step from the separate functions (pathtracer.py:736-774,
    847-849): the JAX package's XLA shading path, for any number of
    instances, materials and lights (none included: the direct term is
    then zero). Textured scenes take it, with the hit's texture
    coordinates and, on planes, their ray differentials from the camera's
    pixel deltas dd_x, dd_y; renders with a photon map take it, with the
    caustic gather in the direct term; and so do scenes beyond the fused
    kernel's tables (ops/shade.py:shade_setup_supported). It is also the
    plain composition the tests hold the fused kernel to."""
    surf = resolve_hit(pack, o, d, hit, dd_x, dd_y)
    mtl = _fetch_mtl(pack, surf.mtl)
    vn = surf.n
    vv = normalize(o - surf.p)
    cos_phi1 = torch.clamp(dot(vn, vv), 0.0, 1.0)
    # Schlick Fresnel into the specular colour (MtlBlinn.cpp:107-114).
    r0_base = (1.0 - mtl.ior) / (1.0 + mtl.ior)
    r0 = r0_base * r0_base
    fres = r0 + (1.0 - r0) * safe_pow(1.0 - cos_phi1, 5.0)
    new_spec = _clamp_white(mtl.specular + fres[:, None] * mtl.refraction)
    diff, spec = _surface_colors(pack, cfg, surf, mtl, new_spec)
    direct, n_shadow = _direct_light(pack, cfg, surf, mtl, new_spec, diff,
                                     spec, vn, vv, u_tab[:, :8], shade,
                                     reorder, pmap)
    gi_o, gi_d, gi_albedo, gi_env = _gi_sample(pack, cfg, surf, mtl, new_spec,
                                               diff, spec, vn, vv,
                                               u_tab[:, 8:13])
    return Shading(surf=surf, direct=direct, n_shadow=n_shadow,
                   refr_eff=(1.0 - fres)[:, None] * mtl.refraction,
                   cos_phi1=cos_phi1, gi_o=gi_o, gi_d=gi_d,
                   gi_albedo=gi_albedo, gi_env=gi_env)


# ---------------------------------------------------------------------------
# refraction / TIR chain (MtlBlinn.cpp:437-589)
# ---------------------------------------------------------------------------


def _glossy_refr_dir(vt, vn, rgloss, key, tag: int, want_negative: bool,
                     tries: int, rows=None):
    """Fixed-try rejection resampling of the refraction direction
    (MtlBlinn.cpp:454-465, 560-572), falling back to the perfect one. Try k
    draws its two uniforms from fold_in(key, tag + 2k) and
    fold_in(key, tag + 2k + 1), all 2*tries streams in one call; with
    `rows`, the lanes' global slots, their rows of the global draws."""
    n = vt.shape[0]
    keys = rng.fold_in(key, tag + torch.arange(2 * tries, device=vt.device))
    us = (rng.uniform(keys, (n,)) if rows is None
          else rng.uniform_rows(keys, rows))
    chosen = normalize(vt)
    found = torch.zeros(n, dtype=torch.bool, device=vt.device)
    for k in range(tries):
        cand, _ = sample_along_light_direction(vt, rgloss, us[2 * k],
                                               us[2 * k + 1])
        sign = dot(cand, vn)
        ok = (sign < 0.0) if want_negative else (sign > 0.0)
        chosen = torch.where((ok & ~found)[:, None], normalize(cand), chosen)
        found = found | ok
    return torch.where(((rgloss > 0.0) & found)[:, None], chosen,
                       normalize(vt))


def _refraction_chain(pack, cfg: RenderConfig, surf: Surface, mtl: Mtl, vn,
                      vv, cos_phi1, refr_eff, active, bounce, key,
                      frame=None):
    """The enter/TIR/exit chain in two stages: tir_head_trips full-width
    trips, then the stragglers recompacted to 1/tir_tail_divisor width
    (pathtracer.py:573-613). Returns (case, child_o, child_d, bounce_left,
    dropped, segs). With a frame (the lanes' refraction slots), the widths
    are global and the tail compaction exchanges counts; a rank whose
    lanes have settled stops early, as trips of settled lanes change
    nothing and a trip's key depends on its number alone."""
    n = surf.p.shape[0]
    width = n if frame is None else frame.width
    rows = None if frame is None else frame.rows
    miss_o, miss_d = _vec(_MISS_O, vn), _vec(_MISS_D, vn)

    # --- entry refraction direction (MtlBlinn.cpp:443-465) ---
    sin1 = safe_sqrt(1.0 - cos_phi1 * cos_phi1)
    sin2 = sin1 / torch.clamp_min(mtl.ior, 1e-6)
    cos2 = safe_sqrt(1.0 - sin2 * sin2)
    vtn = -cos2[:, None] * vn
    vtp = normalize(cross(vn, cross(vn, vv))) * sin2[:, None]
    # Effective refraction glossiness: the Blinn glossiness when > 50, else
    # 0 (MtlBlinn.cpp:115-116).
    rgloss = torch.where(mtl.gloss > 50.0, mtl.gloss, 0.0)
    vt = _glossy_refr_dir(vtn + vtp, vn, rgloss, key, 20, True,
                          cfg.refr_gloss_tries, rows)
    chain_active = active & (refr_eff != 0.0).any(1) & (bounce > 0)
    trip_key = rng.fold_in(key, 40)

    s = dict(p=surf.p, nrm=vn, d=vt, bounce=bounce, settled=~chain_active,
             case=torch.zeros(n, dtype=torch.int32, device=vn.device),
             out_o=surf.p, out_d=vt,
             segs=torch.zeros((), dtype=torch.int64, device=vn.device))

    def trip(s, it, ior, rgl, rows):
        live = ~s["settled"]
        ray_o = torch.where(live[:, None], s["p"] - s["nrm"] * cfg.bias, miss_o)
        ray_d = torch.where(live[:, None], s["d"], miss_d)
        hit = trace_closest(pack, ray_o, ray_d, "both")
        sres = resolve_hit(pack, ray_o, ray_d, hit, minimal=True)
        miss = live & ~hit.hit
        front_hit = live & hit.hit & hit.front
        back_hit = live & hit.hit & ~hit.front
        # back face: exit or TIR (HandleRayWhenRefractionRayOut :543-589)
        vn2 = sres.n
        vv2 = -normalize(ray_d)
        c1 = dot(vv2, -vn2)
        s2 = ior * safe_sqrt(1.0 - c1 * c1)
        going_out = s2 <= 1.0
        c2 = safe_sqrt(1.0 - s2 * s2)
        vt2 = (vn2 * c2[:, None]
               + normalize(cross(vn2, cross(vn2, vv2))) * s2[:, None])
        vt2 = _glossy_refr_dir(vt2, vn2, rgl, rng.fold_in(trip_key, it), 0,
                               False, cfg.refr_gloss_tries, rows)
        out_o = sres.p + vn2 * cfg.bias
        vr = -2.0 * c1[:, None] * vn2 - vv2  # internal reflection (:582)
        exhausted = s["bounce"] <= 0
        exit_now = back_hit & going_out
        tir = back_hit & ~going_out & ~exhausted
        dead = back_hit & ~going_out & exhausted
        case = torch.where(miss, _CASE_MISS, s["case"])
        case = torch.where(front_hit, _CASE_FRONT, case)
        case = torch.where(exit_now, _CASE_OUT, case)
        case = torch.where(dead, _CASE_NONE, case).to(torch.int32)
        fh, ex, tr = front_hit[:, None], exit_now[:, None], tir[:, None]
        return dict(
            p=torch.where(tr, sres.p, s["p"]),
            nrm=torch.where(tr, vn2, s["nrm"]),
            d=torch.where(tr, vr, s["d"]),
            bounce=torch.where(tir, s["bounce"] - 1, s["bounce"]),
            settled=s["settled"] | miss | front_hit | exit_now | dead,
            case=case,
            out_o=torch.where(fh, ray_o, torch.where(ex, out_o, s["out_o"])),
            out_d=torch.where(fh, ray_d,
                              torch.where(ex, normalize(vt2), s["out_d"])),
            segs=s["segs"] + live.sum())

    it = 0
    head = min(cfg.tir_head_trips, cfg.tir_bounces + 1)
    while it < head and bool((~s["settled"]).any()):
        s = trip(s, it, mtl.ior, rgloss, rows)
        it += 1

    k2 = max(128, -(-width // cfg.tir_tail_divisor) // 128 * 128)
    dropped = torch.zeros((), dtype=torch.int64, device=vn.device)
    if cfg.tir_tail_compaction and k2 < width:
        unsettled = ~s["settled"]
        if frame is None:
            sel, tail_rows = partition_indices(unsettled, k2), None
        else:
            sel, tail_rows = global_partition(unsettled, k2, frame)
        sel_valid = unsettled[sel]  # unsettled first
        sub = {k: s[k][sel] for k in
               ("p", "nrm", "d", "bounce", "case", "out_o", "out_d")}
        sub["settled"] = ~sel_valid
        sub["segs"] = s["segs"]
        ior_k, rgl_k = mtl.ior[sel], rgloss[sel]
        while bool((~sub["settled"]).any()):
            sub = trip(sub, it, ior_k, rgl_k, tail_rows)
            it += 1
        # Out of place (index_put), so autograd keeps every value it saved.
        for k in ("case", "bounce", "out_o", "out_d"):
            v = sel_valid.reshape((-1,) + (1,) * (s[k].dim() - 1))
            s[k] = s[k].index_put((sel,), torch.where(v, sub[k], s[k][sel]))
        # Unsettled lanes that did not fit keep case NONE -> black: counted.
        dropped = unsettled.sum() - sel_valid.sum()
        segs = sub["segs"]
    else:
        while bool((~s["settled"]).any()):
            s = trip(s, it, mtl.ior, rgloss, rows)
            it += 1
        segs = s["segs"]
    return s["case"], s["out_o"], s["out_d"], s["bounce"], dropped, segs


# ---------------------------------------------------------------------------
# one tree level
# ---------------------------------------------------------------------------


def _shade_level(pack, cfg: RenderConfig, tasks: Tasks, level: int, key,
                 pmap=None, dd_x=None, dd_y=None, frame=None):
    """One tree level (pathtracer.py:625-920); dd_x, dd_y are the camera's
    pixel deltas, which the unfused step's plane ray differentials read at
    every level (the reference's globals). Returns (record, children,
    surface, the children's frame: None without a frame)."""
    n = tasks.o.shape[0]
    width = n if frame is None else frame.width
    act = tasks.active[:, None]
    o = torch.where(act, tasks.o, _vec(_MISS_O, tasks.o))
    d = torch.where(act, tasks.d, _vec(_MISS_D, tasks.o))

    # Level-0 camera rays arrive in scanline order, already coherent: the
    # BVH kernels (pathtracer.py:683-688, 721-726).
    reorder = level != 0
    hit = trace_closest(pack, o, d, "front", reorder=reorder)
    shade = tasks.active & hit.hit
    u_tab = (rng.uniform(rng.fold_in(key, 1), (n, 13)) if frame is None
             else rng.uniform_rows(rng.fold_in(key, 1), frame.rows, 13))
    if shade_setup_supported(pack, cfg, pmap):
        sh = _shade_fused(pack, cfg, o, d, hit, shade, u_tab, reorder)
    else:
        # Texture maps, a photon gather, or tables beyond the fused
        # kernel's: the reference shades such scenes unfused too
        # (pathtracer.py:710).
        sh = _shade_unfused(pack, cfg, o, d, hit, shade, u_tab, reorder, pmap,
                            dd_x, dd_y)
    surf = sh.surf

    # --- refraction chain on compacted refractive lanes ---
    chain_cand = shade & (sh.refr_eff != 0.0).any(1) & (tasks.bounce > 0)
    k_cap = cfg.refr_cap(width)
    if frame is None:
        sel, chain_frame = partition_indices(chain_cand, k_cap), None
    else:
        sel, slot = global_partition(chain_cand, k_cap, frame)
        chain_frame = frame._replace(rows=slot, width=k_cap,
                                     seg=frame.seg[sel])
    sel_valid = chain_cand[sel]  # candidates first
    surf_k = Surface(*[f[sel] for f in surf])
    mtl_k = _fetch_mtl(pack, surf_k.mtl)
    refr_eff_k = sh.refr_eff[sel]
    case, ro, rd, bounce_left, drop_tir, chain_segs = _refraction_chain(
        pack, cfg, surf_k, mtl_k, surf.n[sel], normalize(o[sel] - surf_k.p),
        sh.cos_phi1[sel], refr_eff_k, sel_valid, tasks.bounce[sel],
        rng.fold_in(key, 2), chain_frame)
    drop_refr = chain_cand.sum() - sel_valid.sum()
    segs = tasks.active.sum() + sh.n_shadow + chain_segs
    refr_has_child = ((case == _CASE_FRONT) | (case == _CASE_OUT)) & sel_valid
    is_out = (case == _CASE_OUT)[:, None]
    refr_mult = torch.where(is_out, refr_eff_k, 1.0)
    refr_absorb = torch.where(is_out, mtl_k.absorption, 0.0)
    env_r, env_r_valid = sample_environment(pack, rd)
    refr_env = torch.where(env_r_valid[:, None], refr_mult * env_r, 0.0)
    refr_add = torch.where((case == _CASE_MISS)[:, None], _vec(NAN_PURPLE, o),
                           0.0)

    # --- GI lobe ---
    drop_gi = torch.zeros((), dtype=torch.int64, device=o.device)
    gi_on = cfg.gi_active(level)
    g_cap = cfg.gi_cap(width) if gi_on else 0
    gi_frame = frame
    if gi_on:
        gi_o, gi_d, gi_albedo, gi_env = sh.gi_o, sh.gi_d, sh.gi_albedo, sh.gi_env
        if g_cap < width:
            # Missed / inactive lanes need no GI subtree.
            if frame is None:
                sel_g = partition_indices(shade, g_cap)
            else:
                sel_g, slot_g = global_partition(shade, g_cap, frame)
                gi_frame = frame._replace(rows=slot_g, seg=frame.seg[sel_g])
            sel_g_valid = shade[sel_g]
            drop_gi = shade.sum() - sel_g_valid.sum()
            gi_children = Tasks(o=gi_o[sel_g], d=gi_d[sel_g],
                                active=sel_g_valid,
                                bounce=tasks.bounce[sel_g])
        else:
            # Identity mapping: child row == parent lane.
            sel_g = torch.arange(n, device=o.device)
            sel_g_valid = shade
            gi_children = Tasks(o=gi_o, d=gi_d, active=shade,
                                bounce=tasks.bounce)
    else:
        gi_albedo = o.new_zeros((n, 3))
        gi_env = o.new_zeros((n, 3))
        sel_g = torch.zeros(0, dtype=torch.int64, device=o.device)
        sel_g_valid = torch.zeros(0, dtype=torch.bool, device=o.device)

    rec = LevelRecord(
        active=tasks.active, hit=hit.hit, z=surf.z, direct=sh.direct,
        gi_albedo=gi_albedo, gi_env=gi_env, refr_sel=sel,
        refr_valid=sel_valid, refr_has_child=refr_has_child,
        refr_mult=refr_mult, refr_absorb=refr_absorb, refr_env=refr_env,
        refr_add=refr_add, gi_sel=sel_g, gi_valid=sel_g_valid,
        drop_refr=drop_refr, drop_tir=drop_tir, drop_gi=drop_gi, segs=segs)

    # --- children: [compacted GI (G)] ++ [compacted refraction (K)] ---
    refr_children = Tasks(o=ro, d=rd, active=refr_has_child, bounce=bounce_left)
    if gi_on:
        children = Tasks(*[torch.cat([g, r]) for g, r in
                           zip(gi_children, refr_children)])
    else:
        children = refr_children
    if frame is None:
        return rec, children, surf, None
    # The children's rows: the GI slots', then G + the refraction slots,
    # in segments after the GI slots' own.
    n_gi_seg = frame.n_seg if gi_on else 0
    gi_rows, gi_seg = ((gi_frame.rows, gi_frame.seg) if gi_on
                       else (frame.rows[:0], frame.seg[:0]))
    child_frame = frame._replace(
        rows=torch.cat([gi_rows, g_cap + chain_frame.rows]),
        width=g_cap + k_cap,
        seg=torch.cat([gi_seg, n_gi_seg + chain_frame.seg]),
        n_seg=n_gi_seg + frame.n_seg)
    return rec, children, surf, child_frame


def _combine_level(cfg: RenderConfig, level: int, rec: LevelRecord,
                   child_rad, child_z, child_hit):
    """Backward combine: Shade's stage sums with clamp + early-out
    semantics (MtlBlinn.cpp:117-131). Children arrive as [gi (G)] ++
    [refr (K)]."""
    n = rec.active.shape[0]
    gi_on = cfg.gi_active(level)
    g_cap = rec.gi_sel.shape[0]  # the GI children here (0 without GI)
    r_rad, r_z, r_hit = child_rad[g_cap:], child_z[g_cap:], child_hit[g_cap:]

    # --- refraction term at K width, scattered to parent lanes ---
    absorb = torch.exp(-rec.refr_absorb * r_z[:, None])
    refr_k = torch.where(
        rec.refr_has_child[:, None],
        torch.where(r_hit[:, None],
                    _clamp_white(rec.refr_mult * absorb * r_rad),
                    _clamp_white(rec.refr_env)),
        _clamp_white(rec.refr_add))
    refr_k = torch.where(rec.refr_valid[:, None], refr_k, 0.0)
    out = refr_k.new_zeros((n, 3)).index_put((rec.refr_sel,), refr_k)
    sat = (out >= 1.0).all(1)

    nan_purple = _vec(NAN_PURPLE, out)
    if gi_on:
        g_rad, g_z, g_hit = (child_rad[:g_cap], child_z[:g_cap],
                             child_hit[:g_cap])
        if g_cap == n:
            albedo_g, env_g, hit_g = rec.gi_albedo, rec.gi_env, g_hit
        else:
            albedo_g = rec.gi_albedo[rec.gi_sel]
            env_g = rec.gi_env[rec.gi_sel]
            hit_g = g_hit & rec.gi_valid
        gi_hit_term = torch.where((hit_g & (g_z > cfg.bias))[:, None],
                                  g_rad * albedo_g, 0.0)
        gi_g = torch.where(hit_g[:, None], gi_hit_term, env_g)
        gi_g = torch.where(torch.isnan(gi_g[:, 0:1]), nan_purple, gi_g)
        gi_g = _clamp_white(gi_g)
        if g_cap == n:
            gi = gi_g
        else:
            # Parents without a slot keep their environment term.
            gi = torch.where(torch.isnan(rec.gi_env[:, 0:1]), nan_purple,
                             rec.gi_env)
            gi = _clamp_white(gi).index_put((rec.gi_sel,), gi_g)
        out = out + torch.where(sat[:, None], 0.0, gi)
        sat = (out >= 1.0).all(1)

    out = out + torch.where(sat[:, None], 0.0, rec.direct)
    out = torch.where(torch.isnan(out[:, 0:1]), nan_purple, out)
    return torch.where((rec.active & rec.hit)[:, None], out, 0.0)


def _combine_tree(cfg: RenderConfig, recs, probe):
    """Backward combine over all levels -> level-0 radiance; children of
    the last level contribute black."""
    m = probe.shape[0]
    child_rad = torch.zeros((m, 3), device=probe.device)
    child_z = torch.full((m,), BIG, device=probe.device)
    child_hit = torch.zeros(m, dtype=torch.bool, device=probe.device)
    for level in reversed(range(cfg.max_levels)):
        child_rad = _combine_level(cfg, level, recs[level], child_rad,
                                   child_z, child_hit)
        child_z, child_hit = recs[level].z, recs[level].hit
    return child_rad


# ---------------------------------------------------------------------------
# chunks and images
# ---------------------------------------------------------------------------


def _level_key(key, level: int):
    return rng.fold_in(rng.fold_in(key, 1), 100 + level)


def _pixels(width: int, height: int, chunk: int, start: int, device):
    """Pixel columns and rows of lanes start..start+chunk (clamped to the
    last pixel)."""
    idx = torch.clamp_max(start + torch.arange(chunk, device=device),
                          width * height - 1)
    return idx % width, idx // width


def _camera_rays(cfg: RenderConfig, cam, width: int, height: int, px, py,
                 key, rows=None):
    """Jittered camera rays of pixels (px, py), the jitter from
    fold_in(key, 0), and each pixel's background uv (px/width, py/height,
    0) (pathtracer.py:1076-1090). With cfg.use_dof the draw is (N,4), its
    last two columns the lens sample: threefry's values depend on the
    draw's shape, so the pixel jitter is a (N,4) draw's first two columns,
    as in the reference (pathtracer.py:1120-1121). With `rows`, the
    lanes' global rows, their rows of the global draw."""
    cols = 4 if cfg.use_dof else 2
    u = (rng.uniform(rng.fold_in(key, 0), (px.shape[0], cols)) if rows is None
         else rng.uniform_rows(rng.fold_in(key, 0), rows, cols))
    o, d = gen_rays(cam, width, height, px, py, u)
    bg_uv = torch.stack([px.float() / width, py.float() / height,
                         o.new_zeros(px.shape[0])], -1)
    return o, d, bg_uv


def _raygen(pack, cfg, cam, width: int, height: int, chunk: int, start: int,
            ck):
    """Camera rays of lanes start..start+chunk (clamped to the last pixel)
    and their background colours, sampled at the pixel's uv
    (pathtracer.py:1108-1153)."""
    px, py = _pixels(width, height, chunk, start, ck.device)
    o, d, bg_uv = _camera_rays(cfg, cam, width, height, px, py, ck)
    return o, d, sample_background(pack, bg_uv)


def _stage_aux(pack, surf: Surface, hit_mask):
    """The denoiser's auxiliary channels from a level-0 surface: the
    first-hit diffuse albedo (one texture tap) and the world normal, the
    buffers OIDN's RT filter takes (Main.cpp:68-77); misses give 0
    (pathtracer.py:1171-1179)."""
    mtl = _fetch_mtl(pack, surf.mtl)
    albedo = textured_color(pack, mtl.diffuse, mtl.diffuse_tm, surf.uvw,
                            surf.duvw, taps=1)
    m = hit_mask[:, None]
    return torch.where(m, albedo, 0.0), torch.where(m, surf.n, 0.0)


def trace_radiance(pack, cfg: RenderConfig, o, d, bg_uv, key, dd_x, dd_y,
                   pmap=None, want_aux: bool = False, frame=None):
    """Radiance of camera rays (o, d) with per-pixel background uv
    (pathtracer.py:1024-1073): (rad (N,3), z0 (N,), ChunkStats of 0-dim
    tensors summed over the shade tree), and with want_aux also the
    (albedo, normal) of the level-0 surface (`_stage_aux`). Level l draws
    from fold_in(key, 100 + l). With a frame (the rays' global rows), the
    stats are this rank's part of the global ones."""
    if cfg.differentiable and pack.n_msh:
        # Mesh hits resolve through rows gathered from the vertex, normal
        # and uv pools, so their gradients reach pack.verts
        # (pathtracer.py:629-636); the traces keep the compiled tables.
        # Once here, not per level: the replaced pack's cache starts empty.
        pack = dataclasses.replace(pack, resolve_rows=rows_from_pools(pack))
    n = o.shape[0]
    tasks = Tasks(o=o, d=d,
                  active=torch.ones(n, dtype=torch.bool, device=o.device),
                  bounce=torch.full((n,), cfg.tir_bounces, dtype=torch.int32,
                                    device=o.device))
    recs = []
    for level in range(cfg.max_levels):
        rec, tasks, surf, frame = _shade_level(
            pack, cfg, tasks, level, rng.fold_in(key, 100 + level), pmap,
            dd_x, dd_y, frame)
        if level == 0:
            surf0 = surf
        recs.append(rec)
    rad = _combine_tree(cfg, recs, tasks.active)
    rad = torch.where(recs[0].hit[:, None], rad, sample_background(pack, bg_uv))
    z0 = torch.where(recs[0].hit, recs[0].z, BIG)
    stats = ChunkStats(*(sum(getattr(r, f).to(torch.int64) for r in recs)
                         for f in ("drop_refr", "drop_tir", "drop_gi",
                                   "segs")))
    if want_aux:
        return rad, z0, stats, _stage_aux(pack, surf0, recs[0].hit)
    return rad, z0, stats


def _render_chunk(pack, cfg: RenderConfig, cam, width: int, height: int, px,
                  py, key, photon_map=None, want_aux: bool = False,
                  frame=None):
    """Radiance of one chunk of (pixel, sample) lanes, px/py (N,): (rad
    (N,3), z0 (N,), ChunkStats), and with want_aux the level-0 (albedo,
    normal) (pathtracer.py:1076-1098). Camera jitter from fold_in(key, 0),
    the shade tree from fold_in(key, 1). A plain function of the pack's and
    the camera's tensors: with cfg.differentiable, torch.autograd takes its
    gradients (parallel/sharding.py). With a frame (ops/compact.py:
    LaneFrame), the lanes are those of the frame's rows in one chunk of
    frame.width lanes, rendered as that chunk renders them."""
    o, d, bg_uv = _camera_rays(cfg, cam, width, height, px, py, key,
                               None if frame is None else frame.rows)
    _, dd_x, dd_y = camera_basis(cam, width, height)
    return trace_radiance(pack, cfg, o, d, bg_uv, rng.fold_in(key, 1), dd_x,
                          dd_y, photon_map, want_aux, frame)


def _escalated(cfg: RenderConfig, esc: int) -> RenderConfig:
    """The escalating re-render config of a chunk that dropped lanes:
    double the capacities per retry, lossless as the last resort
    (pathtracer.py:1494-1517)."""
    if cfg.refr_capacity * (2 ** esc) >= 1.0 or esc > 3:
        return dataclasses.replace(cfg, refr_capacity=1.0,
                                   tir_tail_compaction=False, gi_capacity=1.0,
                                   adaptive_full_capacity=False)
    return dataclasses.replace(
        cfg, refr_capacity=min(1.0, cfg.refr_capacity * (2 ** esc)),
        gi_capacity=1.0, tir_head_trips=max(cfg.tir_head_trips, 3),
        tir_tail_divisor=max(1, cfg.tir_tail_divisor >> esc))


def _adaptive_select(img_lin: np.ndarray, fraction: float) -> np.ndarray:
    """The adaptive pass's pixels (pathtracer.py:1565-1571): the
    max(1, int(total * fraction)) highest-contrast pixels of the (H, W, 3)
    linear image, by the 3x3 edge-padded box contrast, ascending flat
    indices. Host numpy, the reference's expression."""
    height, width = img_lin.shape[:2]
    total = height * width
    pad = np.pad(img_lin, ((1, 1), (1, 1), (0, 0)), mode="edge")
    blur = sum(pad[i:i + height, j:j + width]
               for i in range(3) for j in range(3)) / 9.0
    metric = np.abs(img_lin - blur).sum(-1).reshape(-1)
    k_sel = max(1, int(total * fraction))
    return np.sort(np.argpartition(metric, total - k_sel)[total - k_sel:])


def render_image(pack, camera, cfg: RenderConfig = RenderConfig(),
                 seed: int = 0, photon_map=None, denoiser=None,
                 return_aux: bool = False, checkpoint_dir=None,
                 sample_offset: int = 0, return_stats: bool = False):
    """Render a full image: (H, W, 3) float32 in [0,1] after gamma
    (Main.cpp:216-231), on the pack's device. `camera` is a scene-desc
    Camera (pathtracer.py:1406-1631).

    With cfg.use_photon_map, the caustic photon map is built first with
    `seed`, unless a built PhotonMapPack is passed as `photon_map`
    (pathtracer.py:1421-1426); without it, `photon_map` is ignored.

    Lanes are (pixel, sample); the image is cut into chunks of
    cfg.chunk_rays pixels and each chunk renders its spp samples, sample s
    keyed fold_in(fold_in(key, s + sample_offset), start): K passes of
    spp/K samples at offsets 0, spp/K, ... draw the samples of one pass of
    spp (the CLI's --progressive). A chunk whose drop counters are nonzero
    is re-rendered with escalating capacities (pathtracer.py:1491-1521).
    With checkpoint_dir, the accumulation, z-buffer and finished chunks
    are saved after each chunk, and a render of the same config, size and
    seed resumes from them (utils/checkpoint.py).

    With cfg.adaptive_spp, the cfg.adaptive_fraction highest-contrast
    pixels (`_adaptive_select`) then take adaptive_spp more samples each,
    keyed fold_in(fold_in(key, 0x5EED + s), a_start), and each pixel's
    radiance divides by its own count (pathtracer.py:1560-1602). An
    adaptive chunk that drops lanes escalates as a base chunk does, where
    the reference keeps its lossy samples.

    With cfg.use_denoiser, the post-gamma image goes through `denoiser` (a
    models/denoiser.DenoiserUNet; the shipped weights when None), with the
    first-hit albedo and normal as aux when the model takes them.

    Returns the image; with return_aux also a dict of host numpy arrays
    (the reference's keys: zbuffer (H,W) of the first sample's first-hit z,
    misses BIG; sample_count (H,W) int32; albedo and normal (H,W,3) of the
    first sample's first hit; dropped_lanes; traced_segments); with
    return_stats also the ChunkStats summed over the image, after the
    dict."""
    check_traceable(pack)
    if not cfg.use_photon_map:
        photon_map = None
    elif photon_map is None:
        photon_map = build_photon_map(pack, cfg, seed=seed, caustic=True)
    dev = pack.device
    cam = from_scene_camera(camera, dev)
    width, height = camera.width, camera.height
    total = width * height
    chunk = min(max(1, cfg.chunk_rays), total)
    n_chunks = -(-total // chunk)
    key = rng.prng_key(seed, dev)
    accum = torch.zeros((total, 3), device=dev)
    zbuffer = torch.full((total,), BIG, device=dev)
    done = np.zeros(n_chunks, bool)
    if cfg.use_denoiser and denoiser is None:
        denoiser = load_pretrained(device=dev)
    want_aux = return_aux or (cfg.use_denoiser and denoiser.aux_channels > 0)
    albedo = torch.zeros((total, 3), device=dev) if want_aux else None
    normal = torch.zeros((total, 3), device=dev) if want_aux else None
    if checkpoint_dir:
        state = load_render_state(checkpoint_dir, cfg, width, height, seed,
                                  with_aux=True)
        if state is not None:
            accum, zbuffer = (torch.from_numpy(np.array(x)).to(dev)
                              for x in state[:2])
            done = np.array(state[2])
            if want_aux and state[3] is not None:
                # The finished chunks' aux (the reference keeps none, so
                # its resumed denoise reads zeros there).
                albedo, normal = (torch.from_numpy(np.array(x)).to(dev)
                                  for x in state[3])
    totals = np.zeros(4, np.int64)

    def run_lanes(cfg_run, px, py, keys, with_aux: bool):
        """The samples of one chunk of lanes, sample s keyed keys[s]: (the
        summed radiance, the first sample's z0 and aux, host stats)."""
        acc = torch.zeros((px.shape[0], 3), device=dev)
        st = torch.zeros(4, dtype=torch.int64, device=dev)
        z = aux = None
        for s, ck in enumerate(keys):
            out = _render_chunk(pack, cfg_run, cam, width, height, px, py,
                                ck, photon_map, want_aux=with_aux and s == 0)
            if s == 0:
                z = out[1]
                aux = out[3] if with_aux else None
            acc = acc + out[0]
            st = st + torch.stack(list(out[2]))
        return acc, z, aux, st.cpu().numpy()

    def run_escalating(px, py, keys, with_aux: bool = False):
        """run_lanes, re-rendered with escalating capacities while the
        chunk drops lanes (pathtracer.py:1491-1521)."""
        out = run_lanes(cfg, px, py, keys, with_aux)
        esc = 0
        cfg_run = cfg
        while out[3][:3].any() and cfg_run.adaptive_full_capacity:
            esc += 1
            cfg_run = _escalated(cfg, esc)
            out = run_lanes(cfg_run, px, py, keys, with_aux)
        return out

    for start in range(0, total, chunk):
        if done[start // chunk]:
            continue
        px, py = _pixels(width, height, chunk, start, dev)
        acc, z, aux, st = run_escalating(
            px, py, [rng.fold_in(rng.fold_in(key, s + sample_offset), start)
                     for s in range(cfg.spp)], want_aux)
        count = min(start + chunk, total) - start
        accum[start:start + count] = acc[:count]
        zbuffer[start:start + count] = z[:count]
        if want_aux:
            albedo[start:start + count] = aux[0][:count]
            normal[start:start + count] = aux[1][:count]
        totals += st
        done[start // chunk] = True
        if checkpoint_dir:
            save_render_state(checkpoint_dir, accum.cpu().numpy(),
                              zbuffer.cpu().numpy(), done, cfg, width,
                              height, seed,
                              aux=(albedo.cpu().numpy(), normal.cpu().numpy())
                              if want_aux else None)

    # Per-pixel sample counts (scene.h:532-536, 605-626): the base pass's
    # spp everywhere, plus the adaptive pass's extra samples.
    sample_counts = np.full(total, cfg.spp, np.int64)
    if cfg.adaptive_spp > 0:
        sel = _adaptive_select(
            (accum.cpu().numpy() / cfg.spp).reshape(height, width, 3),
            cfg.adaptive_fraction)
        k_sel = sel.shape[0]
        # One bucket of 1024-lane multiples (the pad sets the draw's shape,
        # hence the threefry values: the reference's, pathtracer.py:1572).
        a_chunk = min(chunk, max(1024, -(-k_sel // 1024) * 1024))
        for a_start in range(0, k_sel, a_chunk):
            part = sel[a_start:a_start + a_chunk]
            count = part.shape[0]
            idx = torch.from_numpy(np.concatenate(
                [part, np.full(a_chunk - count, sel[0], np.int64)])).to(dev)
            # Its pixels are the high-contrast ones, where the glass is:
            # a chunk that drops lanes escalates as the base pass's do (the
            # reference counts the drops and keeps the lossy samples).
            acc, _, _, st = run_escalating(
                idx % width, idx // width,
                [rng.fold_in(rng.fold_in(key, 0x5EED + s), a_start)
                 for s in range(cfg.adaptive_spp)])
            totals += st
            rows = torch.from_numpy(part).to(dev)
            accum[rows] = accum[rows] + acc[:count]
            sample_counts[part] += cfg.adaptive_spp

    img = accum / torch.from_numpy(sample_counts.astype(np.float32)).to(
        dev)[:, None]
    if cfg.use_gamma:
        img = torch.pow(torch.clamp_min(img, 0.0), 1.0 / cfg.gamma)
    img = img.reshape(height, width, 3)
    if cfg.use_denoiser:
        # The post-gamma image, as the reference hands OIDN its
        # gamma-corrected colours (Main.cpp:220-238).
        aux_in = None
        if denoiser.aux_channels > 0:
            aux_in = torch.cat([albedo, normal], -1).reshape(height, width, 6)
        img = denoise(denoiser, img, aux=aux_in)
    out = [img]
    if return_aux:
        out.append({
            "zbuffer": zbuffer.reshape(height, width).cpu().numpy(),
            "sample_count": sample_counts.reshape(height, width).astype(
                np.int32),
            "albedo": albedo.reshape(height, width, 3).cpu().numpy(),
            "normal": normal.reshape(height, width, 3).cpu().numpy(),
            "dropped_lanes": {"refr_overflow": int(totals[0]),
                              "tir_overflow": int(totals[1]),
                              "gi_overflow": int(totals[2])},
            "traced_segments": int(totals[3])})
    if return_stats:
        out.append(ChunkStats(*(int(x) for x in totals)))
    return out[0] if len(out) == 1 else tuple(out)


def image_to_u8(img) -> np.ndarray:
    """Color24 conversion (cyColor.h:231): clamp to [0,1], scale, round."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def zbuffer_to_u8(zbuffer) -> np.ndarray:
    """ComputeZBufferImage (scene.h:579-601): finite z normalised to
    [0, 255], near bright; misses (BIG) map to 0 (pathtracer.py:1639)."""
    z = np.asarray(zbuffer)
    mask = z < BIG
    if not mask.any():
        return np.zeros(z.shape, np.uint8)
    zmin = z[mask].min()
    zmax = z[mask].max()
    denom = max(zmax - zmin, 1e-30)
    img = np.clip((zmax - z) / denom * 255.0, 0, 255).astype(np.uint8)
    img[~mask] = 0
    return img
