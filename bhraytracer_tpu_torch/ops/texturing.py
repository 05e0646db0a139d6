"""Texture evaluation: file (bilinear, tiling), checker, multi-tap filter,
TextureMap uvw transforms, TexturedColor, and environment mapping; the port
of bhraytracer_tpu/ops/texturing.py.

Reference semantics: TextureFile::Sample (Texture.cpp:97-123),
TextureChecker::Sample (:127-136), Texture::Sample's 32-tap Halton elliptic
filter (scene.h:316-337), TextureMap transform (scene.h:364-386),
TexturedColor (scene.h:394-422), SampleEnvironment (scene.h:414-420).

Plain PyTorch on either device: the JAX package computes all of this
outside its Pallas kernels too. A scene without texture maps
(`pack.n_texmaps == 0`) does no texture work at all.

The atlas is uint8, or float32 on the same 0..255 scale for gradients
(parallel/sharding.py:trainable_params): a float atlas's texel gather
keeps the autograd graph, so texels are differentiated through the
bilinear weights and the filter taps.
"""

from __future__ import annotations

import torch

from bhraytracer_tpu_torch.ops.compact import lookup_rows
from bhraytracer_tpu_torch.ops.linalg import mat_vec
from bhraytracer_tpu_torch.utils.halton import texture_filter_taps

_TAPS = {}  # (taps, device) -> (taps, 2) float32 filter offsets


def filter_taps(n: int, device) -> torch.Tensor:
    """texture_filter_taps(n) on `device`, made once per (n, device)."""
    key = (n, str(device))
    if key not in _TAPS:
        _TAPS[key] = torch.from_numpy(texture_filter_taps(n)).to(device)
    return _TAPS[key]


def tile_clamp(u):
    """Fractional tiling wrap (Texture::TileClamp, scene.h:344-354). A tiny
    negative u wraps to exactly 1.0; texture_eval's clip and wrap take it
    from there, in the reference's order."""
    u = u - torch.trunc(u)
    return torch.where(u < 0.0, u + 1.0, u)


def atlas_texels(atlas, tex_id, yy, xx):
    """atlas[tex_id, yy, xx] as float32 (the identity on a float32 atlas,
    whose graph is kept), gathered by one flat (tex, y, x) row index
    through lookup_rows: its backward is a scatter-add, where advanced
    indexing's adds each texel's duplicates in one serial loop."""
    n_tex, th, tw = atlas.shape[:3]
    row = (tex_id.long() * th + yy.long()) * tw + xx.long()
    return lookup_rows(atlas.reshape(n_tex * th * tw, -1), row).float()


def texture_eval(pack, tex_id, uvw):
    """Single-tap texture lookup. tex_id: integer ids that broadcast
    against uvw's leading dimensions, uvw: (..., 3). Texel indices are the float32 products w * u truncated toward zero, as
    the reference's astype(int32)."""
    tex_id = tex_id.clamp(0, pack.tex_kind.shape[0] - 1).long()
    kind = pack.tex_kind[tex_id]
    u = tile_clamp(uvw)

    # --- checker (Texture.cpp:127-136): (x <= .5) == (y <= .5) -> color1 ---
    left = u[..., 0] <= 0.5
    low = u[..., 1] <= 0.5
    checker = torch.where((left == low)[..., None],
                          lookup_rows(pack.tex_c1, tex_id),
                          lookup_rows(pack.tex_c2, tex_id))

    # --- file texture, bilinear with integer-wrap parity ---
    wh = pack.tex_wh[tex_id]
    w = wh[..., 0]
    h = wh[..., 1]
    x = w.float() * u[..., 0]
    y = h.float() * u[..., 1]
    ix = x.to(torch.int32)
    iy = y.to(torch.int32)
    fx = x - ix.float()
    fy = y - iy.float()
    ix = torch.minimum(ix.clamp_min(0), w - 1)
    iy = torch.minimum(iy.clamp_min(0), h - 1)
    ixp = torch.where(ix + 1 >= w, ix + 1 - w, ix + 1)
    iyp = torch.where(iy + 1 >= h, iy + 1 - h, iy + 1)

    def fetch(yy, xx):
        return atlas_texels(pack.atlas, tex_id, yy, xx) * (1.0 / 255.0)

    bilin = (fetch(iy, ix) * ((1 - fx) * (1 - fy))[..., None]
             + fetch(iy, ixp) * (fx * (1 - fy))[..., None]
             + fetch(iyp, ix) * ((1 - fx) * fy)[..., None]
             + fetch(iyp, ixp) * (fx * fy)[..., None])
    return torch.where((kind == 1)[..., None], checker, bilin)


def texmap_sample(pack, tm_id, uvw, duvw=None, taps: int = 32):
    """TextureMap::Sample: transform uvw (and derivatives) into texture space
    then filter. tm_id: (N,) integer ids, may be -1 (returns 0, the
    reference's null texture -> Color(0,0,0), scene.h:371). The filter's
    taps - 1 off-centre taps are evaluated as one (N, taps - 1) batch and
    used only where duvw is nonzero (planes); elsewhere the centre tap."""
    valid = tm_id >= 0
    tid = tm_id.clamp(0, pack.tm_tex.shape[0] - 1).long()
    itm = pack.tm_itm[tid]
    tex = pack.tm_tex[tid]
    u = mat_vec(itm, uvw - pack.tm_pos[tid])

    if duvw is None:
        c = texture_eval(pack, tex, u)
    else:
        center = texture_eval(pack, tex, u)
        if taps > 1:
            d0 = mat_vec(itm, duvw[:, 0])
            d1 = mat_vec(itm, duvw[:, 1])
            tap_xy = filter_taps(taps, u.device)  # (S,2); tap 0 is the centre
            us = (u[:, None, :]
                  + tap_xy[None, 1:, 0, None] * d0[:, None, :]
                  + tap_xy[None, 1:, 1, None] * d1[:, None, :])  # (N, S-1, 3)
            # One id a lane, broadcast over the taps: the texture tables'
            # gradients sum the taps before one scatter-add a lane.
            rest = texture_eval(pack, tex[:, None], us).sum(1)
            filtered = (center + rest) / float(taps)
        else:
            filtered = center
        dzero = ((duvw[:, 0] ** 2).sum(-1) + (duvw[:, 1] ** 2).sum(-1)) == 0.0
        c = torch.where(dzero[:, None], center, filtered)
    return torch.where(valid[:, None], c, 0.0)


def textured_color(pack, color, tm_id, uvw, duvw=None, taps: int = 32):
    """TexturedColor::Sample (scene.h:410-411): color, or color * texture.
    Skips all texture work when the scene has no texture maps."""
    if pack.n_texmaps == 0:
        return color.expand(tm_id.shape + (3,)) if color.dim() == 1 else color
    tex = texmap_sample(pack, tm_id, uvw, duvw, taps=taps)
    return torch.where((tm_id >= 0)[..., None], color * tex, color)


def environment_valid(direction):
    """Where SampleEnvironment's mapping (scene.h:414-420) is defined:
    invalid where the reference would produce NaN (|dir.z| > 1 on an
    unnormalised direction, or dir.x = dir.y = 0), which callers treat as
    a zero contribution (MtlBlinn.cpp:418-423)."""
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    return (dz.abs() <= 1.0) & ((dx.abs() + dy.abs()) > 0.0)


def environment_uvw(direction):
    """SampleEnvironment's lat-long-ish mapping (scene.h:414-420): (uvw,
    valid)."""
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    denom = dx.abs() + dy.abs()
    z = torch.asin(torch.clamp(-dz, -1.0 + 1e-7, 1.0 - 1e-7)) / torch.pi + 0.5
    safe = torch.where(denom > 0.0, denom, 1.0)
    x = dx / safe
    y = dy / safe
    u = 0.5 + z * (x * 0.5 - y * 0.5)
    v = 0.5 + z * (x * 0.5 + y * 0.5)
    return torch.stack([u, v, torch.zeros_like(u)], -1), environment_valid(
        direction)


def sample_environment(pack, direction):
    """environment.SampleEnvironment(dir) -> (colour (N,3), valid (N,)).
    Without texture maps the mapped uv is never read, so it is not made."""
    if pack.n_texmaps == 0:
        return (pack.env_color.expand(direction.shape),
                environment_valid(direction))
    uvw, valid = environment_uvw(direction)
    c = textured_color(pack, pack.env_color,
                       pack.env_tm.expand(uvw.shape[:-1]), uvw)
    return c, valid


def sample_background(pack, uvw):
    """background.Sample(pixel uv) for primary-ray misses (Main.cpp:166-167);
    uvw: (N,3), the pixel's (px/width, py/height, 0)."""
    return textured_color(pack, pack.bg_color,
                          pack.bg_tm.expand(uvw.shape[:-1]), uvw)
