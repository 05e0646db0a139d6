"""Photon mapping: wavefront photon tracing, the grid index and the kNN
density gather (the port of bhraytracer_tpu/models/photonmap.py).

The reference behaviour is the JAX package's (photonmap.py:1-31):

  - photons leave point lights chosen with probability ~ intensity * size
    by the first-index-past-u walk over the lights sorted ascending, in
    uniform-sphere directions (Main.cpp:251-386, PointLight.cpp:20-34);
  - a caustic map transmits through glass (enter and exit, TIR kills),
    kills diffuse bounces and continues only specular ones; a regular map
    kills at transmissive surfaces (MtlBlinn.cpp:140-303);
  - a photon is deposited at every non-first hit on a diffuse surface,
    before its bounce, and powers are scaled by 1 / (photons stored);
  - the gather is the constant-filter k-nearest estimate
    (cyPhotonMap.h:421-498): with more than k photons in range the radius
    shrinks to the k-th nearest distance, found by histogram refinement
    over dist2 (16 bins per pass) and then one sweep below the threshold.

The RNG is the JAX package's threefry, bit for bit (ops/rng.py), with its
fold_in tags: emission fold_in(round_key, 0) with tags 0-2, bounce b
fold_in(round_key, 100 + b) with tags 0-4. Traces go through ops/trace.py,
so a mesh-free pack takes the analytic kernels and a mesh pack the mesh
routes. The density sweeps are kernel 10 (ops/photon.py) on the card.

Maps are built on the pack's device; `pmap_from_numpy` carries the JAX
package's map across (its arrays as numpy), so both packages can gather
from the same photons.

Gradients: the map is a constant of a render (built without a graph, as
the JAX package builds it outside the differentiated chunk), and the
gather's outputs carry no gradient to its query points. Its sums are the
map's own powers and directions over an accept set, bins and a threshold
that are discrete in the query points, so the XLA fold's gradient with
respect to them is exactly zero (photonmap.py:455-508); kernel 10 and its
twin run forward on detached inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.ops import rng
from bhraytracer_tpu_torch.ops.linalg import (
    cross,
    dot,
    normalize,
    safe_div,
    safe_pow,
    safe_sqrt,
)
from bhraytracer_tpu_torch.ops.photon import (
    HIST_BINS,
    PhotonTiles,
    photon_rows,
    sweep,
    tile_table,
)
from bhraytracer_tpu_torch.ops.sampling import (
    sample_along_light_direction,
    sample_in_semisphere,
)
from bhraytracer_tpu_torch.ops.trace import resolve_hit, trace_closest
from bhraytracer_tpu_torch.scene.pack import resolve_device

MAX_PHOTON_BOUNCES = 20  # wavefront cap; the reference recurses until RR kills
PHOTON_BATCH = 1 << 15  # photons per emission round (the JAX default)
_HASH = (73856093, 19349663, 83492791)


class PhotonMapPack(NamedTuple):
    """A photon map with its uniform-grid index, photons sorted by bucket,
    and the density sweeps' tile table (ops/photon.py:tile_table), the same
    rows in a spatial order with the boxes of their tiles. `pos`, `dirn`
    and `power` are views of the bucket-ordered rows."""

    rows: torch.Tensor  # (P,12) pos, dirn, power, dirn*maxpower (ops/photon.py)
    cell: torch.Tensor  # (P,3) i32 grid cell of each photon
    bucket_start: torch.Tensor  # (H+1,) i32 prefix offsets into sorted order
    radius: float
    n_buckets: int
    cell_cap: int  # the largest bucket's occupancy
    tile_rows: torch.Tensor  # (T*TILE,12) the rows in Morton order, padded
    tile_boxes: torch.Tensor  # (T,8) box of each tile's photons
    super_boxes: torch.Tensor  # (T/SUPER,8) box of each SUPER tiles

    @property
    def tiles(self) -> PhotonTiles:
        return PhotonTiles(self.tile_rows, self.tile_boxes, self.super_boxes)

    @property
    def pos(self) -> torch.Tensor:  # (P,3)
        return self.rows[:, 0:3]

    @property
    def dirn(self) -> torch.Tensor:  # (P,3) incoming direction (normalised)
        return self.rows[:, 3:6]

    @property
    def power(self) -> torch.Tensor:  # (P,3) scaled by 1/P
        return self.rows[:, 6:9]

    def to(self, device) -> "PhotonMapPack":
        return self._replace(**{f: getattr(self, f).to(device) for f in
                                ("rows", "cell", "bucket_start", "tile_rows",
                                 "tile_boxes", "super_boxes")})


# ---------------------------------------------------------------------------
# wavefront photon tracing
# ---------------------------------------------------------------------------


def _uniforms(key, n_tags: int, n: int):
    """(n_tags, n) uniforms, row t = uniform(fold_in(key, t), (n,))."""
    keys = rng.fold_in(key, torch.arange(n_tags, device=key.device))
    return rng.uniform(keys, (n,))


def _select_photon_light(pack, u):
    """Point light chosen ~ gray*size with the reference's walk
    (Main.cpp:363-371, lights sorted ascending by gray*size; other lights
    weigh 0 and sink to the front of the stable sort)."""
    is_point = pack.light_kind == 2
    gray = pack.light_intensity.sum(1) / 3.0
    w = torch.where(is_point, gray * pack.light_size, 0.0)
    order = torch.argsort(w, stable=True)
    ws = w[order]
    probs = ws / torch.clamp_min(ws.sum(), 1e-30)
    ok = (u[:, None] <= probs[None, :]) & (probs[None, :] > 0)
    idx = torch.where(ok.any(1), ok.to(torch.int32).argmax(1), ws.shape[0] - 1)
    return order[idx]


def _emit_photons(pack, key, n: int):
    """Uniform-sphere emission from the selected point lights."""
    u = _uniforms(key, 3, n)
    lidx = _select_photon_light(pack, u[0])
    phi = u[1] * 2.0 * math.pi
    theta = torch.acos(torch.clamp(1.0 - 2.0 * u[2], -1.0, 1.0))
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                     torch.cos(theta)], -1)
    return pack.light_vec[lidx], d, pack.light_intensity[lidx]


def _photon_bounce(pack, cfg: RenderConfig, surf, mtl, ray_d, power, key,
                   caustic: bool):
    """One RandomPhotonBounce[ForCaustic] step for a batch of photons
    (photonmap.py:105-179). Returns (continue, new_o, new_d, new_power)."""
    n = surf.p.shape[0]
    vn = surf.n
    vv = -normalize(ray_d)
    u = _uniforms(key, 5, n)
    rnd = u[0]
    absorb = cfg.photon_absorb_chance
    transmissive = mtl.refraction.sum(1) / 3.0 > 0.0

    # Diffuse/specular lobes (MtlBlinn.cpp:163-187).
    kd = mtl.diffuse.amax(1)
    ks = mtl.specular.amax(1)
    d_dir, p_dt = sample_in_semisphere(vn, u[1], u[2])
    d_dir = normalize(d_dir)
    vr = 2.0 * dot(vn, vv, keepdim=True) * vn - vv
    s_dir, s_cos = sample_along_light_direction(vr, mtl.gloss, u[3], u[4])
    p_st = safe_pow(s_cos, mtl.gloss)
    p_diffuse_raw = safe_div(kd * p_dt, kd * p_dt + ks * p_st)
    p_diff = p_diffuse_raw * (1.0 - absorb) + absorb
    p_spec = (1.0 - p_diff) * (1.0 - absorb) + absorb
    use_spec = rnd >= p_diff
    kdf = mtl.diffuse / torch.clamp_min(p_diff, 1e-30)[:, None]
    ksf = mtl.specular / torch.clamp_min(p_spec, 1e-30)[:, None]
    bounce_dir = torch.where(use_spec[:, None], s_dir, d_dir)
    bounce_pow = power * torch.where(use_spec[:, None], ksf, kdf)
    bounce_o = surf.p + vn * cfg.bias
    survive_rr = rnd >= absorb

    if not caustic:
        return ~transmissive & survive_rr, bounce_o, bounce_dir, bounce_pow

    # Caustic: transmit through glass (MtlBlinn.cpp:212-249).
    cos1 = dot(vn, vv)
    sin1 = safe_sqrt(1.0 - cos1 * cos1)
    sin2 = sin1 / torch.clamp_min(mtl.ior, 1e-6)
    cos2 = safe_sqrt(1.0 - sin2 * sin2)
    vt = (-cos2[:, None] * vn
          + normalize(cross(vn, cross(vn, vv))) * sin2[:, None])
    in_o = surf.p - vn * cfg.bias
    in_hit = trace_closest(pack, in_o, vt, "back")
    in_surf = resolve_hit(pack, in_o, vt, in_hit, minimal=True)
    # Exit refraction with the material's own refraction glossiness.
    vn2 = in_surf.n
    vv2 = -normalize(vt)
    c1 = dot(vv2, -vn2)
    s1 = safe_sqrt(1.0 - c1 * c1)
    s2 = mtl.ior * s1
    going_out = (s2 <= 1.0) & in_hit.hit
    c2 = safe_sqrt(1.0 - s2 * s2)
    vt2 = vn2 * c2[:, None] + normalize(cross(vn2, cross(vn2, vv2))) * s2[:, None]
    out_o = in_surf.p + vn2 * cfg.bias
    out_d = normalize(vt2)

    # Non-transmissive: only specular bounces continue.
    cont_solid = survive_rr & use_spec
    tr = transmissive[:, None]
    return (torch.where(transmissive, going_out, cont_solid),
            torch.where(tr, out_o, bounce_o),
            torch.where(tr, out_d, s_dir),
            torch.where(tr, power, power * ksf))


def trace_photon_batch(pack, cfg: RenderConfig, key, n: int, caustic: bool):
    """Trace n photon paths to completion: stacked deposits (pos, dir,
    power, valid) of shape (MAX_PHOTON_BOUNCES, n, ...). No host sync per
    bounce: the bounces' keys, fold_in(key, 100 + b), come from one fold of
    tags made on the device (a tag made on the host is a copy to the card,
    which waits for it)."""
    from bhraytracer_tpu_torch.models.pathtracer import _fetch_mtl

    o, d, power = _emit_photons(pack, rng.fold_in(key, 0), n)
    bounce_keys = rng.fold_in(key, torch.arange(
        100, 100 + MAX_PHOTON_BOUNCES, device=key.device))
    live = torch.ones(n, dtype=torch.bool, device=o.device)
    dep_pos, dep_dir, dep_pow, dep_valid = [], [], [], []
    for b in range(MAX_PHOTON_BOUNCES):
        hit = trace_closest(pack, o, d, "front")
        surf = resolve_hit(pack, o, d, hit, minimal=True)
        mtl = _fetch_mtl(pack, surf.mtl)
        alive = live & hit.hit
        # Deposit at non-first hits on photon surfaces (diffuse gray > 0).
        is_photon_surface = mtl.diffuse.sum(1) / 3.0 > 0.0
        dep_pos.append(surf.p)
        dep_dir.append(normalize(d))
        dep_pow.append(power)
        dep_valid.append(alive & is_photon_surface & (b > 0))
        cont, o, d, power = _photon_bounce(pack, cfg, surf, mtl, d, power,
                                           bounce_keys[b], caustic)
        live = alive & cont
    return (torch.stack(dep_pos), torch.stack(dep_dir), torch.stack(dep_pow),
            torch.stack(dep_valid))


# ---------------------------------------------------------------------------
# build and grid index
# ---------------------------------------------------------------------------


def _hash_cells(cells, n_buckets: int):
    """The large-prime spatial hash in wrapping int32, masked to the
    power-of-two bucket count: computed in int64, whose low bits are the
    wrapped int32 products'."""
    c = cells.to(torch.int32).to(torch.int64)
    h = c[..., 0] * _HASH[0] ^ c[..., 1] * _HASH[1] ^ c[..., 2] * _HASH[2]
    return h & (n_buckets - 1)


@torch.no_grad()
def build_photon_map(pack, cfg: RenderConfig, seed: int = 0,
                     caustic: bool = True,
                     batch: int = PHOTON_BATCH) -> PhotonMapPack:
    """Emit photon batches until cfg.photon_count deposits are collected or
    the round limit is reached, scale powers by 1/N (Main.cpp:289) and
    build the grid index, on the pack's device. One host sync per round."""
    key = rng.prng_key(seed, pack.device)
    pos_l, dir_l, pow_l = [], [], []
    n_dep = rounds = 0
    # Caustic yield can be ~1% of emissions: allow many rounds.
    max_rounds = max(8, (32 * cfg.photon_count) // batch + 4)
    while n_dep < cfg.photon_count and rounds < max_rounds:
        p, dd, pw, v = trace_photon_batch(pack, cfg, rng.fold_in(key, rounds),
                                          batch, caustic)
        m = v.reshape(-1)
        pos_l.append(p.reshape(-1, 3)[m])
        dir_l.append(dd.reshape(-1, 3)[m])
        pow_l.append(pw.reshape(-1, 3)[m])
        got = pos_l[-1].shape[0]
        n_dep += got
        rounds += 1
        if got == 0 and rounds >= 4:
            break  # the scene deposits nothing (e.g. no point lights)
    dev = pack.device
    if n_dep == 0:
        pos = torch.zeros((1, 3), device=dev)
        dirn = torch.tensor([[0.0, 0.0, -1.0]], device=dev)
        power = torch.zeros((1, 3), device=dev)
    else:
        pos = torch.cat(pos_l)[:cfg.photon_count]
        dirn = torch.cat(dir_l)[:cfg.photon_count]
        power = torch.cat(pow_l)[:cfg.photon_count]
        power = power / pos.shape[0]  # ScalePhotonPowers(1/N)
    return build_grid_index(pos, dirn, power, cfg.photon_gather_radius)


def build_grid_index(pos, dirn, power, radius: float,
                     cell_cap: int | None = None) -> PhotonMapPack:
    """Sort photons by hashed grid cell (stable); bucket offsets from the
    counts; the sweeps' tile table of the sorted rows. cell_cap defaults to
    the largest bucket's occupancy."""
    p = pos.float()
    n = p.shape[0]
    n_buckets = 1 << max(10, int(np.ceil(np.log2(max(n, 2) * 2))))
    cells = torch.floor(p / radius).to(torch.int64)
    h = _hash_cells(cells, n_buckets)
    order = torch.argsort(h, stable=True)
    counts = torch.bincount(h, minlength=n_buckets)
    if cell_cap is None:
        cell_cap = max(1, int(counts.max()))
    start = torch.zeros(n_buckets + 1, dtype=torch.int64, device=p.device)
    start[1:] = torch.cumsum(counts, 0)
    return _with_tiles(rows=photon_rows(p[order], dirn.float()[order],
                                        power.float()[order]),
                       cell=cells.to(torch.int32)[order],
                       bucket_start=start.to(torch.int32),
                       radius=float(radius), n_buckets=n_buckets,
                       cell_cap=cell_cap)


def _with_tiles(rows, **fields) -> PhotonMapPack:
    """A PhotonMapPack of the bucket-ordered rows, with their tile table."""
    tiles = tile_table(rows)
    return PhotonMapPack(rows=rows, **fields, tile_rows=tiles.rows,
                         tile_boxes=tiles.boxes, super_boxes=tiles.supers)


def pmap_from_numpy(pos, dirn, power, cell, bucket_start, radius: float,
                    n_buckets: int, cell_cap: int, device=None) -> PhotonMapPack:
    """A map from the JAX package's PhotonMapPack fields (arrays as numpy,
    in its field order), on `device` (the card by default)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype).to(dev).contiguous()

    return _with_tiles(rows=photon_rows(*(t(x, torch.float32)
                                          for x in (pos, dirn, power))),
                       cell=t(cell, torch.int32),
                       bucket_start=t(bucket_start, torch.int32),
                       radius=float(radius), n_buckets=int(n_buckets),
                       cell_cap=int(cell_cap))


# ---------------------------------------------------------------------------
# the kNN gather
# ---------------------------------------------------------------------------


def pick_bin(hist, below, lo, hi, k: int):
    """Per-lane bin whose cumulative count (from `below`) first reaches k:
    the refined (below, lo, hi) bracket around the k-th distance^2."""
    cum = below[:, None] + torch.cumsum(hist, 1, dtype=torch.int32)
    b = (cum >= k).to(torch.int32).argmax(1).to(torch.int32)
    width = (hi - lo) / HIST_BINS
    new_lo = lo + b.float() * width
    prev = torch.where(
        b > 0, cum.gather(1, (b - 1).clamp_min(0).long()[:, None])[:, 0], below)
    return prev, new_lo, new_lo + width


def gather_irradiance(pmap: PhotonMapPack, pos, normal, k: int | None = None,
                      refine_passes: int = 2):
    """Constant-filter kNN photon density estimate at (N,3) query points
    (photonmap.py:361-508): (irradiance (N,3), normalised direction (N,3)).

    One full sweep gives the in-range sums, count and dist2 histogram;
    with k set, lanes holding more than k photons locate the k-th distance
    to r^2 / 16^(1 + refine_passes) by `refine_passes` histogram sweeps,
    and one final sweep sums below that threshold. k=None is the pure
    fixed-radius estimate.

    The sweeps read the map's tile table. The hist and final sweeps run
    only on the lanes over k, the only ones whose results the estimate
    reads. The outputs carry no gradient to pos and normal (the module's
    docstring): both are detached."""
    n = pos.shape[0]
    r2 = pmap.radius * pmap.radius
    r2f = float(np.float32(r2))
    inv_w0 = float(np.float32(HIST_BINS / r2))
    pos = pos.detach().float().contiguous()
    normal = normal.detach().float().contiguous()
    zero = pos.new_zeros(n)
    full_hi = pos.new_full((n,), r2f)
    tiles = pmap.tiles

    def run(mode, lo, hi, active=None):
        return sweep(mode, tiles, pos, normal, lo.contiguous(),
                     hi.contiguous(), r2f, inv_w0, active=active)

    irr_full, ds_full, cnt, hist = run("full", zero, full_hi)
    if k is None:
        return irr_full / (math.pi * r2), normalize(ds_full)

    need = cnt > k
    below = torch.zeros(n, dtype=torch.int32, device=pos.device)
    below, lo, hi = pick_bin(hist, below, zero, full_hi, k)
    for _ in range(refine_passes):
        _, _, _, hist = run("hist", lo, hi, need)
        below, lo, hi = pick_bin(hist, below, lo, hi, k)

    # Threshold: the upper edge of the bracket holding the k-th distance^2
    # (lanes with <= k photons in range keep the full radius).
    t = torch.where(need, hi, r2f)
    irr_k, ds_k, _, _ = run("final", t, full_hi, need)
    irr = torch.where(need[:, None], irr_k / (math.pi * t[:, None]),
                      irr_full / (math.pi * r2))
    return irr, normalize(torch.where(need[:, None], ds_k, ds_full))
