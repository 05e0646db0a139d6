"""Brute-force face-stream traces with the analytic fold (kernels 1 and 2).

Ports `stream_closest` and `stream_anyhit` of
bhraytracer_tpu/ops/pallas_stream.py, with the sphere/plane fold of
bhraytracer_tpu/ops/pallas_analytic.py inside: every ray is tested against
every face of the stream table, and against every analytic instance.

  - `stream_table` builds the affine-barycentric face rows
    [n_hat (3), n_hat.v0, g0 (3), c0, g1 (3), c1, pad (4)] with
    b0(P) = g0.P + c0, b1(P) = g1.P + c1 (b2 = 1 - b0 - b1), padded with
    zero rows, which are grazing-culled everywhere.
  - `stream_closest` returns (t, key): key = face*2 + front for a mesh
    winner and analytic_code*2 + front for an analytic one, with
    analytic_code = -(2 + inst*4 + kind*2 + front) (kind 0 sphere,
    1 plane), and -2 (code -1, no front) on a miss. `key >> 1` and
    `key & 1` decode it.
  - `stream_anyhit` returns occlusion by a front-facing face in
    (t_min, t_max) or an analytic occluder in (ana_bias, t_max).

Tie rules (pallas_stream.py:307-318): among faces at equal t the lowest key
wins; a mesh winner replaces the analytic one only when strictly closer.

Each public function dispatches on the device of its tensors: a CUDA tensor
goes to the kernel in csrc/stream.cu, a CPU tensor to the `_ref` twin,
which computes the same formulas in the same order with PyTorch ops.
"""

from __future__ import annotations

import torch

from bhraytracer_tpu_torch.ops import kernels
from bhraytracer_tpu_torch.ops.intersect import PERP_EPS
from bhraytracer_tpu_torch.ops.linalg import BIG

SIDES = {"front": 0, "back": 1, "both": 2}
ROW_PAD = 32  # stream tables are padded to a multiple of this many rows
MAX_ANALYTIC = 32  # per category; the kernels stage the tables in shared memory
STREAM_MAX_FACES = 8192  # the slice's gate (bhraytracer_tpu pallas_stream.py:79)
BIGI = 2 ** 30  # "no mesh winner" key sentinel
_CHUNK = 1 << 22  # ray x face pairs per step of the twins


def stream_table(v0, v1, v2, n, inv_nlen) -> torch.Tensor:
    """(F_pad, 16) float32 stream rows from world triangles, their
    unnormalised face normals n and 1/|n| (_stream_table,
    pallas_stream.py:91-113)."""
    nn = torch.clamp_min(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                         + n[:, 2] * n[:, 2], 1e-30)[:, None]

    def cross(a, b):
        return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2])[:, None]

    g0 = cross(n, v2 - v1) / nn
    c0 = -dot(g0, v1)
    g1 = cross(n, v0 - v2) / nn
    c1 = -dot(g1, v2)
    nhat = n * inv_nlen[:, None]
    ndot0 = dot(nhat, v0)
    f = n.shape[0]
    rows = torch.cat([nhat, ndot0, g0, c0, g1, c1,
                      torch.zeros((f, 4), dtype=n.dtype, device=n.device)], 1)
    pad = (-f) % ROW_PAD
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, 16))])
    return rows.contiguous()


def instance_table(itm, pos) -> torch.Tensor:
    """(K,3,3) + (K,3) -> (K,12) [itm.flat, pos] analytic instance rows."""
    return torch.cat([itm.reshape(-1, 9), pos], 1).float().contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _local_ray(row, o, d):
    """Instance-local ray via a [itm (9), pos (3)] row (local_ray,
    pallas_analytic.py:24-36)."""
    m = row[:9]
    sx, sy, sz = o[:, 0] - row[9], o[:, 1] - row[10], o[:, 2] - row[11]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return (m[0] * sx + m[1] * sy + m[2] * sz,
            m[3] * sx + m[4] * sy + m[5] * sz,
            m[6] * sx + m[7] * sy + m[8] * sz,
            m[0] * dx + m[1] * dy + m[2] * dz,
            m[3] * dx + m[4] * dy + m[5] * dz,
            m[6] * dx + m[7] * dy + m[8] * dz)


def _analytic_closest(side, sph, pln, o, d, t0):
    """(t, code, front) of the closest analytic hit seeded by t0
    (analytic_closest, pallas_analytic.py:39-93)."""
    bt = t0.clone()
    bface = torch.full_like(t0, -1, dtype=torch.int32)
    bfront = torch.zeros_like(t0, dtype=torch.int32)
    for k in range(sph.shape[0]):
        lox, loy, loz, ldx, ldy, ldz = _local_ray(sph[k], o, d)
        a = ldx * ldx + ldy * ldy + ldz * ldz
        b = 2.0 * (ldx * lox + ldy * loy + ldz * loz)
        c = lox * lox + loy * loy + loz * loz - 1.0
        disc = b * b - 4.0 * a * c
        ok = disc > 0.0
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-30)
        t1 = (-b + sq) * inv2a
        t2 = (-b - sq) * inv2a
        both_pos = t2 > 0.0
        inside = t1 * t2 <= 0.0
        if side == 0:
            t = torch.where(both_pos, t2, BIG)
            front = torch.ones_like(ok)
        elif side == 1:
            t = torch.where(both_pos | inside, t1, BIG)
            front = torch.zeros_like(ok)
        else:
            t = torch.where(both_pos, t2, torch.where(inside, t1, BIG))
            front = both_pos
        t = torch.where(ok & (t > 0.0), t, BIG)
        upd = t < bt
        fi = front.to(torch.int32)
        bt = torch.where(upd, t, bt)
        bface = torch.where(upd, -(2 + k * 4 + fi), bface)
        bfront = torch.where(upd, fi, bfront)
    for k in range(pln.shape[0]):
        lox, loy, loz, ldx, ldy, ldz = _local_ray(pln[k], o, d)
        t = -loz / torch.where(ldz == 0.0, 1e-30, ldz)
        x = lox + t * ldx
        y = loy + t * ldy
        in_ext = (x.abs() <= 1.0) & (y.abs() <= 1.0)
        front = ldz < 0.0
        ok = (ldz != 0.0) & (t > 0.0) & in_ext
        if side == 0:
            ok &= front
        elif side == 1:
            ok &= ~front
        t = torch.where(ok, t, BIG)
        upd = t < bt
        fi = front.to(torch.int32)
        bt = torch.where(upd, t, bt)
        bface = torch.where(upd, -(2 + k * 4 + 2 + fi), bface)
        bfront = torch.where(upd, fi, bfront)
    return bt, bface, bfront


def _analytic_anyhit(sph, pln, o, d, tm, ana_bias, plane_world_bug):
    """Occlusion by the analytic instances within (ana_bias, tm)
    (analytic_anyhit, pallas_analytic.py:96-127)."""
    occ = torch.zeros_like(tm, dtype=torch.bool)
    for k in range(sph.shape[0]):
        lox, loy, loz, ldx, ldy, ldz = _local_ray(sph[k], o, d)
        a = ldx * ldx + ldy * ldy + ldz * ldz
        b = 2.0 * (ldx * lox + ldy * loy + ldz * loz)
        c = lox * lox + loy * loy + loz * loz - 1.0
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        tmin = (-b - sq) / torch.clamp_min(2.0 * a, 1e-30)
        occ |= (disc > 0.0) & (tmin > ana_bias) & (tmin < tm)
    for k in range(pln.shape[0]):
        lox, loy, loz, ldx, ldy, ldz = _local_ray(pln[k], o, d)
        t = -loz / torch.where(ldz == 0.0, 1e-30, ldz)
        if plane_world_bug:
            x = o[:, 0] + t * d[:, 0]
            y = o[:, 1] + t * d[:, 1]
        else:
            x = lox + t * ldx
            y = loy + t * ldy
        in_ext = (x.abs() <= 1.0) & (y.abs() <= 1.0)
        occ |= ((ldz != 0.0) & (t >= 0.0) & in_ext & (t > ana_bias)
                & (t < tm))
    return occ


def _face_test(rows, o, d, inv_dlen, side):
    """(R, C) (t, front, ok) of a ray block against a face block
    (_slab_test, pallas_stream.py:174-199)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r = [rows[:, j][None, :] for j in range(12)]
    tdiv = r[0] * dx + r[1] * dy + r[2] * dz
    pd = tdiv * inv_dlen[:, None]
    ok = pd.abs() >= PERP_EPS
    ndoto = r[0] * ox + r[1] * oy + r[2] * oz
    t = (r[3] - ndoto) / torch.where(tdiv == 0.0, 1e-30, tdiv)
    ok &= t > 0.0
    front = tdiv < 0.0
    if side == 0:
        ok &= front
    elif side == 1:
        ok &= ~front
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    b0 = r[4] * hx + r[5] * hy + r[6] * hz + r[7]
    b1 = r[8] * hx + r[9] * hy + r[10] * hz + r[11]
    b2 = 1.0 - b0 - b1
    ok &= (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
    return t, front, ok


def _inv_dlen(d):
    return 1.0 / torch.sqrt(torch.clamp_min(
        d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2], 1e-30))


def _blocks(n_rays, n_faces):
    fc = min(max(n_faces, 1), 2048)
    rc = max(1, _CHUNK // fc)
    for r0 in range(0, n_rays, rc):
        for f0 in range(0, n_faces, fc):
            yield slice(r0, r0 + rc), f0, slice(f0, f0 + fc)


def closest_over_faces(face_test, rows, sph, pln, o, d, t_init, side: int):
    """(t, key) of the closest hit of every ray over every row of `rows`
    under `face_test` (R rays x C rows -> (t, front, ok)) and over the
    analytic tables, seeded by t_init: lowest face among equal t, a mesh
    face replacing the analytic winner only when strictly closer."""
    ana_t, ana_code, ana_front = _analytic_closest(side, sph, pln, o, d,
                                                   t_init)
    best_t = ana_t.clone()
    best_key = torch.full_like(ana_code, BIGI)
    inv_dlen = _inv_dlen(d)
    for rs, f0, fs in _blocks(o.shape[0], rows.shape[0]):
        t, front, ok = face_test(rows[fs], o[rs], d[rs], inv_dlen[rs], side)
        tc = torch.where(ok, t, BIG)
        cmin, cidx = tc.min(dim=1)  # first (lowest-face) minimum
        cfront = front.gather(1, cidx[:, None])[:, 0].to(torch.int32)
        upd = cmin < best_t[rs]
        best_t[rs] = torch.where(upd, cmin, best_t[rs])
        best_key[rs] = torch.where(
            upd, (f0 + cidx.to(torch.int32)) * 2 + cfront, best_key[rs])
    mesh = best_key < BIGI
    return (torch.where(mesh, best_t, ana_t),
            torch.where(mesh, best_key, ana_code * 2 + ana_front))


def anyhit_over_faces(face_test, rows, sph, pln, o, d, t_max, t_min: float,
                      ana_bias: float, plane_world_bug: bool):
    """Occlusion of every ray by a front-facing row of `rows` in
    (t_min, t_max) or by an analytic occluder in (ana_bias, t_max)."""
    occ = _analytic_anyhit(sph, pln, o, d, t_max, ana_bias, plane_world_bug)
    inv_dlen = _inv_dlen(d)
    for rs, _, fs in _blocks(o.shape[0], rows.shape[0]):
        t, _, ok = face_test(rows[fs], o[rs], d[rs], inv_dlen[rs], 0)
        hit = ok & (t > t_min) & (t < t_max[rs, None])
        occ[rs] |= hit.any(dim=1)
    return occ


def stream_closest_ref(rows, sph, pln, o, d, t_init, side: int):
    """Plain PyTorch twin of the closest-hit kernel."""
    return closest_over_faces(_face_test, rows, sph, pln, o, d, t_init, side)


def stream_anyhit_ref(rows, sph, pln, o, d, t_max, t_min: float,
                      ana_bias: float, plane_world_bug: bool):
    """Plain PyTorch twin of the occlusion kernel."""
    return anyhit_over_faces(_face_test, rows, sph, pln, o, d, t_max, t_min,
                             ana_bias, plane_world_bug)


# ---------------------------------------------------------------------------
# public entry points: kernel on CUDA, twin on CPU
# ---------------------------------------------------------------------------


def check_inputs(rows, sph, pln, o, d, aux, row_multiple: int = ROW_PAD):
    """Raise ValueError on inputs the trace kernels do not take: float32,
    contiguous, one device, (R,16) face rows with R a multiple of
    row_multiple, at most MAX_ANALYTIC rows per analytic table."""
    dev = o.device
    for name, x, shape in (("rows", rows, (rows.shape[0], 16)),
                           ("sph", sph, (sph.shape[0], 12)),
                           ("pln", pln, (pln.shape[0], 12)),
                           ("o", o, (o.shape[0], 3)),
                           ("d", d, (o.shape[0], 3)),
                           ("aux", aux, (o.shape[0],))):
        kernels.require(x.dtype == torch.float32, f"{name}: float32 expected")
        kernels.require(x.device == dev, f"{name}: on {x.device}, rays on {dev}")
        kernels.require(tuple(x.shape) == shape, f"{name}: shape {tuple(x.shape)}")
        kernels.require(x.is_contiguous(), f"{name}: not contiguous")
    kernels.require(rows.shape[0] % row_multiple == 0,
                    f"rows: {rows.shape[0]} not a multiple of {row_multiple}")
    kernels.require(sph.shape[0] <= MAX_ANALYTIC and pln.shape[0] <= MAX_ANALYTIC,
                    "more than 32 spheres or planes")
    kernels.require(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")


def stream_closest(rows, sph, pln, o, d, t_init, side: str):
    """Closest hit of (N,3) rays o, d over the stream rows and the analytic
    tables, seeded by t_init: (t (N,) f32, key (N,) i32)."""
    check_inputs(rows, sph, pln, o, d, t_init)
    s = SIDES[side]
    if o.device.type == "cpu":
        return stream_closest_ref(rows, sph, pln, o, d, t_init, s)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    key = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        kernels.launch("bhrt_stream_closest", rows, rows.shape[0], sph,
                       sph.shape[0], pln, pln.shape[0], o, d, t_init, s, n,
                       t, key)
    return t, key


def stream_anyhit(rows, sph, pln, o, d, t_max, t_min: float,
                  ana_bias: float = 0.0, plane_world_bug: bool = False):
    """Occlusion (N,) bool of (N,3) rays within t_max (mesh faces beyond
    t_min, analytic occluders beyond ana_bias)."""
    check_inputs(rows, sph, pln, o, d, t_max)
    if o.device.type == "cpu":
        return stream_anyhit_ref(rows, sph, pln, o, d, t_max, t_min,
                                 ana_bias, plane_world_bug)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        kernels.launch("bhrt_stream_anyhit", rows, rows.shape[0], sph,
                       sph.shape[0], pln, pln.shape[0], o, d, t_max,
                       float(t_min), float(ana_bias), int(plane_world_bug), n,
                       occ)
    return occ
