"""Grouped face-stream closest-hit and occlusion traces for big meshes
(kernels 6 and 7).

Ports `stream_closest_hbm` / `stream_anyhit_hbm` of
bhraytracer_tpu/ops/pallas_stream_hbm.py. The face rows are the flat
stream kernels' (`pack.stream_rows`, ops/stream.py) cut into groups of
`group` consecutive faces, each with the bounding box of its triangles
(`group_tables`, built at first use and kept per pack and group size). A
block of RAY_BLOCK consecutive rays reduces its origin and direction boxes,
walks the groups in order, and skips a group whose conservative interval
window (`_window`, pallas_stream_hbm.py:127-152, widened by GROUP_EPS of
the coordinates' magnitude) cannot be crossed in (0, cap), cap being the
block's largest best t so far. The cull only pays on coherence-sorted rays
(ops/trace.py sorts them); it drops nothing a ray could hit, so the result
equals the flat kernels' key for key.

Each public function dispatches on the device of its tensors: a CUDA
tensor goes to the kernel in csrc/stream_hbm.cu, a CPU tensor to the `_ref`
twin, which makes the same per-block window decisions in the same
arithmetic and runs the flat twins' face test over the surviving groups.
"""

from __future__ import annotations

import torch

from bhraytracer_tpu_torch.ops import kernels
from bhraytracer_tpu_torch.ops.linalg import BIG
from bhraytracer_tpu_torch.ops.stream import (
    BIGI,
    SIDES,
    _analytic_anyhit,
    _analytic_closest,
    _face_test,
    _CHUNK,
    _inv_dlen,
    check_inputs,
)

GROUP = 2048  # faces per culled group (pallas_stream_hbm.py:63)
RAY_BLOCK = 128  # rays per CUDA block, and per culling box
GROUP_EPS = 2.0 ** -16  # group-box widening, relative to coordinate size
TILE = 128  # the kernels stage this many rows at a time; group % TILE == 0


def group_tables(pack, group: int = GROUP):
    """(rows (G*group, 16), boxes (G, 8)) of the pack's faces: the stream
    rows padded with zero rows (culled everywhere) to whole groups, and per
    group [bmin (3), bmax (3), 0, 0] over its real triangles
    (_group_tables, pallas_stream_hbm.py:89-110)."""
    key = ("group_tables", group)
    if key not in pack.cache:
        kernels.require(group > 0 and group % TILE == 0,
                        f"group {group}: not a positive multiple of {TILE}")
        n_faces = pack.wtri_v0.shape[0]
        v = torch.stack([pack.wtri_v0, pack.wtri_v1, pack.wtri_v2], 1)
        n_groups = -(-n_faces // group)
        pad = n_groups * group - n_faces
        vmin = torch.cat([v.amin(1), v.new_full((pad, 3), BIG)])
        vmax = torch.cat([v.amax(1), v.new_full((pad, 3), -BIG)])
        boxes = torch.cat([vmin.reshape(n_groups, group, 3).amin(1),
                           vmax.reshape(n_groups, group, 3).amax(1),
                           v.new_zeros((n_groups, 2))], 1).contiguous()
        rows = torch.cat([pack.stream_rows[:n_faces],
                          pack.stream_rows.new_zeros((pad, 16))]).contiguous()
        pack.cache[key] = (rows, boxes)
    return pack.cache[key]


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _block_rays(o, d):
    """Rays padded to whole blocks by repeating the last one, and the
    blocks' boxes (nb, 13): [lo (3), hi (3), dlo (3), dhi (3), max |lo|,|hi|]."""
    n = o.shape[0]
    nb = -(-n // RAY_BLOCK)
    src = torch.clamp_max(torch.arange(nb * RAY_BLOCK, device=o.device), n - 1)
    op, dp = o[src], d[src]
    ob, db = op.reshape(nb, RAY_BLOCK, 3), dp.reshape(nb, RAY_BLOCK, 3)
    lo, hi = ob.amin(1), ob.amax(1)
    mag = torch.cat([lo, hi], 1).abs().amax(1, keepdim=True)
    rbox = torch.cat([lo, hi, db.amin(1), db.amax(1), mag], 1)
    return src, op, dp, rbox


def _window(box, rbox):
    """(t_lo, t_hi), each (nb,), of every ray block against group box `box`
    (8,): the kernels' widened interval slab window
    (csrc/stream_hbm.cu:group_live), before the cap test."""
    pad = GROUP_EPS * (box[:6].abs().amax() + rbox[:, 12])
    t_lo = torch.full_like(pad, -BIG)
    t_hi = torch.full_like(pad, BIG)
    for ax in range(3):
        blo, bhi = box[ax] - pad, box[3 + ax] + pad
        lo_a, hi_a = rbox[:, ax], rbox[:, 3 + ax]
        dl, dh = rbox[:, 6 + ax], rbox[:, 9 + ax]
        mixed = (dl <= 0.0) & (dh >= 0.0)
        rl = 1.0 / torch.where(dl == 0.0, 1e-30, dl)
        rh = 1.0 / torch.where(dh == 0.0, 1e-30, dh)
        a1, a2 = blo - lo_a, blo - hi_a
        b1, b2 = bhi - lo_a, bhi - hi_a
        qs = torch.stack([a1 * rl, a1 * rh, a2 * rl, a2 * rh,
                          b1 * rl, b1 * rh, b2 * rl, b2 * rh])
        t_lo = torch.maximum(t_lo, torch.where(mixed, -BIG, qs.amin(0)))
        t_hi = torch.minimum(t_hi, torch.where(mixed, BIG, qs.amax(0)))
    return t_lo, t_hi


def _live_blocks(box, rbox, cap):
    t_lo, t_hi = _window(box, rbox)
    live = (t_lo <= t_hi) & (t_hi > 0.0) & (t_lo < cap)
    return live.nonzero()[:, 0]


def _lanes(blocks, group: int):
    """The lanes of the given blocks, in pieces of at most _CHUNK ray x
    face pairs against one group."""
    lanes = (blocks[:, None] * RAY_BLOCK
             + torch.arange(RAY_BLOCK, device=blocks.device)).reshape(-1)
    return lanes.split(max(RAY_BLOCK, _CHUNK // group))


def stream_closest_hbm_ref(rows, boxes, group: int, sph, pln, o, d, t_init,
                           side: int):
    """Plain PyTorch twin of the grouped closest-hit kernel."""
    n = o.shape[0]
    if not n:
        return t_init.clone(), torch.zeros_like(t_init, dtype=torch.int32)
    src, op, dp, rbox = _block_rays(o, d)
    nb = rbox.shape[0]
    ana_t, ana_code, ana_front = _analytic_closest(side, sph, pln, op, dp,
                                                   t_init[src])
    best_t = ana_t.clone()
    best_key = torch.full_like(ana_code, BIGI)
    inv_dlen = _inv_dlen(dp)
    cap = best_t.reshape(nb, RAY_BLOCK).amax(1)
    for g in range(boxes.shape[0]):
        blocks = _live_blocks(boxes[g], rbox, cap)
        if not blocks.numel():
            continue
        for lanes in _lanes(blocks, group):
            t, front, ok = _face_test(rows[g * group:(g + 1) * group],
                                      op[lanes], dp[lanes], inv_dlen[lanes],
                                      side)
            tc = torch.where(ok, t, BIG)
            cmin, cidx = tc.min(dim=1)  # first (lowest-face) minimum
            cfront = front.gather(1, cidx[:, None])[:, 0].to(torch.int32)
            upd = cmin < best_t[lanes]
            best_t[lanes] = torch.where(upd, cmin, best_t[lanes])
            best_key[lanes] = torch.where(
                upd, (g * group + cidx.to(torch.int32)) * 2 + cfront,
                best_key[lanes])
        cap[blocks] = best_t.reshape(nb, RAY_BLOCK)[blocks].amax(1)
    mesh = best_key[:n] < BIGI
    return (torch.where(mesh, best_t[:n], ana_t[:n]),
            torch.where(mesh, best_key[:n], ana_code[:n] * 2 + ana_front[:n]))


def stream_anyhit_hbm_ref(rows, boxes, group: int, sph, pln, o, d, t_max,
                          t_min: float, ana_bias: float,
                          plane_world_bug: bool):
    """Plain PyTorch twin of the grouped occlusion kernel."""
    n = o.shape[0]
    if not n:
        return torch.zeros_like(t_max, dtype=torch.bool)
    src, op, dp, rbox = _block_rays(o, d)
    nb = rbox.shape[0]
    tm = t_max[src]
    occ = _analytic_anyhit(sph, pln, op, dp, tm, ana_bias, plane_world_bug)
    inv_dlen = _inv_dlen(dp)

    def caps(blocks=slice(None)):
        return torch.where(occ, 0.0, tm).reshape(nb, RAY_BLOCK)[blocks].amax(1)

    cap = caps()
    for g in range(boxes.shape[0]):
        blocks = _live_blocks(boxes[g], rbox, cap)
        if not blocks.numel():
            continue
        for lanes in _lanes(blocks, group):
            t, _, ok = _face_test(rows[g * group:(g + 1) * group], op[lanes],
                                  dp[lanes], inv_dlen[lanes], 0)
            occ[lanes] |= (ok & (t > t_min)
                           & (t < tm[lanes, None])).any(dim=1)
        cap[blocks] = caps(blocks)
    return occ[:n]


# ---------------------------------------------------------------------------
# public entry points: kernel on CUDA, twin on CPU
# ---------------------------------------------------------------------------


def _check(rows, boxes, group, sph, pln, o, d, aux):
    check_inputs(rows, sph, pln, o, d, aux, row_multiple=group)
    kernels.require(group > 0 and group % TILE == 0,
                    f"group {group}: not a positive multiple of {TILE}")
    kernels.require(boxes.dtype == torch.float32 and boxes.is_contiguous()
                    and tuple(boxes.shape) == (rows.shape[0] // group, 8),
                    f"boxes: {boxes.dtype} {tuple(boxes.shape)}")
    kernels.require(boxes.device == o.device, "boxes: not on the rays' device")


def stream_closest_hbm(rows, boxes, group: int, sph, pln, o, d, t_init,
                       side: str):
    """Closest hit of (N,3) rays o, d (coherence-sorted, for the cull to
    pay) over the grouped rows and the analytic tables, seeded by t_init:
    (t (N,) f32, key (N,) i32), the flat stream kernels' contract."""
    _check(rows, boxes, group, sph, pln, o, d, t_init)
    s = SIDES[side]
    if o.device.type == "cpu":
        return stream_closest_hbm_ref(rows, boxes, group, sph, pln, o, d,
                                      t_init, s)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    key = torch.empty(n, dtype=torch.int32, device=o.device)
    if n:
        kernels.launch("bhrt_stream_closest_hbm", rows, boxes, boxes.shape[0],
                       group, sph, sph.shape[0], pln, pln.shape[0], o, d,
                       t_init, s, n, t, key)
    return t, key


def stream_anyhit_hbm(rows, boxes, group: int, sph, pln, o, d, t_max,
                      t_min: float, ana_bias: float = 0.0,
                      plane_world_bug: bool = False):
    """Occlusion (N,) bool of (N,3) rays (coherence-sorted) within t_max
    (front mesh faces beyond t_min, analytic occluders beyond ana_bias)."""
    _check(rows, boxes, group, sph, pln, o, d, t_max)
    if o.device.type == "cpu":
        return stream_anyhit_hbm_ref(rows, boxes, group, sph, pln, o, d,
                                     t_max, t_min, ana_bias, plane_world_bug)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        kernels.launch("bhrt_stream_anyhit_hbm", rows, boxes, boxes.shape[0],
                       group, sph, sph.shape[0], pln, pln.shape[0], o, d,
                       t_max, float(t_min), float(ana_bias),
                       int(plane_world_bug), n, occ)
    return occ
