"""The per-ray cluster cull of the face-stream kernels: kernels 1 and 2
(ops/stream.py, meshes of up to 8192 faces) and kernels 6 and 7
(ops/stream_hbm.py, bigger meshes), all in csrc/cull.cuh (closest hits in
`cull_closest_kernel`, occlusion in `cull_anyhit_kernel`).

`cluster_tables` cuts a pack's stream rows, which are in BVH leaf order and
so spatially tight, into clusters of CLUSTER consecutive faces with the
bounding box of each, and puts SUPER consecutive clusters under one super
box. A ray enters a box it crosses at t_lo <= its best t so far (closest)
or t_lo < t_max (occlusion), in the BVH kernels' slab test widened by
BOX_EPS of the box's and the ray origin's coordinate magnitude
(csrc/trace.cuh:box_test; `slab_entry` is its twin). The widening covers
the rounding of the face test and of the slab arithmetic, so the cull drops
nothing a ray could hit, and a culled trace equals the brute-force twins'
key for key. `cluster_cull_ref` gives the (ray, cluster) pairs a kernel's
cull keeps, for the tests.
"""

from __future__ import annotations

import torch

from bhraytracer_tpu_torch.ops import kernels
from bhraytracer_tpu_torch.ops.linalg import BIG

CLUSTER = 32  # faces a cluster on the main paths
SUPER = 32  # clusters a super box (csrc/cull.cuh: kSuper)
MAX_CLUSTER = 128
BOX_EPS = 2.0 ** -16  # box widening, relative to coordinate size
WARPS = 8  # warps a kernel block (csrc/cull.cuh: kCullWarps)
# Static shared memory of a culling block: two analytic tables of 32 rows
# of 12 floats (csrc/common.cuh: BHRT_MAX_ANALYTIC) and an mbarrier.
STATIC_SMEM = 2 * 32 * 12 * 4 + 8
# Dynamic shared memory a block may take: the card's 227 KB a block less
# the static tables.
SMEM_BUDGET = 232448 - STATIC_SMEM
_PAIRS = 1 << 19  # ray x box tests per step of the twins


def smem_bytes(n_super: int, cluster: int) -> int:
    """Dynamic shared memory a culling block takes: the super and cluster
    box tables (32 bytes a box), then each warp's two slots of `cluster`
    rows of 48 bytes (csrc/cull.cuh:cull_smem_bytes)."""
    return 32 * n_super * (1 + SUPER) + WARPS * 2 * 48 * cluster


def cluster_tables(pack, cluster: int = CLUSTER):
    """(rows (K*cluster, 16), cluster_boxes (K, 8), super_boxes (K/SUPER, 8))
    of the pack's faces, K a multiple of SUPER: the stream rows padded with
    zero rows (which no face test accepts) to whole super boxes, and
    [bmin (3), bmax (3), 0, 0] of each cluster's triangles and of each SUPER
    consecutive clusters. A cluster of padding rows has the empty box
    (BIG, -BIG), which no ray enters. Built at first use and kept in
    pack.cache."""
    key = ("cluster_tables", cluster)
    if key not in pack.cache:
        kernels.require(1 <= cluster <= MAX_CLUSTER,
                        f"cluster {cluster}: not in 1..{MAX_CLUSTER}")
        n_faces = pack.wtri_v0.shape[0]
        v = torch.stack([pack.wtri_v0, pack.wtri_v1, pack.wtri_v2], 1)
        n_super = -(-n_faces // (cluster * SUPER))
        k = n_super * SUPER
        pad = k * cluster - n_faces
        lo = torch.cat([v.amin(1), v.new_full((pad, 3), BIG)])
        hi = torch.cat([v.amax(1), v.new_full((pad, 3), -BIG)])
        lo = lo.reshape(k, cluster, 3).amin(1)
        hi = hi.reshape(k, cluster, 3).amax(1)

        def table(lo, hi):
            return torch.cat([lo, hi, lo.new_zeros((lo.shape[0], 2))],
                             1).contiguous()

        rows = torch.cat([pack.stream_rows[:n_faces],
                          pack.stream_rows.new_zeros((pad, 16))]).contiguous()
        pack.cache[key] = (
            rows, table(lo, hi),
            table(lo.reshape(n_super, SUPER, 3).amin(1),
                  hi.reshape(n_super, SUPER, 3).amax(1)))
    return pack.cache[key]


def check_boxes(cluster_boxes, super_boxes, o) -> int:
    """Raise ValueError on box tables the kernels do not take: (K, 8) and
    (K/SUPER, 8) float32, contiguous, on the
    rays' device (16-byte aligned there, for the kernels' bulk copies), K a
    positive multiple of SUPER. Returns K."""
    kernels.check_table("cluster_boxes", cluster_boxes, 8)
    kernels.check_table("super_boxes", super_boxes, 8)
    k = cluster_boxes.shape[0]
    kernels.require(k > 0 and k % SUPER == 0
                    and super_boxes.shape[0] * SUPER == k,
                    f"boxes: {k} cluster boxes and {super_boxes.shape[0]} "
                    f"super boxes, not whole super boxes of {SUPER}")
    kernels.require(cluster_boxes.device == super_boxes.device == o.device,
                    "boxes: not on the rays' device")
    if o.device.type == "cuda":
        kernels.require(cluster_boxes.data_ptr() % 16 == 0
                        and super_boxes.data_ptr() % 16 == 0,
                        "boxes: not 16-byte aligned")
    return k


# ---------------------------------------------------------------------------
# plain PyTorch twins of the cull
# ---------------------------------------------------------------------------


def slab_entry(box, o, d):
    """(t_lo, crosses) of rays o, d (columns o[..., k], d[..., k]) against
    boxes (columns box[..., k], k < 6: bmin, bmax), every operand
    broadcasting against the others: the kernels' widened slab test
    (csrc/trace.cuh:box_mag and slab_test), in their arithmetic."""
    inv = [1.0 / torch.where(d[..., k] == 0.0, 1e-30, d[..., k])
           for k in range(3)]
    a = [o[..., k].abs() for k in range(3)]
    omag = torch.fmax(a[0], torch.fmax(a[1], a[2]))
    a = [box[..., k].abs() for k in range(6)]
    mag = torch.fmax(torch.fmax(torch.fmax(a[0], a[1]),
                                torch.fmax(a[2], a[3])),
                     torch.fmax(a[4], a[5]))
    pad = BOX_EPS * (mag + omag)
    near, far = [], []
    for ax in range(3):
        lo, hi = box[..., ax] - pad, box[..., 3 + ax] + pad
        pos = inv[ax] >= 0.0
        near.append((torch.where(pos, lo, hi) - o[..., ax]) * inv[ax])
        far.append((torch.where(pos, hi, lo) - o[..., ax]) * inv[ax])
    t_lo = torch.fmax(torch.fmax(near[0], near[1]), near[2])
    t_hi = torch.fmin(torch.fmin(far[0], far[1]), far[2])
    return t_lo, (t_lo <= t_hi) & (t_hi >= 0.0)


def _entry(boxes, o, d):
    """(t_lo, crosses), each (R, B), of rays o, d against boxes (B, 8)."""
    return slab_entry(boxes[None, :, :], o[:, None, :], d[:, None, :])


def _live_pairs(boxes, o, d, admit):
    """(ray, cluster) index pairs, ray-major, of the boxes each ray crosses
    and `admit(t_lo, rays)` ((R, B) bool, rays a slice) lets it enter."""
    step = max(1, _PAIRS // boxes.shape[0])
    rays, cls = [], []
    for r0 in range(0, o.shape[0], step):
        rs = slice(r0, r0 + step)
        t_lo, crosses = _entry(boxes, o[rs], d[rs])
        r, c = (crosses & admit(t_lo, rs)).nonzero(as_tuple=True)
        rays.append(r + r0)
        cls.append(c)
    return torch.cat(rays), torch.cat(cls)


def cluster_cull_ref(cluster_boxes, super_boxes, o, d, cap,
                     strict: bool = False):
    """(ray, cluster) index pairs, ray-major, that a kernel's walk visits
    for the rays with the cap fixed at `cap` (N,): a ray enters a cluster
    when it enters the cluster's super box and the cluster's own box, at
    t_lo <= cap (t_lo < cap with `strict`, as the occlusion kernel). The
    closest kernels lower a ray's cap as they find hits, which only drops
    clusters that hold no closer face."""
    def admit(t_lo, rs):
        return t_lo < cap[rs, None] if strict else t_lo <= cap[rs, None]

    step = max(1, _PAIRS // cluster_boxes.shape[0])
    rays, cls = [], []
    for r0 in range(0, o.shape[0], step):
        rs = slice(r0, r0 + step)
        s_lo, s_in = _entry(super_boxes, o[rs], d[rs])
        c_lo, c_in = _entry(cluster_boxes, o[rs], d[rs])
        keep = (c_in & admit(c_lo, rs)
                & (s_in & admit(s_lo, rs)).repeat_interleave(SUPER, 1))
        r, c = keep.nonzero(as_tuple=True)
        rays.append(r + r0)
        cls.append(c)
    return torch.cat(rays), torch.cat(cls)
