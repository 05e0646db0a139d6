"""Host-side BVH builder over triangle bounds.

Functional equivalent of cy::BVH's mid-split build (cyBVH.h:122-142,
242-328: split at the center of the widest axis by element centroid, with
axis fallbacks and a forced halving when a side comes up empty; small leaves)
— but emitting a flat SoA layout instead of packed 32-bit node
words: per node AABB min/max, explicit child indices (siblings adjacent, as
in cyBVH.h:93), and a contiguous [face_start, face_start+count) range for
leaves (faces are reordered so every leaf is a contiguous slice).

A copy of bhraytracer_tpu/accel/bvh.py without the TPU treelet layout: the
BVH leaf order fixes the pack's face order, which both packages must share.
The port's stream kernels test every face and read no node; the tree and
its face order are kept for the BVH trace kernels still to be ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BVHArrays:
    # (B, 3) node bounds.
    bmin: np.ndarray
    bmax: np.ndarray
    # (B,) left child index (right child = left + 1); for leaves: face start.
    left: np.ndarray
    # (B,) leaf face count; 0 for internal nodes.
    count: np.ndarray
    # (F,) permutation: leaf-order slot -> original face index.
    face_order: np.ndarray
    # Maximum depth of the tree (traversal stack sizing).
    depth: int


def build_bvh(verts: np.ndarray, faces: np.ndarray, leaf_size: int = 4) -> BVHArrays:
    """Build a binary BVH. leaf_size mirrors TriObj's bvh.SetMesh(this, 4)
    (objects.h:59). Uses the native C++ builder when available; the Python
    fallback produces an equivalent (same-quality) tree."""
    from bhraytracer_tpu_torch.native.build import get_lib

    lib = get_lib()
    if lib is not None and faces.shape[0] > 0:
        import ctypes

        nf = faces.shape[0]
        cap = 2 * nf + 2
        verts_c = np.ascontiguousarray(verts, np.float32)
        faces_c = np.ascontiguousarray(faces, np.int32)
        bmin = np.zeros((cap, 3), np.float32)
        bmax = np.zeros((cap, 3), np.float32)
        left = np.zeros(cap, np.int32)
        count = np.zeros(cap, np.int32)
        order = np.zeros(nf, np.int32)
        depth = ctypes.c_int32(0)
        nn = lib.bhrt_bvh_build(
            verts_c.ctypes.data, faces_c.ctypes.data, nf, leaf_size,
            bmin.ctypes.data, bmax.ctypes.data, left.ctypes.data,
            count.ctypes.data, order.ctypes.data, ctypes.byref(depth),
        )
        if nn > 0:
            return BVHArrays(
                bmin=bmin[:nn], bmax=bmax[:nn], left=left[:nn],
                count=count[:nn], face_order=order, depth=int(depth.value),
            )
    return _build_bvh_py(verts, faces, leaf_size)


def _build_bvh_py(verts: np.ndarray, faces: np.ndarray, leaf_size: int = 4) -> BVHArrays:
    """Pure-numpy builder fallback."""
    nf = faces.shape[0]
    tri = verts[faces]  # (F, 3, 3)
    tmin = tri.min(axis=1)
    tmax = tri.max(axis=1)
    centroids = 0.5 * (tmin + tmax)

    bmins: list = []
    bmaxs: list = []
    lefts: list = []
    counts: list = []
    order: list = []
    max_depth = 1

    def reserve() -> int:
        bmins.append(None)
        bmaxs.append(None)
        lefts.append(0)
        counts.append(0)
        return len(bmins) - 1

    root = reserve()
    work = [(root, np.arange(nf), 1)]
    while work:
        node_id, elem, depth = work.pop()
        max_depth = max(max_depth, depth)
        bmins[node_id] = tmin[elem].min(axis=0)
        bmaxs[node_id] = tmax[elem].max(axis=0)
        if elem.shape[0] <= leaf_size:
            lefts[node_id] = len(order)
            counts[node_id] = elem.shape[0]
            order.extend(elem.tolist())
            continue
        cen = centroids[elem]
        ext = cen.max(axis=0) - cen.min(axis=0)
        mask = None
        # Try axes from widest; mid-split by centroid (cyBVH "MeanSplit").
        for axis in np.argsort(-ext):
            mid = 0.5 * (cen[:, axis].max() + cen[:, axis].min())
            m = cen[:, axis] < mid
            if m.any() and (~m).any():
                mask = m
                break
        if mask is None:
            # All centroids identical: forced halving (cyBVH.h:318-327).
            mask = np.zeros(elem.shape[0], bool)
            mask[: elem.shape[0] // 2] = True
        left_id = reserve()
        right_id = reserve()
        assert right_id == left_id + 1
        lefts[node_id] = left_id
        work.append((right_id, elem[~mask], depth + 1))
        work.append((left_id, elem[mask], depth + 1))

    return BVHArrays(
        bmin=np.asarray(bmins, np.float32).reshape(-1, 3),
        bmax=np.asarray(bmaxs, np.float32).reshape(-1, 3),
        left=np.asarray(lefts, np.int32),
        count=np.asarray(counts, np.int32),
        face_order=np.asarray(order, np.int32),
        depth=max_depth,
    )
