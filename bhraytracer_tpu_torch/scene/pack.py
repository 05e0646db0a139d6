"""ScenePack: the flat structure-of-arrays tensor form of a scene.

Field names and layouts are those of bhraytracer_tpu/scene/pack.py, so the
parity tests compare like with like, minus the TPU packet kernel's row
tables (`pallas_nodes`, `pallas_faces`, `treelets`) and plus the tables the
port's trace kernels read, derived from the world triangles and the BVH:
`stream_rows` (ops/stream.py), `bvh_pairs` and `bvh_faces` (ops/bvh.py).
The pack plays the part of the model's weights: `pack_from_numpy` carries
the JAX package's pack across, and `compile_scene` builds the same arrays
from a SceneDesc.

A pack lives on the card unless the caller asks for the CPU
(`device="cpu"`); without a card the default raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bhraytracer_tpu_torch.ops.bvh import LEAF_FACES, MAX_INDEX, leaf_code
from bhraytracer_tpu_torch.ops.linalg import BIG
from bhraytracer_tpu_torch.ops.stream import stream_table


@dataclasses.dataclass
class ScenePack:
    # ---- sphere / plane / mesh instances: world->local, local->world, pos,
    # material (one inert identity row when a category is empty) ----
    sph_itm: torch.Tensor  # (S,3,3)
    sph_tm: torch.Tensor
    sph_pos: torch.Tensor  # (S,3)
    sph_mtl: torch.Tensor  # (S,) i32
    pln_itm: torch.Tensor
    pln_tm: torch.Tensor
    pln_pos: torch.Tensor
    pln_mtl: torch.Tensor
    msh_itm: torch.Tensor
    msh_tm: torch.Tensor
    msh_pos: torch.Tensor
    msh_mtl: torch.Tensor  # (Mi,) i32, -1 = per-face table

    # ---- mesh geometry, faces in world-BVH leaf order ----
    verts: torch.Tensor  # (V,3) local frame
    normals: torch.Tensor  # (VN,3)
    uvs: torch.Tensor  # (VT,3)
    face_v: torch.Tensor  # (F,3) i32
    face_vn: torch.Tensor
    face_vt: torch.Tensor
    face_mtl: torch.Tensor  # (F,) i32
    face_inst: torch.Tensor  # (F,) i32
    bvh_bmin: torch.Tensor  # (B,3)
    bvh_bmax: torch.Tensor
    bvh_left: torch.Tensor  # (B,) i32
    bvh_count: torch.Tensor  # (B,) i32
    wtri_v0: torch.Tensor  # (F,3) world-space triangles
    wtri_v1: torch.Tensor
    wtri_v2: torch.Tensor
    # Local-frame resolve row per face: [v0 v1 v2 | vn0 vn1 vn2 | uv0 uv1 uv2
    # | face_mtl | pad] (the one-row gather of resolve_hit's fast form).
    resolve_rows: torch.Tensor  # (F,32)
    # Affine-barycentric stream rows (ops/stream.py), padded with zero rows.
    stream_rows: torch.Tensor  # (F_pad,16)
    # BVH rows (ops/bvh.py): the kernels' sibling-pair table [bmin bmax |
    # code mag] with one pad row first (pair_table), and, in leaf order,
    # [v0 v1 v2 | n | n.v0 | 1/|n| | pad].
    bvh_pairs: torch.Tensor  # (B+1,8)
    bvh_faces: torch.Tensor  # (F,16)

    # ---- materials ----
    mtl_diffuse: torch.Tensor  # (M,3)
    mtl_specular: torch.Tensor
    mtl_gloss: torch.Tensor  # (M,)
    mtl_emission: torch.Tensor
    mtl_reflection: torch.Tensor
    mtl_refl_gloss: torch.Tensor
    mtl_refraction: torch.Tensor
    mtl_refr_gloss: torch.Tensor
    mtl_ior: torch.Tensor
    mtl_absorption: torch.Tensor
    mtl_diffuse_tm: torch.Tensor  # (M,) i32 texmap id or -1
    mtl_specular_tm: torch.Tensor
    mtl_emission_tm: torch.Tensor
    mtl_reflection_tm: torch.Tensor
    mtl_refraction_tm: torch.Tensor

    # ---- texture maps and textures (carried; rendering them is not ported)
    tm_tex: torch.Tensor
    tm_itm: torch.Tensor
    tm_pos: torch.Tensor
    tex_kind: torch.Tensor
    tex_c1: torch.Tensor
    tex_c2: torch.Tensor
    tex_wh: torch.Tensor
    atlas: torch.Tensor

    # ---- background / environment ----
    bg_color: torch.Tensor  # (3,)
    bg_tm: torch.Tensor  # () i32
    env_color: torch.Tensor
    env_tm: torch.Tensor

    # ---- lights, ascending by gray intensity ----
    light_kind: torch.Tensor  # (L,) i32: 0 ambient, 1 direct, 2 point
    light_intensity: torch.Tensor
    light_vec: torch.Tensor
    light_size: torch.Tensor

    bvh_depth: int = 1
    n_sph: int = 0
    n_pln: int = 0
    n_msh: int = 0
    n_lights: int = 0
    has_file_tex: bool = False
    n_texmaps: int = 0
    # Tables derived at first use (ops/cull.py:cluster_tables,
    # ops/trace.py:analytic_tables); a dataclasses.replace starts an empty
    # one.
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.stream_rows.device


_META = ("bvh_depth", "n_sph", "n_pln", "n_msh", "n_lights", "has_file_tex",
         "n_texmaps")
_DERIVED = ("stream_rows", "bvh_pairs", "bvh_faces")
_DATA = tuple(f.name for f in dataclasses.fields(ScenePack)
              if f.name not in _META + _DERIVED + ("cache",))


def resolve_device(device=None) -> torch.device:
    """The device a pack is built on: the card unless `device` says
    otherwise. Raises where the default is asked for and no CUDA device
    exists (the CPU is taken only when asked for)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "scene on the CPU")
    return torch.device("cuda")


def face_planes(wtri_v0, wtri_v1, wtri_v2):
    """Per-face (normal (F,3), 1/|normal| (F,)) in float32, computed as
    bhraytracer_tpu/scene/compile.py packs them into pallas_faces[:, 9:14]."""
    f32 = np.float32
    fn_ = np.cross(wtri_v1 - wtri_v0, wtri_v2 - wtri_v0).astype(f32)
    nlen = np.sqrt(np.maximum((fn_ * fn_).sum(1), 1e-30))
    return fn_, (1.0 / nlen).astype(f32)


def bvh_tables(bvh_bmin, bvh_bmax, bvh_left, bvh_count, v0, v1, v2):
    """(pairs (B+1,8), faces (F,16)) float32 rows of the BVH kernels, from
    the tree (pair_table) and the world triangles in leaf order, the faces
    as bhraytracer_tpu/scene/compile.py:191-223 computes its single-shot
    packet table (so a JAX pack with treelets gives the same tables as one
    without)."""
    f32 = np.float32
    faces = np.zeros((v0.shape[0], 16), f32)
    faces[:, 0:3] = v0
    faces[:, 3:6] = v1
    faces[:, 6:9] = v2
    fn_, inv_nlen = face_planes(v0, v1, v2)
    faces[:, 9:12] = fn_
    faces[:, 12] = np.einsum("ij,ij->i", fn_, v0).astype(f32)
    faces[:, 13] = inv_nlen
    return pair_table(bvh_bmin, bvh_bmax, bvh_left, bvh_count), faces


def pair_table(bvh_bmin, bvh_bmax, bvh_left, bvh_count):
    """(B+1, 8) float32 sibling-pair table of the BVH kernels: row r + 1
    holds node r as [bmin (3), bmax (3), code, mag], the two float4 that
    csrc/bvh.cu reads for a box, and row 0 an empty box (BIG, -BIG) that no
    ray enters. `code` is int32 bits: an inner node's `left`, a leaf's
    `leaf_code` (ops/bvh.py); `mag` is max |bmin|, |bmax|, the box's
    widening scale (csrc/trace.cuh:box_mag). The builder puts the children
    of every inner node at `left`, `left + 1` with `left` odd, so each pair
    fills rows left + 1 (even) and left + 2: one aligned 64-byte line, which
    the kernels fetch whole to test both children and learn where each
    leads. Raises ValueError on a tree without that layout, or past the leaf
    code: nodes and faces below MAX_INDEX, leaves of fewer than LEAF_FACES
    faces."""
    f32 = np.float32
    left, count = bvh_left.astype(np.int64), bvh_count.astype(np.int64)
    internal = count == 0
    if (internal.any() and ((left[internal] % 2 != 1).any()
                            or left[internal].max() + 1 >= left.shape[0])):
        raise ValueError("BVH: siblings not at (left, left + 1), left odd")
    leaf = ~internal
    if (left.shape[0] >= MAX_INDEX
            or leaf.any() and ((count[leaf] >= LEAF_FACES).any()
                               or (left[leaf] + count[leaf]).max()
                               > MAX_INDEX)):
        raise ValueError(f"BVH: {MAX_INDEX} nodes or faces or more, or a "
                         f"leaf of {LEAF_FACES} faces or more")
    box = np.concatenate([bvh_bmin, bvh_bmax], 1).astype(f32)
    a = np.abs(box)
    mag = np.fmax(np.fmax(np.fmax(a[:, 0], a[:, 1]),
                          np.fmax(a[:, 2], a[:, 3])),
                  np.fmax(a[:, 4], a[:, 5]))
    code = np.where(internal, left, leaf_code(left, count)).astype(np.int32)
    pairs = np.zeros((box.shape[0] + 1, 8), f32)
    pairs[0, 0:3] = BIG
    pairs[0, 3:6] = -BIG
    pairs[0, 7] = BIG
    pairs[1:, 0:6] = box
    pairs[1:, 6] = code.view(f32)
    pairs[1:, 7] = mag
    return pairs


def pack_from_numpy(d: dict, device=None) -> ScenePack:
    """Build the port's pack from the JAX pack as numpy arrays, on `device`
    (the card by default, see resolve_device).

    `d` maps every field of the JAX ScenePack to a numpy array (as
    `jax.tree.map(np.asarray, pack)` gives) or, for the static fields, to
    an int; fields the port has no use for (`pallas_*`, `treelets`) are
    ignored. The trace tables are derived from the world triangles and the
    tree."""
    device = resolve_device(device)
    t = {k: torch.from_numpy(np.array(d[k], order="C")).to(device)
         for k in _DATA}
    v0, v1, v2 = (np.array(d[k], np.float32)
                  for k in ("wtri_v0", "wtri_v1", "wtri_v2"))
    fn_, inv_nlen = face_planes(v0, v1, v2)
    rows = stream_table(
        *(torch.from_numpy(x).to(device) for x in (v0, v1, v2, fn_, inv_nlen)))
    tree = [np.asarray(d[k]) for k in ("bvh_bmin", "bvh_bmax", "bvh_left",
                                       "bvh_count")]
    pairs, faces = bvh_tables(*tree, v0, v1, v2)
    meta = {k: (bool(d[k]) if k == "has_file_tex" else int(d[k]))
            for k in _META}
    return ScenePack(**t, stream_rows=rows,
                     bvh_pairs=torch.from_numpy(pairs).to(device),
                     bvh_faces=torch.from_numpy(faces).to(device), **meta)
