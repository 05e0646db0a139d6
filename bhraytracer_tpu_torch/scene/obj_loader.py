"""Wavefront OBJ/MTL loader (cyTriMesh.h:263+ equivalent, built new).

Parses v/vn/vt/f with fan triangulation and v | v/t | v//n | v/t/n and
negative index forms, plus the MTL fields the reference consumes for its
auto-generated multi-material (Kd/Ks/Tf/Ns/Ni/illum/map_Kd/map_Ks;
xmlload.cpp:219-250). Computes area-weighted smooth normals when the file has
none (objects.h:57).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from bhraytracer_tpu_torch.scene.desc import MeshDesc


def _resolve_index(tok: str, count: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else count + i


def parse_mtl(path: str) -> List[Dict]:
    """Parse a .mtl file into a list of dicts (one per newmtl)."""
    mtls: List[Dict] = []
    cur: Optional[Dict] = None
    if not os.path.exists(path):
        return mtls
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                cur = {
                    "name": tok[1] if len(tok) > 1 else "",
                    "Ka": np.zeros(3),
                    "Kd": np.full(3, 0.8),
                    "Ks": np.zeros(3),
                    "Tf": np.zeros(3),
                    "Ns": 0.0,
                    "Ni": 1.0,
                    "illum": 2,
                    "map_Kd": None,
                    "map_Ks": None,
                }
                mtls.append(cur)
            elif cur is None:
                continue
            elif key in ("Ka", "Kd", "Ks", "Tf"):
                cur[key] = np.array([float(x) for x in tok[1:4]])
            elif key in ("Ns", "Ni"):
                cur[key] = float(tok[1])
            elif key == "illum":
                cur[key] = int(tok[1])
            elif key in ("map_Kd", "map_Ks"):
                cur[key] = tok[-1]
    return mtls


def compute_smooth_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (cyTriMesh::ComputeNormals equivalent)."""
    vn = np.zeros_like(verts)
    v0 = verts[faces[:, 0]]
    fn = np.cross(verts[faces[:, 1]] - v0, verts[faces[:, 2]] - v0)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norms = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.where(norms > 0, norms, 1.0)).astype(np.float32)


def _parse_obj_native(path: str):
    """Native OBJ geometry parse (bhrt_native.cpp bhrt_obj_*). Returns the
    same (verts, norms, uvs, fv, fn, ft, fm, mtl_names, mtllib_paths)
    tuple _parse_obj_py produces, or None if the native lib is absent."""
    import ctypes

    from bhraytracer_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    counts = (ctypes.c_int64 * 8)()
    h = lib.bhrt_obj_load(path.encode(), counts)
    if not h:
        raise FileNotFoundError(path)
    try:
        if int(counts[6]):
            # Malformed file (bad face index): fall back to the Python
            # parser, which raises the informative ValueError.
            return None
        nv, nn, nt, nf, nb, mb = (int(counts[k]) for k in range(6))
        v = np.empty((nv, 3), np.float32)
        vn = np.empty((nn, 3), np.float32)
        vt = np.empty((nt, 3), np.float32)
        fv = np.empty((nf, 3), np.int32)
        fn = np.empty((nf, 3), np.int32)
        ft = np.empty((nf, 3), np.int32)
        fm = np.empty((nf,), np.int32)
        names = ctypes.create_string_buffer(max(nb, 1))
        libs = ctypes.create_string_buffer(max(mb, 1))
        lib.bhrt_obj_fill(
            h, v.ctypes.data, vn.ctypes.data, vt.ctypes.data,
            fv.ctypes.data, fn.ctypes.data, ft.ctypes.data, fm.ctypes.data,
            names, libs)
    finally:
        lib.bhrt_obj_free(h)
    mtl_names = names.raw[:nb].decode(errors="replace").split("\n") if nb else []
    mtllibs = libs.raw[:mb].decode(errors="replace").split("\n") if mb else []
    return v, vn, vt, fv, fn, ft, fm, mtl_names, mtllibs


def _parse_obj_py(path: str):
    """Pure-Python OBJ geometry parse; bit-identical to the native path."""
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    uvs: List[List[float]] = []
    fv: List[List[int]] = []
    fn: List[List[int]] = []
    ft: List[List[int]] = []
    fm: List[int] = []
    mtl_names: List[str] = []
    mtllibs: List[str] = []
    cur_mtl = -1

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif key == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif key == "vt":
                vals = [float(x) for x in tok[1:4]]
                while len(vals) < 3:
                    vals.append(0.0)
                uvs.append(vals)
            elif key == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name in mtl_names:
                    cur_mtl = mtl_names.index(name)
                else:
                    mtl_names.append(name)
                    cur_mtl = len(mtl_names) - 1
            elif key == "mtllib":
                mtllibs.append(" ".join(tok[1:]))
            elif key == "f":
                corners = []
                for vtok in tok[1:]:
                    parts = vtok.split("/")
                    vi = _resolve_index(parts[0], len(verts))
                    ti = (
                        _resolve_index(parts[1], len(uvs))
                        if len(parts) > 1 and parts[1]
                        else -1
                    )
                    ni = (
                        _resolve_index(parts[2], len(norms))
                        if len(parts) > 2 and parts[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                # Fan triangulation, as in cyTriMesh's OBJ reader.
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    fv.append([c[0] for c in tri])
                    ft.append([c[1] for c in tri])
                    fn.append([c[2] for c in tri])
                    fm.append(cur_mtl)

    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(norms, np.float32).reshape(-1, 3),
            np.asarray(uvs, np.float32).reshape(-1, 3),
            np.asarray(fv, np.int32).reshape(-1, 3),
            np.asarray(fn, np.int32).reshape(-1, 3),
            np.asarray(ft, np.int32).reshape(-1, 3),
            np.asarray(fm, np.int32).reshape(-1),
            mtl_names, mtllibs)


def load_obj(path: str, load_mtl: bool = True,
             native: bool = True) -> MeshDesc:
    """Load an OBJ (+MTL) into a MeshDesc. The geometry hot loop runs in the
    native helper when available (bhrt_native.cpp, the cyTriMesh.h:263+
    counterpart); `native=False` forces the bit-identical Python parser."""
    parsed = _parse_obj_native(path) if native else None
    if parsed is None:
        parsed = _parse_obj_py(path)
    verts_a, norms_a, uvs_a, fv_a, fn_a, ft_a, fm_a, mtl_names, mtllibs = parsed
    faces_a = fv_a

    obj_materials: List[Dict] = []
    if load_mtl:
        for rel in mtllibs:
            obj_materials.extend(
                parse_mtl(os.path.join(os.path.dirname(path), rel)))

    has_normals = norms_a.shape[0] > 0 and (fn_a >= 0).all()
    if not has_normals:
        norms_a = compute_smooth_normals(verts_a, faces_a)
        fn_a = faces_a.copy()

    has_uvs = uvs_a.shape[0] > 0 and (ft_a >= 0).all()
    if not has_uvs:
        uvs_a = np.zeros((1, 3), np.float32)
        ft_a = np.zeros_like(faces_a)

    # Reorder materials to match usemtl appearance order with parsed MTL data.
    ordered = []
    for name in mtl_names:
        match = next((m for m in obj_materials if m["name"] == name), None)
        ordered.append(match)
    ordered = [m for m in ordered if m is not None]

    return MeshDesc(
        name=os.path.basename(path),
        verts=verts_a,
        faces=faces_a,
        normals=norms_a,
        face_normals=fn_a,
        uvs=uvs_a,
        face_uvs=ft_a,
        face_mtl=fm_a,
        mtl_names=mtl_names,
        obj_materials=ordered,
    )
