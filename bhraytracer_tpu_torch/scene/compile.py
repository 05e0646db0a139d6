"""Scene compiler: SceneDesc -> ScenePack (flat tensors).

The numpy half of bhraytracer_tpu/scene/compile.py, array for array (the
parity tests hold every shared field equal), minus the TPU packet kernel's
row tables and treelets. The arrays then go through `pack_from_numpy`, the
same door the JAX package's pack takes into the port.

Folds node transform stacks to world space (replacing per-ray
ToNodeCoords/FromNodeCoords chains, scene.h:490-501), builds per-mesh BVHs
and concatenates them, resolves per-face material ids, packs textures into a
padded atlas, and sorts lights ascending by gray intensity exactly as
CalculateLightsIntensity does (Main.cpp:116-123).
"""

from __future__ import annotations

from typing import List

import numpy as np

from bhraytracer_tpu_torch.accel.bvh import build_bvh
from bhraytracer_tpu_torch.scene import desc as D
from bhraytracer_tpu_torch.scene.pack import (
    ScenePack,
    pack_from_numpy,
    resolve_device,
)

_LIGHT_KIND = {"ambient": 0, "direct": 1, "point": 2}


def compile_scene(sd: D.SceneDesc, leaf_size: int = 4,
                  device=None) -> ScenePack:
    """The pack of `sd` on `device`: the card unless the caller asks for
    the CPU (`device="cpu"`); without a card the default raises."""
    device = resolve_device(device)
    f32, i32 = np.float32, np.int32

    # ---------- materials ----------
    mats: List[D.MaterialDesc] = list(sd.materials)
    if not mats:
        mats = [D.MaterialDesc(name="__default__")]

    def tc_color(tc: D.TexturedColorDesc) -> np.ndarray:
        return np.asarray(tc.color, f32)

    m = len(mats)
    mtl = dict(
        mtl_diffuse=np.stack([tc_color(x.diffuse) for x in mats]),
        mtl_specular=np.stack([tc_color(x.specular) for x in mats]),
        mtl_gloss=np.array([x.glossiness for x in mats], f32),
        mtl_emission=np.stack([tc_color(x.emission) for x in mats]),
        mtl_reflection=np.stack([tc_color(x.reflection) for x in mats]),
        mtl_refl_gloss=np.array([x.reflection_glossiness for x in mats], f32),
        mtl_refraction=np.stack([tc_color(x.refraction) for x in mats]),
        mtl_refr_gloss=np.array([x.refraction_glossiness for x in mats], f32),
        mtl_ior=np.array([x.ior for x in mats], f32),
        mtl_absorption=np.stack([np.asarray(x.absorption, f32) for x in mats]),
        mtl_diffuse_tm=np.array([x.diffuse.texmap for x in mats], i32),
        mtl_specular_tm=np.array([x.specular.texmap for x in mats], i32),
        mtl_emission_tm=np.array([x.emission.texmap for x in mats], i32),
        mtl_reflection_tm=np.array([x.reflection.texmap for x in mats], i32),
        mtl_refraction_tm=np.array([x.refraction.texmap for x in mats], i32),
    )

    def mtl_index(name: str) -> int:
        for i, x in enumerate(mats):
            if x.name == name:
                return i
        return -1

    # ---------- instances ----------
    sph, pln, msh = [], [], []
    for node in sd.nodes:
        rec = (
            node.transform.itm.astype(f32),
            node.transform.tm.astype(f32),
            node.transform.pos.astype(f32),
            max(node.material, 0),
            node.mesh,
            node.name,
        )
        if node.kind == "sphere":
            sph.append(rec)
        elif node.kind == "plane":
            pln.append(rec)
        elif node.kind == "mesh":
            msh.append((*rec[:4], node.mesh, node.name, node.material))

    def pack_analytic(recs):
        # Pad empty categories with one inert identity instance so gathers in
        # resolve_hit stay in-bounds; trace skips them via the static n_* count.
        if recs:
            return (
                np.stack([r[0] for r in recs]),
                np.stack([r[1] for r in recs]),
                np.stack([r[2] for r in recs]),
                np.array([r[3] for r in recs], i32),
            )
        return (
            np.eye(3, dtype=f32)[None],
            np.eye(3, dtype=f32)[None],
            np.zeros((1, 3), f32),
            np.zeros((1,), i32),
        )

    sph_itm, sph_tm, sph_pos, sph_mtl = pack_analytic(sph)
    pln_itm, pln_tm, pln_pos, pln_mtl = pack_analytic(pln)

    # ---------- meshes: shared vertex pools + one world-space BVH ----------
    # Vertex/normal/uv pools are concatenated once per DISTINCT mesh; face
    # tables are emitted once per INSTANCE with the instance's world-space
    # triangles feeding a single unified BVH (see pack.py field docs).
    verts_l, normals_l, uvs_l = [], [], []
    mesh_offsets = {}  # mesh idx -> (v_off, n_off, t_off)
    v_off = n_off = t_off = 0
    for mesh_idx, mesh in enumerate(sd.meshes):
        mesh_offsets[mesh_idx] = (v_off, n_off, t_off)
        verts_l.append(mesh.verts)
        normals_l.append(mesh.normals)
        uvs_l.append(mesh.uvs)
        v_off += mesh.verts.shape[0]
        n_off += mesh.normals.shape[0]
        t_off += mesh.uvs.shape[0]

    fv_l, fvn_l, fvt_l, fmtl_l, finst_l = [], [], [], [], []
    w0_l, w1_l, w2_l = [], [], []
    for inst_i, r in enumerate(msh):
        _itm, tm, pos, _, mesh_idx, name, _node_mtl = r
        mesh = sd.meshes[mesh_idx]
        vo, no, to = mesh_offsets[mesh_idx]
        fv_l.append(mesh.faces + vo)
        fvn_l.append(mesh.face_normals + no)
        fvt_l.append(mesh.face_uvs + to)
        finst_l.append(np.full(mesh.faces.shape[0], inst_i, i32))
        # Per-face global material ids for this instance: auto multi-material
        # names are "<node name>#<slot>" with the OBJ path as node name
        # (xmlload.cpp:243).
        slots = mesh.face_mtl
        out = np.zeros(slots.shape[0], i32)
        for slot in np.unique(slots):
            gid = mtl_index(f"{name}#{slot}") if slot >= 0 else -1
            out[slots == slot] = max(gid, 0)
        fmtl_l.append(out)
        # World-space triangles (transform folded: p_w = tm p + pos).
        wv = mesh.verts @ tm.T + pos
        tri = wv[mesh.faces]  # (F,3,3)
        if np.linalg.det(tm) < 0:
            # Mirror transforms flip winding; swap two vertices so the
            # world-space front/back classification matches the reference's
            # local-space test (IntersectTriangle side semantics).
            tri = tri[:, [0, 2, 1], :]
        w0_l.append(tri[:, 0])
        w1_l.append(tri[:, 1])
        w2_l.append(tri[:, 2])

    def cat(lst, empty_shape, dtype):
        if lst:
            return np.concatenate(lst).astype(dtype)
        return np.zeros(empty_shape, dtype)

    verts = cat(verts_l, (1, 3), f32)
    normals = cat(normals_l, (1, 3), f32)
    uvs = cat(uvs_l, (1, 3), f32)
    face_v = cat(fv_l, (1, 3), i32)
    face_vn = cat(fvn_l, (1, 3), i32)
    face_vt = cat(fvt_l, (1, 3), i32)
    face_mtl = cat(fmtl_l, (1,), i32)
    face_inst = cat(finst_l, (1,), i32)
    wtri_v0 = cat(w0_l, (1, 3), f32)
    wtri_v1 = cat(w1_l, (1, 3), f32)
    wtri_v2 = cat(w2_l, (1, 3), f32)

    if msh:
        # One BVH over the world-space triangle soup of every instance.
        nf_all = face_v.shape[0]
        soup_verts = np.concatenate(
            [wtri_v0, wtri_v1, wtri_v2], axis=1).reshape(-1, 3)
        soup_faces = np.arange(3 * nf_all, dtype=i32).reshape(-1, 3)
        bvh = build_bvh(soup_verts, soup_faces, leaf_size=leaf_size)
        bvh_depth = bvh.depth
        order = bvh.face_order
        face_v = face_v[order]
        face_vn = face_vn[order]
        face_vt = face_vt[order]
        face_mtl = face_mtl[order]
        face_inst = face_inst[order]
        wtri_v0 = wtri_v0[order]
        wtri_v1 = wtri_v1[order]
        wtri_v2 = wtri_v2[order]
        bvh_bmin = bvh.bmin.astype(f32)
        bvh_bmax = bvh.bmax.astype(f32)
        bvh_left = bvh.left.astype(i32)
        bvh_count = bvh.count.astype(i32)
    else:
        bvh_depth = 1
        bvh_bmin = np.zeros((1, 3), f32)
        bvh_bmax = np.zeros((1, 3), f32)
        bvh_left = np.zeros((1,), i32)
        bvh_count = np.ones((1,), i32)  # degenerate leaf w/ 1 dummy face

    nf_all = face_v.shape[0]

    # Per-face resolve rows: every LOCAL-frame quantity resolve_hit's mesh
    # branch needs, packed so one (F,32) row gather replaces its 9 dependent
    # gathers (face_v -> verts x3, face_vn -> normals x3, face_vt -> uvs x3).
    # Values are bit-identical copies of those pool lookups; the non-
    # differentiable render path reads rows, the AD path keeps the pool
    # gathers so vertex/normal gradients reach pack.verts/pack.normals.
    resolve_rows = np.zeros((nf_all, 32), f32)
    if msh:
        vt3 = verts[face_v]  # (F,3,3)
        nt3 = normals[face_vn]
        ut3 = uvs[face_vt]
        resolve_rows[:, 0:9] = vt3.reshape(nf_all, 9)
        resolve_rows[:, 9:18] = nt3.reshape(nf_all, 9)
        resolve_rows[:, 18:27] = ut3.reshape(nf_all, 9)
        resolve_rows[:, 27] = face_mtl.astype(f32)

    if msh:
        msh_itm = np.stack([r[0] for r in msh])
        msh_tm = np.stack([r[1] for r in msh])
        msh_pos = np.stack([r[2] for r in msh])
        # -1 instance material = use per-face table.
        msh_mtl = np.array([r[6] for r in msh], i32)
    else:
        msh_itm = np.eye(3, dtype=f32)[None]
        msh_tm = np.eye(3, dtype=f32)[None]
        msh_pos = np.zeros((1, 3), f32)
        msh_mtl = np.zeros((1,), i32)

    # ---------- texture maps + atlas ----------
    texmaps = sd.texmaps or []
    ntm = max(1, len(texmaps))
    tm_tex = np.zeros(ntm, i32)
    tm_itm = np.tile(np.eye(3, dtype=f32), (ntm, 1, 1))
    tm_pos = np.zeros((ntm, 3), f32)
    for i, t in enumerate(texmaps):
        tm_tex[i] = t.texture
        tm_itm[i] = t.transform.itm.astype(f32)
        tm_pos[i] = t.transform.pos.astype(f32)

    textures = sd.textures or []
    nt = max(1, len(textures))
    tex_kind = np.zeros(nt, i32)
    tex_c1 = np.zeros((nt, 3), f32)
    tex_c2 = np.ones((nt, 3), f32)
    tex_wh = np.ones((nt, 2), i32)
    hmax = wmax = 1
    has_file_tex = any(t.kind == "file" for t in textures)
    for t in textures:
        if t.kind == "file" and t.image is not None:
            hmax = max(hmax, t.image.shape[0])
            wmax = max(wmax, t.image.shape[1])
    atlas = np.zeros((nt, hmax, wmax, 3), np.uint8)
    for i, t in enumerate(textures):
        if t.kind == "checker":
            tex_kind[i] = 1
            tex_c1[i] = t.color1
            tex_c2[i] = t.color2
        elif t.image is not None:
            h, w = t.image.shape[:2]
            tex_wh[i] = (w, h)
            atlas[i, :h, :w] = t.image

    # ---------- lights (sorted ascending by gray; Main.cpp:117) ----------
    lights = sorted(sd.lights, key=lambda li: li.gray)
    nl = max(1, len(lights))
    light_kind = np.zeros(nl, i32)
    light_intensity = np.zeros((nl, 3), f32)
    light_vec = np.zeros((nl, 3), f32)
    light_size = np.zeros(nl, f32)
    for i, li in enumerate(lights):
        light_kind[i] = _LIGHT_KIND[li.kind]
        light_intensity[i] = li.intensity
        light_vec[i] = li.direction if li.kind == "direct" else li.position
        light_size[i] = li.size

    arrays = dict(
        sph_itm=sph_itm, sph_tm=sph_tm, sph_pos=sph_pos, sph_mtl=sph_mtl,
        pln_itm=pln_itm, pln_tm=pln_tm, pln_pos=pln_pos, pln_mtl=pln_mtl,
        msh_itm=msh_itm, msh_tm=msh_tm, msh_pos=msh_pos, msh_mtl=msh_mtl,
        verts=verts, normals=normals, uvs=uvs,
        face_v=face_v, face_vn=face_vn, face_vt=face_vt, face_mtl=face_mtl,
        face_inst=face_inst,
        bvh_bmin=bvh_bmin, bvh_bmax=bvh_bmax, bvh_left=bvh_left,
        bvh_count=bvh_count,
        wtri_v0=wtri_v0, wtri_v1=wtri_v1, wtri_v2=wtri_v2,
        resolve_rows=resolve_rows,
        **mtl,
        tm_tex=tm_tex, tm_itm=tm_itm, tm_pos=tm_pos,
        tex_kind=tex_kind, tex_c1=tex_c1, tex_c2=tex_c2, tex_wh=tex_wh,
        atlas=atlas,
        bg_color=np.asarray(sd.background.color, f32),
        bg_tm=np.array(sd.background.texmap, i32),
        env_color=np.asarray(sd.environment.color, f32),
        env_tm=np.array(sd.environment.texmap, i32),
        light_kind=light_kind, light_intensity=light_intensity,
        light_vec=light_vec, light_size=light_size,
        bvh_depth=bvh_depth,
        n_sph=len(sph), n_pln=len(pln), n_msh=len(msh),
        n_lights=len(lights), has_file_tex=has_file_tex,
        n_texmaps=len(texmaps),
    )
    return pack_from_numpy(arrays, device=device)
