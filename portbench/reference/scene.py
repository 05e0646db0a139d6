"""The reference renderer's scene: read from a configuration file of
`portbench/configs/` and the OBJ file it names, with nothing of the
program under test.

Node transforms are scale-then-translate (a node's local point x lands at
S x + t); spheres are unit spheres and planes the unit square z = 0,
|x|, |y| <= 1, in their node's frame. Lights are sorted ascending by their
gray intensity (the reference renderer's light order), each picked with
probability gray / sum(gray). Mesh faces are fan-triangulated; a mesh
without vertex normals takes area-weighted smooth normals.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

LIGHT_KIND = {"ambient": 0, "direct": 1, "point": 2}


def read_obj(path: str):
    """(verts (V,3) float32, faces (F,3) int64, vertex normals (V,3) float32
    or None, face normal indices (F,3) or None) of an OBJ file: `v`, `vn`
    and `f` records, polygons fanned from their first corner, negative
    indices counted from the end."""
    verts, norms, faces, fnorms = [], [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                vi, ni = [], []
                for c in tok[1:]:
                    parts = c.split("/")
                    i = int(parts[0])
                    vi.append(i - 1 if i > 0 else len(verts) + i)
                    if len(parts) > 2 and parts[2]:
                        j = int(parts[2])
                        ni.append(j - 1 if j > 0 else len(norms) + j)
                for k in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    if len(ni) == len(vi):
                        fnorms.append([ni[0], ni[k], ni[k + 1]])
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    fc = np.asarray(faces, np.int64).reshape(-1, 3)
    if norms and len(fnorms) == len(faces):
        return v, fc, np.asarray(norms, np.float32), np.asarray(fnorms, np.int64)
    return v, fc, None, None


def smooth_normals(v: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals: the sum of the unnormalised normals of
    the faces around each vertex, normalised."""
    v = v.astype(np.float64)
    fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]], v[faces[:, 2]] - v[faces[:, 0]])
    acc = np.zeros_like(v)
    for k in range(3):
        np.add.at(acc, faces[:, k], fn)
    n = np.linalg.norm(acc, axis=1, keepdims=True)
    return (acc / np.where(n > 0, n, 1.0)).astype(np.float32)


@dataclasses.dataclass
class Scene:
    """Tensors of one scene on one device, in `dtype`."""

    sph: torch.Tensor  # (S, 12) [inverse linear map (9), translation (3)]
    sph_mtl: torch.Tensor  # (S,) int64
    pln: torch.Tensor  # (P, 12)
    pln_mtl: torch.Tensor
    verts: torch.Tensor  # (V, 3) every mesh's vertices in its node's frame
    faces: torch.Tensor  # (F, 3) int64 rows of verts
    face_lin: torch.Tensor  # (F, 3, 3) the face's node's linear map
    face_pos: torch.Tensor  # (F, 3) and translation
    tri_n: torch.Tensor  # (F, 3, 3) world unit vertex normals
    tri_mtl: torch.Tensor  # (F,) int64
    diffuse: torch.Tensor  # (M, 3)
    specular: torch.Tensor
    gloss: torch.Tensor  # (M,)
    refraction: torch.Tensor
    ior: torch.Tensor
    absorption: torch.Tensor
    light_kind: torch.Tensor  # (L,) int64
    light_intensity: torch.Tensor  # (L, 3)
    light_vec: torch.Tensor  # position (point) or direction (direct)
    light_size: torch.Tensor
    light_prob: torch.Tensor  # (L,)
    background: torch.Tensor  # (3,)
    environment: torch.Tensor
    cam_pos: torch.Tensor
    cam_dir: torch.Tensor
    cam_up: torch.Tensor
    fov: float
    focaldist: float

    def tri(self) -> torch.Tensor:
        """(F, 3, 3) world vertices of the faces, from `verts`."""
        v = self.verts[self.faces]  # (F, 3 corners, 3)
        return (self.face_lin[:, None, :, :] * v[:, :, None, :]).sum(-1) + self.face_pos[:, None, :]

    @property
    def dtype(self):
        return self.diffuse.dtype

    @property
    def device(self):
        return self.diffuse.device


def _linear(obj) -> np.ndarray:
    return np.diag(np.asarray(obj.get("scale", [1.0, 1.0, 1.0]), np.float64))


def build_scene(cfg: dict, root: str, device, dtype=torch.float32) -> Scene:
    """The Scene of configuration `cfg` (a configs/*.json object); OBJ
    paths are relative to `root`."""
    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    sph, sph_m, pln, pln_m = [], [], [], []
    verts, faces, f_lin, f_pos, tri_n, tri_m = [], [], [], [], [], []
    n_verts = 0
    for obj in cfg["objects"]:
        lin = _linear(obj)
        pos = np.asarray(obj.get("translate", [0.0, 0.0, 0.0]), np.float64)
        inv = np.linalg.inv(lin)
        row = np.concatenate([inv.reshape(-1), pos]).astype(np.float32)
        if obj["kind"] == "sphere":
            sph.append(row)
            sph_m.append(obj["material"])
        elif obj["kind"] == "plane":
            pln.append(row)
            pln_m.append(obj["material"])
        elif obj["kind"] == "mesh":
            v, fc, vn, fnorm = read_obj(os.path.join(root, obj["obj"]))
            if vn is None:
                vn, fnorm = smooth_normals(v, fc), fc
            # Normals map by the inverse transpose of the linear part.
            nw = vn.astype(np.float64) @ inv
            nw = nw / np.maximum(np.linalg.norm(nw, axis=1, keepdims=True), 1e-30)
            verts.append(v)
            faces.append(faces_ := fc + n_verts)
            n_verts += len(v)
            f_lin.append(np.broadcast_to(lin.astype(np.float32), (len(faces_), 3, 3)))
            f_pos.append(np.broadcast_to(pos.astype(np.float32), (len(faces_), 3)))
            tri_n.append(nw.astype(np.float32)[fnorm])
            tri_m.append(np.full(len(faces_), obj["material"], np.int64))
        else:
            raise ValueError(f"unknown object kind {obj['kind']!r}")

    mats = cfg["materials"]
    lights = sorted(cfg["lights"], key=lambda li: float(np.sum(li["intensity"]) / 3.0))
    gray = np.array([np.float32(np.sum(np.asarray(li["intensity"], np.float32)) / 3.0)
                     for li in lights], np.float32)
    prob = gray / max(float(gray.sum()), 1e-30)
    cam = cfg["camera"]
    empty12 = np.zeros((0, 12), np.float32)
    return Scene(
        sph=t(np.array(sph, np.float32) if sph else empty12),
        sph_mtl=t(sph_m, torch.int64),
        pln=t(np.array(pln, np.float32) if pln else empty12),
        pln_mtl=t(pln_m, torch.int64),
        verts=t(np.concatenate(verts) if verts else np.zeros((0, 3), np.float32)),
        faces=t(np.concatenate(faces) if faces else np.zeros((0, 3), np.int64), torch.int64),
        face_lin=t(np.concatenate(f_lin) if f_lin else np.zeros((0, 3, 3), np.float32)),
        face_pos=t(np.concatenate(f_pos) if f_pos else np.zeros((0, 3), np.float32)),
        tri_n=t(np.concatenate(tri_n) if tri_n else np.zeros((0, 3, 3), np.float32)),
        tri_mtl=t(np.concatenate(tri_m) if tri_m else np.zeros(0, np.int64), torch.int64),
        diffuse=t([m["diffuse"] for m in mats]),
        specular=t([m["specular"] for m in mats]),
        gloss=t([m["glossiness"] for m in mats]),
        refraction=t([m["refraction"] for m in mats]),
        ior=t([m["ior"] for m in mats]),
        absorption=t([m["absorption"] for m in mats]),
        light_kind=t([LIGHT_KIND[li["kind"]] for li in lights], torch.int64),
        light_intensity=t([li["intensity"] for li in lights]),
        light_vec=t([li["direction"] if li["kind"] == "direct" else li["position"]
                     for li in lights]),
        light_size=t([li.get("size", 0.0) for li in lights]),
        light_prob=t(prob),
        background=t(cfg["background"]),
        environment=t(cfg["environment"]),
        cam_pos=t(cam["pos"]),
        cam_dir=t(cam["dir"]),
        cam_up=t(cam["up"]),
        fov=float(cam["fov"]),
        focaldist=float(cam.get("focaldist", 1.0)),
    )
