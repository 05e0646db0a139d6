"""Host-side scene description (the output of the XML loader).

This is the staging form between the reference's XML dialect
(BHRayTracer/xmlload.cpp) and the flat device-array `ScenePack`. Unlike the
reference — which parses straight into global registries of virtual objects
(xmlload.cpp:22-30) — we keep an explicit, inspectable description that the
scene compiler then flattens.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def rotation_matrix(axis: np.ndarray, degrees: float) -> np.ndarray:
    """Rotation about an arbitrary axis (cyMatrix.h SetRotation equivalent)."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0:
        return np.eye(3)
    x, y, z = axis / n
    a = np.deg2rad(degrees)
    c, s = np.cos(a), np.sin(a)
    t = 1 - c
    return np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ]
    )


@dataclasses.dataclass
class Transform:
    """3x3 linear + translation, mirroring `Transformation` (scene.h:208-246).

    `tm`/`pos` map local -> parent; `itm` is the cached inverse of `tm`.
    """

    tm: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    def transform(self, m: np.ndarray) -> None:
        # Matches Transformation::Transform (scene.h:232): tm = m*tm, pos = m*pos.
        self.tm = m @ self.tm
        self.pos = m @ self.pos

    def scale(self, sx: float, sy: float, sz: float) -> None:
        self.transform(np.diag([sx, sy, sz]).astype(np.float64))

    def rotate(self, axis: np.ndarray, degrees: float) -> None:
        self.transform(rotation_matrix(axis, degrees))

    def translate(self, t: np.ndarray) -> None:
        self.pos = self.pos + np.asarray(t, np.float64)

    @property
    def itm(self) -> np.ndarray:
        return np.linalg.inv(self.tm)

    def compose_with_parent(self, parent: "Transform") -> "Transform":
        """Fold this (local->parent) under `parent` (parent->world)."""
        out = Transform()
        out.tm = parent.tm @ self.tm
        out.pos = parent.tm @ self.pos + parent.pos
        return out


@dataclasses.dataclass
class TextureDesc:
    """A texture source: an image file or the procedural checkerboard."""

    kind: str  # "file" | "checker"
    name: str
    image: Optional[np.ndarray] = None  # (H, W, 3) uint8 for files
    color1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    color2: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))


@dataclasses.dataclass
class TextureMapDesc:
    """Texture + uvw transform (`TextureMap`, scene.h:364-386)."""

    texture: int  # index into SceneDesc.textures
    transform: Transform = dataclasses.field(default_factory=Transform)


@dataclasses.dataclass
class TexturedColorDesc:
    """Color x optional texture map (`TexturedColor`, scene.h:394-422)."""

    color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    texmap: int = -1  # index into SceneDesc.texmaps, -1 = none


@dataclasses.dataclass
class MaterialDesc:
    """Blinn material parameter block (`MtlBlinn`, materials.h:20-61).

    `emission`, `reflection` and the reflection glossiness are parsed and
    stored but ignored by the path-traced shade, exactly as in the reference
    (they only feed the OpenGL preview there).
    """

    name: str = ""
    diffuse: TexturedColorDesc = dataclasses.field(
        default_factory=lambda: TexturedColorDesc(np.array([0.5, 0.5, 0.5]))
    )
    specular: TexturedColorDesc = dataclasses.field(
        default_factory=lambda: TexturedColorDesc(np.array([0.7, 0.7, 0.7]))
    )
    glossiness: float = 20.0
    emission: TexturedColorDesc = dataclasses.field(default_factory=TexturedColorDesc)
    reflection: TexturedColorDesc = dataclasses.field(default_factory=TexturedColorDesc)
    refraction: TexturedColorDesc = dataclasses.field(default_factory=TexturedColorDesc)
    absorption: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    ior: float = 1.0
    reflection_glossiness: float = 0.0
    refraction_glossiness: float = 0.0


@dataclasses.dataclass
class LightDesc:
    """Ambient / direct / point light (lights.h:29-87)."""

    kind: str  # "ambient" | "direct" | "point"
    name: str = ""
    intensity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    direction: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    size: float = 0.0

    @property
    def gray(self) -> float:
        return float(np.sum(self.intensity) / 3.0)


@dataclasses.dataclass
class MeshDesc:
    """Triangle mesh geometry in SoA form (cyTriMesh equivalent)."""

    name: str
    verts: np.ndarray  # (V, 3) f32
    faces: np.ndarray  # (F, 3) i32 vertex indices
    normals: np.ndarray  # (VN, 3) f32
    face_normals: np.ndarray  # (F, 3) i32 into normals
    uvs: np.ndarray  # (VT, 3) f32 (or (0,3))
    face_uvs: np.ndarray  # (F, 3) i32 into uvs (or zeros when uvs empty)
    face_mtl: np.ndarray  # (F,) i32 sub-material slot per face (-1 = none)
    mtl_names: List[str] = dataclasses.field(default_factory=list)
    obj_materials: list = dataclasses.field(default_factory=list)  # raw MTL dicts


@dataclasses.dataclass
class NodeDesc:
    """One scene-graph node instance with its world-folded transform.

    The reference intersects through the node hierarchy per ray
    (Main.cpp:389-413, scene.h:490-501); we fold each node's transform stack
    to world space once at compile time. (The reference's traversal has a
    transform-propagation bug for nodes at depth >= 3 — hits are returned in
    an ancestor's frame — which we deliberately do NOT reproduce; no bundled
    scene exercises it.)
    """

    kind: str  # "sphere" | "plane" | "mesh" | "group"
    name: str = ""
    transform: Transform = dataclasses.field(default_factory=Transform)  # local->world
    material: int = -1  # index into SceneDesc.materials
    mesh: int = -1  # index into SceneDesc.meshes for kind == "mesh"


@dataclasses.dataclass
class Camera:
    """Camera parameters (scene.h:506-524), orthonormalized as in
    xmlload.cpp:109-127."""

    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    dir: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, -1.0]))
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov: float = 40.0
    focaldist: float = 1.0
    dof: float = 0.0
    width: int = 200
    height: int = 150


@dataclasses.dataclass
class SceneDesc:
    nodes: List[NodeDesc] = dataclasses.field(default_factory=list)
    materials: List[MaterialDesc] = dataclasses.field(default_factory=list)
    lights: List[LightDesc] = dataclasses.field(default_factory=list)
    meshes: List[MeshDesc] = dataclasses.field(default_factory=list)
    textures: List[TextureDesc] = dataclasses.field(default_factory=list)
    texmaps: List[TextureMapDesc] = dataclasses.field(default_factory=list)
    background: TexturedColorDesc = dataclasses.field(default_factory=TexturedColorDesc)
    environment: TexturedColorDesc = dataclasses.field(default_factory=TexturedColorDesc)
    camera: Camera = dataclasses.field(default_factory=Camera)

    def material_index(self, name: str) -> int:
        for i, m in enumerate(self.materials):
            if m.name == name:
                return i
        return -1
