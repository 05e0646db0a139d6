"""XML scene compiler front-end: the port's copy of
bhraytracer_tpu/scene/xml_loader.py.

Loads the reference's TinyXML2 scene dialect (BHRayTracer/xmlload.cpp) with
Python's stdlib ElementTree into a `SceneDesc`, then `compile_scene` flattens
it into the pack's tensors, on the card unless the caller asks for the
CPU. Element/attribute semantics track xmlload.cpp:
  - <object type=sphere|plane|obj name=... material=...> with nested objects
    and <scale|rotate|translate> children applied in document order
    (LoadNode :172-271, LoadTransform :275-303)
  - <material type=blinn> channels incl. per-channel textures
    (LoadMaterial :307-390)
  - <light type=ambient|direct|point> (LoadLight :394-474)
  - <background>/<environment> textured colors (:144-157)
  - <camera> with orthonormalization (:109-127)
  - ReadVector/ReadColor/ReadFloat default+`value`-multiplier rules (:478-521)
"""

from __future__ import annotations

import os
import warnings
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np

from bhraytracer_tpu_torch.scene import desc as D
from bhraytracer_tpu_torch.scene.obj_loader import load_obj
from bhraytracer_tpu_torch.utils.png import read_png
from bhraytracer_tpu_torch.utils.ppm import read_ppm


def _read_float(elem: ET.Element, default: float, name: str = "value") -> float:
    v = elem.get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        # TinyXML2's QueryDoubleAttribute leaves the default on malformed
        # values (some bundled scenes contain empty attributes).
        return default


def _read_vector(elem: ET.Element, default: np.ndarray) -> np.ndarray:
    v = np.array(
        [
            _read_float(elem, default[0], "x"),
            _read_float(elem, default[1], "y"),
            _read_float(elem, default[2], "z"),
        ]
    )
    return v * _read_float(elem, 1.0)


def _read_color(elem: ET.Element, default: np.ndarray) -> np.ndarray:
    c = np.array(
        [
            _read_float(elem, default[0], "r"),
            _read_float(elem, default[1], "g"),
            _read_float(elem, default[2], "b"),
        ]
    )
    return c * _read_float(elem, 1.0)


def _tag(e: ET.Element) -> str:
    return e.tag.lower()


class _Loader:
    def __init__(self, scene_path: str, resource_root: Optional[str], lenient: bool):
        self.scene = D.SceneDesc()
        self.scene_dir = os.path.dirname(os.path.abspath(scene_path))
        self.resource_root = resource_root
        self.lenient = lenient
        self.pending_mtl: list = []  # (node_index, material name) deferred binds
        self.mesh_by_name: Dict[str, int] = {}
        self.texture_by_name: Dict[str, int] = {}

    # -- path resolution -------------------------------------------------
    def resolve_path(self, name: str) -> Optional[str]:
        name = name.replace("\\", "/")
        candidates = [name]
        if self.resource_root:
            candidates.append(os.path.join(self.resource_root, name))
            candidates.append(os.path.join(self.resource_root, os.path.basename(name)))
        candidates.append(os.path.join(self.scene_dir, name))
        candidates.append(os.path.join(self.scene_dir, os.path.basename(name)))
        for c in candidates:
            if os.path.exists(c):
                return c
        return None

    # -- transforms ------------------------------------------------------
    def load_transform(self, trans: D.Transform, elem: ET.Element) -> None:
        for child in elem:
            t = _tag(child)
            if t == "scale":
                s = _read_vector(child, np.ones(3))
                trans.scale(s[0], s[1], s[2])
            elif t == "rotate":
                axis = _read_vector(child, np.zeros(3))
                n = np.linalg.norm(axis)
                axis = axis / n if n > 0 else axis
                trans.rotate(axis, _read_float(child, 0.0, "angle"))
            elif t == "translate":
                trans.translate(_read_vector(child, np.zeros(3)))

    # -- textures ----------------------------------------------------------
    def load_file_texture(self, name: str) -> int:
        """Dedup'd file texture (xmlload.cpp:562-582)."""
        if name in self.texture_by_name:
            return self.texture_by_name[name]
        path = self.resolve_path(name)
        img = None
        if path is None:
            msg = f"texture file not found: {name}"
            if not self.lenient:
                raise FileNotFoundError(msg)
            warnings.warn(msg)
        else:
            ext = os.path.splitext(path)[1].lower()
            img = read_ppm(path) if ext == ".ppm" else read_png(path)
        if img is None:
            return -1
        idx = len(self.scene.textures)
        self.scene.textures.append(D.TextureDesc(kind="file", name=name, image=img))
        self.texture_by_name[name] = idx
        return idx

    def read_texture(self, elem: ET.Element) -> int:
        """Returns a texmap index or -1 (ReadTexture, xmlload.cpp:525-558)."""
        tex_name = elem.get("texture")
        if tex_name is None:
            return -1
        if tex_name.lower() == "checkerboard":
            c1, c2 = np.zeros(3), np.ones(3)
            for child in elem:
                if _tag(child) == "color1":
                    c1 = _read_color(child, np.zeros(3))
                elif _tag(child) == "color2":
                    c2 = _read_color(child, np.zeros(3))
            tex_idx = len(self.scene.textures)
            self.scene.textures.append(
                D.TextureDesc(kind="checker", name="checkerboard", color1=c1, color2=c2)
            )
        else:
            tex_idx = self.load_file_texture(tex_name)
            if tex_idx < 0:
                return -1
        tmap = D.TextureMapDesc(texture=tex_idx)
        self.load_transform(tmap.transform, elem)
        self.scene.texmaps.append(tmap)
        return len(self.scene.texmaps) - 1

    def textured_color(self, elem: ET.Element, default: np.ndarray) -> D.TexturedColorDesc:
        return D.TexturedColorDesc(
            color=_read_color(elem, default), texmap=self.read_texture(elem)
        )

    # -- nodes -------------------------------------------------------------
    def load_node(self, elem: ET.Element, parent_tf: D.Transform) -> None:
        local = D.Transform()
        self.load_transform(local, elem)
        world = local.compose_with_parent(parent_tf)

        name = elem.get("name") or ""
        mtl_name = elem.get("material")
        typ = (elem.get("type") or "").lower()

        node = None
        if typ == "sphere":
            node = D.NodeDesc(kind="sphere", name=name, transform=world)
        elif typ == "plane":
            node = D.NodeDesc(kind="plane", name=name, transform=world)
        elif typ == "obj":
            mesh_idx = self.mesh_by_name.get(name, -1)
            if mesh_idx < 0:
                path = self.resolve_path(name)
                if path is None:
                    msg = f"OBJ file not found: {name}"
                    if not self.lenient:
                        raise FileNotFoundError(msg)
                    warnings.warn(msg)
                else:
                    mesh = load_obj(path, load_mtl=(mtl_name is None))
                    mesh_idx = len(self.scene.meshes)
                    self.scene.meshes.append(mesh)
                    self.mesh_by_name[name] = mesh_idx
                    if mesh.obj_materials and mtl_name is None:
                        self._auto_multi_material(name, mesh)
                        mtl_name = name
            if mesh_idx >= 0:
                node = D.NodeDesc(kind="mesh", name=name, transform=world, mesh=mesh_idx)
        elif typ:
            warnings.warn(f"unknown object type: {typ}")

        if node is not None:
            self.scene.nodes.append(node)
            if mtl_name:
                self.pending_mtl.append((len(self.scene.nodes) - 1, mtl_name))

        for child in elem:
            if _tag(child) == "object":
                self.load_node(child, world)

    def _auto_multi_material(self, name: str, mesh: D.MeshDesc) -> None:
        """Auto-generate Blinn materials from OBJ MTL data, including the
        illum-model -> reflection/refraction mapping (xmlload.cpp:219-250).

        The sub-materials are appended to the global material table under
        names "<obj>#<i>"; the mesh's per-face sub-material slots are later
        remapped to these global ids by the scene compiler.
        """
        for i, m in enumerate(mesh.obj_materials):
            mat = D.MaterialDesc(name=f"{name}#{i}")
            mat.diffuse = D.TexturedColorDesc(color=np.asarray(m["Kd"], float))
            mat.specular = D.TexturedColorDesc(color=np.asarray(m["Ks"], float))
            mat.glossiness = float(m["Ns"])
            mat.ior = float(m["Ni"])
            if m["map_Kd"]:
                tex = self.load_file_texture(m["map_Kd"])
                if tex >= 0:
                    self.scene.texmaps.append(D.TextureMapDesc(texture=tex))
                    mat.diffuse.texmap = len(self.scene.texmaps) - 1
            # Quirk kept from xmlload.cpp:230: map_Ks is (mis)assigned to the
            # diffuse texture slot in the reference as well.
            if m["map_Ks"]:
                tex = self.load_file_texture(m["map_Ks"])
                if tex >= 0:
                    self.scene.texmaps.append(D.TextureMapDesc(texture=tex))
                    mat.diffuse.texmap = len(self.scene.texmaps) - 1
            if 2 < m["illum"] <= 7:
                mat.reflection = D.TexturedColorDesc(color=np.asarray(m["Ks"], float))
                gloss = float(np.arccos(min(1.0, 2 ** (1.0 / m["Ns"]))) if m["Ns"] else 0.0)
                mat.reflection_glossiness = gloss
                if m["illum"] >= 6:
                    mat.refraction = D.TexturedColorDesc(
                        color=1.0 - np.asarray(m["Tf"], float)
                    )
                    mat.refraction_glossiness = gloss
            self.scene.materials.append(mat)

    # -- materials -----------------------------------------------------------
    def load_material(self, elem: ET.Element) -> None:
        if (elem.get("type") or "").lower() != "blinn":
            warnings.warn(f"unknown material type: {elem.get('type')}")
            return
        m = D.MaterialDesc(name=elem.get("name") or "")
        for child in elem:
            t = _tag(child)
            one = np.ones(3)
            if t == "diffuse":
                m.diffuse = self.textured_color(child, one)
            elif t == "specular":
                m.specular = self.textured_color(child, one)
            elif t == "glossiness":
                m.glossiness = _read_float(child, 1.0)
            elif t == "emission":
                m.emission = self.textured_color(child, one)
            elif t == "reflection":
                m.reflection = self.textured_color(child, one)
                m.reflection_glossiness = _read_float(child, 0.0, "glossiness")
            elif t == "refraction":
                m.refraction = self.textured_color(child, one)
                m.ior = _read_float(child, 1.0, "index")
                m.refraction_glossiness = _read_float(child, 0.0, "glossiness")
            elif t == "absorption":
                m.absorption = _read_color(child, one)
        self.scene.materials.append(m)

    # -- lights ---------------------------------------------------------------
    def load_light(self, elem: ET.Element) -> None:
        typ = (elem.get("type") or "").lower()
        if typ not in ("ambient", "direct", "point"):
            warnings.warn(f"unknown light type: {typ}")
            return
        li = D.LightDesc(kind=typ, name=elem.get("name") or "")
        for child in elem:
            t = _tag(child)
            if t == "intensity":
                li.intensity = _read_color(child, np.ones(3))
            elif t == "direction":
                v = _read_vector(child, np.ones(3))
                n = np.linalg.norm(v)
                li.direction = v / n if n > 0 else v
            elif t == "position":
                li.position = _read_vector(child, np.zeros(3))
            elif t == "size":
                li.size = _read_float(child, 0.0)
        self.scene.lights.append(li)

    # -- top level ------------------------------------------------------------
    def load(self, root: ET.Element) -> D.SceneDesc:
        scene_elem = root.find("scene")
        cam_elem = root.find("camera")
        if scene_elem is None:
            raise ValueError("no <scene> tag found")

        identity = D.Transform()
        for child in scene_elem:
            t = _tag(child)
            if t == "background":
                self.scene.background = self.textured_color(child, np.ones(3))
            elif t == "environment":
                self.scene.environment = self.textured_color(child, np.ones(3))
            elif t == "object":
                self.load_node(child, identity)
            elif t == "material":
                self.load_material(child)
            elif t == "light":
                self.load_light(child)

        # Deferred material binding by name (xmlload.cpp:102-107).
        for node_idx, mtl_name in self.pending_mtl:
            self.scene.nodes[node_idx].material = self.scene.material_index(mtl_name)

        # Camera (xmlload.cpp:109-127).
        cam = D.Camera()
        if cam_elem is not None:
            target = cam.pos + cam.dir
            for child in cam_elem:
                t = _tag(child)
                if t == "position":
                    cam.pos = _read_vector(child, cam.pos)
                elif t == "target":
                    target = _read_vector(child, target)
                elif t == "up":
                    cam.up = _read_vector(child, cam.up)
                elif t == "fov":
                    cam.fov = _read_float(child, cam.fov)
                elif t == "focaldist":
                    cam.focaldist = _read_float(child, cam.focaldist)
                elif t == "dof":
                    cam.dof = _read_float(child, cam.dof)
                elif t == "width":
                    cam.width = int(_read_float(child, cam.width))
                elif t == "height":
                    cam.height = int(_read_float(child, cam.height))
            d = target - cam.pos
            cam.dir = d / np.linalg.norm(d)
            x = np.cross(cam.dir, cam.up)
            up = np.cross(x, cam.dir)
            cam.up = up / np.linalg.norm(up)
        self.scene.camera = cam
        return self.scene


def parse_scene_xml(
    path: str, resource_root: Optional[str] = None, lenient: bool = True
) -> D.SceneDesc:
    """Parse a scene XML file into a host-side SceneDesc."""
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag.lower() != "xml":
        raise ValueError('root element must be "xml"')
    return _Loader(path, resource_root, lenient).load(root)


def load_scene(
    path: str, resource_root: Optional[str] = None, lenient: bool = True,
    device=None,
) -> Tuple["object", D.Camera]:
    """Parse + compile a scene: returns (ScenePack, Camera), the pack on
    `device`: the card unless the caller asks for the CPU
    (`device="cpu"`); without a card the default raises, as
    `compile_scene`'s does."""
    from bhraytracer_tpu_torch.scene.compile import compile_scene

    sd = parse_scene_xml(path, resource_root=resource_root, lenient=lenient)
    return compile_scene(sd, device=device), sd.camera
