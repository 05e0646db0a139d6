from bhraytracer_tpu_torch.scene.desc import (
    Camera,
    LightDesc,
    MaterialDesc,
    MeshDesc,
    NodeDesc,
    SceneDesc,
    TexturedColorDesc,
    TextureDesc,
    TextureMapDesc,
    Transform,
)
from bhraytracer_tpu_torch.scene.pack import ScenePack, pack_from_numpy
from bhraytracer_tpu_torch.scene.compile import compile_scene
from bhraytracer_tpu_torch.scene.xml_loader import load_scene, parse_scene_xml

__all__ = [
    "Camera",
    "LightDesc",
    "MaterialDesc",
    "MeshDesc",
    "NodeDesc",
    "SceneDesc",
    "TexturedColorDesc",
    "TextureDesc",
    "TextureMapDesc",
    "Transform",
    "ScenePack",
    "pack_from_numpy",
    "compile_scene",
    "load_scene",
    "parse_scene_xml",
]
