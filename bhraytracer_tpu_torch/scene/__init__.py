from bhraytracer_tpu_torch.scene.desc import (
    Camera,
    LightDesc,
    MaterialDesc,
    MeshDesc,
    NodeDesc,
    SceneDesc,
    TexturedColorDesc,
    Transform,
)
from bhraytracer_tpu_torch.scene.pack import ScenePack, pack_from_numpy
from bhraytracer_tpu_torch.scene.compile import compile_scene

__all__ = [
    "Camera",
    "LightDesc",
    "MaterialDesc",
    "MeshDesc",
    "NodeDesc",
    "SceneDesc",
    "TexturedColorDesc",
    "Transform",
    "ScenePack",
    "pack_from_numpy",
    "compile_scene",
]
