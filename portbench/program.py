"""What the benchmark takes from the program under test
(`bhraytracer_tpu_torch`): its scene description and compiler, its render
configuration, `render_image`, and the inverse-rendering step's parts.
Everything here is imported lazily, inside the functions, so that the
reference and the harness's own arithmetic load without the program.
"""

from __future__ import annotations

import os

import numpy as np


def scene_desc(cfg: dict, root: str):
    """The program's SceneDesc of a configuration (configs/*.json): its
    materials, nodes (scale, then translate), the OBJ meshes it names
    (relative to `root`), lights, background, environment and camera."""
    from bhraytracer_tpu_torch.scene import desc as D
    from bhraytracer_tpu_torch.scene.obj_loader import load_obj

    sd = D.SceneDesc()
    for m in cfg["materials"]:
        md = D.MaterialDesc(name=m["name"])
        md.diffuse = D.TexturedColorDesc(color=np.array(m["diffuse"], np.float64))
        md.specular = D.TexturedColorDesc(color=np.array(m["specular"], np.float64))
        md.glossiness = float(m["glossiness"])
        md.refraction = D.TexturedColorDesc(color=np.array(m["refraction"], np.float64))
        md.ior = float(m["ior"])
        md.absorption = np.array(m["absorption"], np.float64)
        sd.materials.append(md)
    for obj in cfg["objects"]:
        t = D.Transform()
        t.scale(*obj.get("scale", [1.0, 1.0, 1.0]))
        t.translate(np.array(obj.get("translate", [0.0, 0.0, 0.0]), np.float64))
        kw = dict(kind=obj["kind"], name=obj["name"], transform=t,
                  material=obj["material"])
        if obj["kind"] == "mesh":
            sd.meshes.append(load_obj(os.path.join(root, obj["obj"])))
            kw["mesh"] = len(sd.meshes) - 1
        sd.nodes.append(D.NodeDesc(**kw))
    for li in cfg["lights"]:
        kw = dict(kind=li["kind"], intensity=np.array(li["intensity"], np.float64))
        if li["kind"] == "point":
            kw.update(position=np.array(li["position"], np.float64),
                      size=float(li.get("size", 0.0)))
        else:
            kw.update(direction=np.array(li["direction"], np.float64))
        sd.lights.append(D.LightDesc(**kw))
    sd.background = D.TexturedColorDesc(color=np.array(cfg["background"], np.float64))
    sd.environment = D.TexturedColorDesc(color=np.array(cfg["environment"], np.float64))
    cam = D.Camera()
    c = cfg["camera"]
    cam.pos = np.array(c["pos"], np.float64)
    cam.dir = np.array(c["dir"], np.float64)
    cam.up = np.array(c["up"], np.float64)
    cam.fov = float(c["fov"])
    cam.focaldist = float(c.get("focaldist", 1.0))
    sd.camera = cam
    return sd


def compile_scene(cfg: dict, root: str, device):
    """(pack, camera) of a configuration on `device`."""
    from bhraytracer_tpu_torch.scene.compile import compile_scene as compile_

    sd = scene_desc(cfg, root)
    return compile_(sd, device=str(device)), sd.camera


def render_config(cfg: dict, **over):
    """The program's RenderConfig: the configuration's depths, then
    `over` (the traffic's fields)."""
    from bhraytracer_tpu_torch.config import RenderConfig

    return RenderConfig(**dict(cfg["render"], **over))


def load_kernels(device) -> float:
    """Seconds to build (a checkout's first run) or load the program's
    CUDA kernel library; 0 off the card, where the kernels' twins run."""
    import time

    if getattr(device, "type", str(device)) != "cuda":
        return 0.0
    from bhraytracer_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.lib()
    return time.perf_counter() - t0
