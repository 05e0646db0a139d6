"""The port's scenes, built from SceneDesc values equal to the JAX
package's: `tiny_scene` is `__graft_entry__._tiny_scene` (two spheres, one
of them glass with ior 1.52, a ground plane, a point light of size 0.5 and
a direct light), `bench_scene` is `bench._builtin_bench_scene` (the same
plus assets/Resource/Data/teapot.obj, 1,408 faces, at scale 0.25
translated by (0, 2.5, 0)) and `bigmesh_scene` is the scene of
`bench._bigmesh_leg` (the same with teapot_hires.obj, 111,616 faces, in
the teapot's place). Each returns (pack, camera), the pack on the card
unless `device` says otherwise; the camera is 64x48 until the caller sets
its width and height.
"""

from __future__ import annotations

import os

import numpy as np

from bhraytracer_tpu_torch.scene import desc as D
from bhraytracer_tpu_torch.scene.compile import compile_scene
from bhraytracer_tpu_torch.scene.obj_loader import load_obj

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "Resource", "Data")
TEAPOT = os.path.join(_DATA, "teapot.obj")
TEAPOT_HIRES = os.path.join(_DATA, "teapot_hires.obj")


def tiny_scene_desc() -> D.SceneDesc:
    sd = D.SceneDesc()
    red = D.MaterialDesc(name="red")
    red.diffuse = D.TexturedColorDesc(color=np.array([0.8, 0.2, 0.2]))
    red.specular = D.TexturedColorDesc(color=np.array([0.5, 0.5, 0.5]))
    red.glossiness = 20.0
    glass = D.MaterialDesc(name="glass")
    glass.diffuse = D.TexturedColorDesc(color=np.zeros(3))
    glass.specular = D.TexturedColorDesc(color=np.array([0.1, 0.1, 0.1]))
    glass.glossiness = 100.0
    glass.refraction = D.TexturedColorDesc(color=np.array([0.9, 0.9, 0.9]))
    glass.ior = 1.52
    white = D.MaterialDesc(name="white")
    white.diffuse = D.TexturedColorDesc(color=np.array([0.9, 0.9, 0.9]))
    white.specular = D.TexturedColorDesc(color=np.zeros(3))
    sd.materials += [red, glass, white]

    t1 = D.Transform()
    t1.scale(1.5, 1.5, 1.5)
    t1.translate(np.array([-1.5, 0.0, 1.5]))
    sd.nodes.append(D.NodeDesc(kind="sphere", name="s1", transform=t1, material=0))
    t2 = D.Transform()
    t2.translate(np.array([1.5, 0.0, 1.0]))
    sd.nodes.append(D.NodeDesc(kind="sphere", name="s2", transform=t2, material=1))
    t3 = D.Transform()
    t3.scale(20.0, 20.0, 20.0)
    sd.nodes.append(D.NodeDesc(kind="plane", name="ground", transform=t3, material=2))

    sd.lights.append(D.LightDesc(kind="point", intensity=np.full(3, 50.0),
                                 position=np.array([4.0, -4.0, 8.0]), size=0.5))
    sd.lights.append(D.LightDesc(
        kind="direct", intensity=np.full(3, 0.3),
        direction=np.array([1.0, 0.5, -1.0]) / np.linalg.norm([1.0, 0.5, -1.0])))
    sd.background = D.TexturedColorDesc(color=np.array([0.1, 0.2, 0.3]))
    sd.environment = D.TexturedColorDesc(color=np.array([0.2, 0.2, 0.2]))

    cam = D.Camera()
    cam.pos = np.array([0.0, -8.0, 3.0])
    d = np.array([0.0, 8.0, -2.0])
    cam.dir = d / np.linalg.norm(d)
    x = np.cross(cam.dir, np.array([0.0, 0.0, 1.0]))
    up = np.cross(x, cam.dir)
    cam.up = up / np.linalg.norm(up)
    cam.fov = 40.0
    cam.width, cam.height = 64, 48
    sd.camera = cam
    return sd


def _with_teapot(path: str, name: str) -> D.SceneDesc:
    sd = tiny_scene_desc()
    sd.meshes.append(load_obj(path))
    t = D.Transform()
    t.scale(0.25, 0.25, 0.25)
    t.translate(np.array([0.0, 2.5, 0.0]))
    sd.nodes.append(D.NodeDesc(kind="mesh", name=name, transform=t,
                               material=0, mesh=len(sd.meshes) - 1))
    return sd


def bench_scene_desc() -> D.SceneDesc:
    return _with_teapot(TEAPOT, "teapot")


def bigmesh_scene_desc() -> D.SceneDesc:
    """bench._bigmesh_leg's scene (bench.py:458-466)."""
    return _with_teapot(TEAPOT_HIRES, "hires")


def tiny_scene(device=None):
    sd = tiny_scene_desc()
    return compile_scene(sd, device=device), sd.camera


def bench_scene(device=None):
    sd = bench_scene_desc()
    return compile_scene(sd, device=device), sd.camera


def bigmesh_scene(device=None):
    sd = bigmesh_scene_desc()
    return compile_scene(sd, device=device), sd.camera
