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

`textured_scene` loads `data/textured.xml` through the XML loader: the
bench scene's objects with a checkerboard ground, a wood-textured sphere, a
uv-mapped 4,608-face banner textured with china.png, and a textured
background and environment (the port's stand-in for the reference's
proj10, whose XML the repository does not hold).

`gradient_scene` and `gradient_mesh_scene` are the JAX package's two
finite-difference setups (tests/test_gradients.py:22-72: a sphere over a
ground plane; tests/test_gradients_mesh.py:42-109: a camera-facing
textured quad mesh over a checker plane), at 24x18; with
`textured=True` the sphere's diffuse colour is textured with the quad's
4x4 image, whose uv is the sphere's.

`crowd_scene` and `grid_scene` grow tiny_scene past limits that the first
slices of the port refused and the JAX package renders: more instances,
materials or lights than the fused shade kernel's tables hold, more than
the 32 spheres and planes a trace kernel stages (LIMIT_SCENES), and a mesh
above the grouped stream kernels' 197,632 faces (`grid_scene`; at n = 64,
the flat stream route's largest mesh, 8192 faces). Their desc functions
take the desc module and the base desc as arguments, so a test can build
the same scene with the JAX package's own SceneDesc.
"""

from __future__ import annotations

import os

import numpy as np

from bhraytracer_tpu_torch.scene import desc as D
from bhraytracer_tpu_torch.scene.compile import compile_scene
from bhraytracer_tpu_torch.scene.obj_loader import load_obj
from bhraytracer_tpu_torch.scene.xml_loader import load_scene

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")
_DATA = os.path.join(ASSETS, "Resource", "Data")
TEAPOT = os.path.join(_DATA, "teapot.obj")
TEAPOT_HIRES = os.path.join(_DATA, "teapot_hires.obj")
TEXTURED_XML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "textured.xml")


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


def textured_scene(device=None):
    """data/textured.xml through load_scene, its Resource/ paths under the
    repository's assets/ (6,016 faces: the flat stream route at levels >=
    1, the BVH kernels at level 0)."""
    return load_scene(TEXTURED_XML, resource_root=ASSETS, lenient=False,
                      device=device)


def _gradient_camera(desc):
    cam = desc.Camera()
    cam.pos = np.array([0.0, -8.0, 3.0])
    d = np.array([0.0, 8.0, -2.0])
    cam.dir = d / np.linalg.norm(d)
    x = np.cross(cam.dir, np.array([0.0, 0.0, 1.0]))
    up = np.cross(x, cam.dir)
    cam.up = up / np.linalg.norm(up)
    cam.width, cam.height = 24, 18
    return cam


def _gradient_ground(desc, sd, material: int):
    t = desc.Transform()
    t.scale(20.0, 20.0, 20.0)
    sd.nodes.append(desc.NodeDesc(kind="plane", name="g", transform=t,
                                  material=material))
    sd.lights.append(desc.LightDesc(kind="point", intensity=np.full(3, 40.0),
                                    position=np.array([4.0, -4.0, 8.0])))
    sd.background = desc.TexturedColorDesc(color=np.array([0.1, 0.1, 0.1]))
    sd.environment = desc.TexturedColorDesc(color=np.array([0.3, 0.3, 0.3]))


def _gradient_image():
    """The 4x4 file texture of the mesh setup: mid-gray with structure, so
    the bilinear weights vary."""
    return (np.arange(48).reshape(4, 4, 3) * 4 + 80).astype(np.uint8)


def gradient_scene_desc(desc=D, textured: bool = False):
    """tests/test_gradients.py's setup: a glossy red sphere over a white
    ground plane, one point light; the camera at 24x18 (sd.camera)."""
    sd = desc.SceneDesc()
    red = desc.MaterialDesc(name="red")
    red.diffuse = desc.TexturedColorDesc(color=np.array([0.7, 0.3, 0.2]))
    red.specular = desc.TexturedColorDesc(color=np.array([0.4, 0.4, 0.4]))
    red.glossiness = 20.0
    if textured:
        sd.textures.append(desc.TextureDesc(kind="file", name="img",
                                            image=_gradient_image()))
        sd.texmaps.append(desc.TextureMapDesc(texture=0))
        red.diffuse.texmap = 0
    white = desc.MaterialDesc(name="white")
    white.diffuse = desc.TexturedColorDesc(color=np.array([0.8, 0.8, 0.8]))
    white.specular = desc.TexturedColorDesc(color=np.zeros(3))
    sd.materials += [red, white]
    t = desc.Transform()
    t.scale(1.5, 1.5, 1.5)
    t.translate(np.array([0.0, 0.0, 1.5]))
    sd.nodes.append(desc.NodeDesc(kind="sphere", name="s", transform=t,
                                  material=0))
    _gradient_ground(desc, sd, 1)
    sd.camera = _gradient_camera(desc)
    return sd


def gradient_mesh_scene_desc(desc=D):
    """tests/test_gradients_mesh.py's setup: a camera-facing quad mesh
    (two faces, uv-mapped, textured with a 4x4 image) over a checker
    plane, one point light; the camera at 24x18 (sd.camera)."""
    sd = desc.SceneDesc()
    sd.textures.append(desc.TextureDesc(kind="file", name="img",
                                        image=_gradient_image()))
    sd.textures.append(desc.TextureDesc(
        kind="checker", name="chk",
        color1=np.array([0.2, 0.2, 0.2]), color2=np.array([0.8, 0.8, 0.8])))
    sd.texmaps.append(desc.TextureMapDesc(texture=0))
    sd.texmaps.append(desc.TextureMapDesc(texture=1))
    quad_m = desc.MaterialDesc(name="quad")
    quad_m.diffuse = desc.TexturedColorDesc(color=np.array([1.0, 1.0, 1.0]),
                                            texmap=0)
    quad_m.specular = desc.TexturedColorDesc(color=np.array([0.2, 0.2, 0.2]))
    quad_m.glossiness = 20.0
    floor_m = desc.MaterialDesc(name="floor")
    floor_m.diffuse = desc.TexturedColorDesc(color=np.array([1.0, 1.0, 1.0]),
                                             texmap=1)
    floor_m.specular = desc.TexturedColorDesc(color=np.zeros(3))
    sd.materials += [quad_m, floor_m]
    verts = np.array([[-1.0, 2.0, 0.5], [1.0, 2.0, 0.5],
                      [1.0, 2.0, 2.5], [-1.0, 2.0, 2.5]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    normals = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (4, 1))
    uvs = np.array([[0.1, 0.1, 0], [0.9, 0.1, 0],
                    [0.9, 0.9, 0], [0.1, 0.9, 0]], np.float32)
    sd.meshes.append(desc.MeshDesc(
        name="quad", verts=verts, faces=faces, normals=normals,
        face_normals=faces.copy(), uvs=uvs, face_uvs=faces.copy(),
        face_mtl=np.full(2, -1, np.int32)))
    sd.nodes.append(desc.NodeDesc(kind="mesh", name="quad",
                                  transform=desc.Transform(), material=0,
                                  mesh=0))
    _gradient_ground(desc, sd, 1)
    sd.camera = _gradient_camera(desc)
    return sd


def gradient_scene(device=None, textured: bool = False):
    sd = gradient_scene_desc(textured=textured)
    return compile_scene(sd, device=device), sd.camera


def gradient_mesh_scene(device=None):
    sd = gradient_mesh_scene_desc()
    return compile_scene(sd, device=device), sd.camera


# name -> (extra spheres, extra planes, extra materials, lights): tiny
# scene grown past a limit of the fused shade kernel (ops/shade.py:
# MAX_INST, MAX_MTL, MAX_LIGHTS) or of the trace kernels' shared tables
# (32 rows of each kind).
LIMIT_SCENES = {
    "spheres33": (31, 0, 0, 2),  # 34 instances
    "materials33": (0, 0, 30, 2),  # 33 materials
    "lights9": (0, 0, 0, 9),
    "lights0": (0, 0, 0, 0),
    "spheres40_planes40": (38, 39, 0, 2),
}


def crowd_scene_desc(name: str, desc=D, base=None):
    """tiny_scene_desc() (or `base`, a desc of module `desc`) grown as
    LIMIT_SCENES[name] says, from a seed: small spheres of the scene's three
    materials over the ground in view, small tilted planes above them,
    extra materials of their own colours (the nodes take the last of
    them), and point lights in a ring above (the tiny scene's two lights
    first; none for "lights0")."""
    n_sph, n_pln, n_mtl, n_lights = LIMIT_SCENES[name]
    sd = tiny_scene_desc() if base is None else base
    g = np.random.default_rng(7)
    for i in range(n_sph):
        t = desc.Transform()
        r = float(g.uniform(0.15, 0.35))
        t.scale(r, r, r)
        t.translate(np.array([g.uniform(-3.5, 3.5), g.uniform(-1.5, 3.5), r]))
        sd.nodes.append(desc.NodeDesc(kind="sphere", name=f"s{i + 3}",
                                      transform=t, material=i % 3))
    for i in range(n_pln):
        t = desc.Transform()
        t.scale(0.3, 0.3, 0.3)
        t.rotate(g.normal(size=3), float(g.uniform(0.0, 60.0)))
        t.translate(np.array([g.uniform(-3.5, 3.5), g.uniform(-1.5, 3.5),
                              g.uniform(0.8, 3.0)]))
        sd.nodes.append(desc.NodeDesc(kind="plane", name=f"p{i + 1}",
                                      transform=t, material=(i + 1) % 3))
    for i in range(n_mtl):
        m = desc.MaterialDesc(name=f"m{i}")
        m.diffuse = desc.TexturedColorDesc(color=g.uniform(0.1, 0.9, 3))
        m.specular = desc.TexturedColorDesc(color=g.uniform(0.0, 0.5, 3))
        m.glossiness = float(g.uniform(5.0, 80.0))
        sd.materials.append(m)
    if n_mtl:
        last = len(sd.materials) - 1
        for k, node in enumerate(sd.nodes):
            if node.kind != "mesh" and k != 1:  # the glass sphere stays
                node.material = last - k
    sd.lights = sd.lights[:min(n_lights, 2)]
    for i in range(n_lights - len(sd.lights)):
        a = 2.0 * np.pi * i / 7.0
        sd.lights.append(desc.LightDesc(
            kind="point", intensity=np.full(3, 6.0 + i),
            position=np.array([4.0 * np.cos(a), 4.0 * np.sin(a) - 1.0, 6.0]),
            size=0.3))
    return sd


def crowd_scene(name: str, device=None):
    sd = crowd_scene_desc(name)
    return compile_scene(sd, device=device), sd.camera


GRID = 320  # cells a side of grid_scene's height field: 204,800 triangles


def grid_mesh_desc(n: int = GRID, desc=D):
    """A wavy height field over [-1, 1]^2 in n x n cells of two triangles
    each, facing +z, with vertex normals."""
    u = np.linspace(-1.0, 1.0, n + 1)
    x, y = np.meshgrid(u, u, indexing="ij")
    z = 0.08 * np.sin(5.0 * x) * np.cos(4.0 * y)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = np.stack([-0.4 * np.cos(5.0 * x) * np.cos(4.0 * y),
                    0.32 * np.sin(5.0 * x) * np.sin(4.0 * y),
                    np.ones_like(x)], -1).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (i * (n + 1) + j).ravel()
    v10, v01, v11 = v00 + n + 1, v00 + 1, v00 + n + 2
    faces = np.concatenate([np.stack([v00, v10, v11], 1),
                            np.stack([v00, v11, v01], 1)]).astype(np.int32)
    f = faces.shape[0]
    return desc.MeshDesc(name="grid", verts=verts, faces=faces, normals=nrm,
                         face_normals=faces.copy(),
                         uvs=np.zeros((1, 3), np.float32),
                         face_uvs=np.zeros((f, 3), np.int32),
                         face_mtl=np.full(f, -1, np.int32))


def grid_scene_desc(n: int = GRID, desc=D, base=None):
    """tiny_scene_desc() (or `base`) with grid_mesh_desc(n), scaled to 3 x 3
    and lifted to z = 0.5 between the spheres, in the red material."""
    sd = tiny_scene_desc() if base is None else base
    sd.meshes.append(grid_mesh_desc(n, desc))
    t = desc.Transform()
    t.scale(1.5, 1.5, 1.5)
    t.translate(np.array([0.0, 1.0, 0.5]))
    sd.nodes.append(desc.NodeDesc(kind="mesh", name="grid", transform=t,
                                  material=0, mesh=len(sd.meshes) - 1))
    return sd


def grid_scene(n: int = GRID, device=None):
    sd = grid_scene_desc(n)
    return compile_scene(sd, device=device), sd.camera
