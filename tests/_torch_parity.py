"""Shared fixtures of the port's parity tests (tests/test_torch_*.py): the
JAX package's scenes and their port packs, made once per process."""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np


def pack_dict(jpack) -> dict:
    """The JAX pack as the dict `pack_from_numpy` takes."""
    return {f.name: (np.asarray(v) if not isinstance(v, (int, bool, tuple))
                     else v)
            for f in dataclasses.fields(jpack)
            for v in [getattr(jpack, f.name)]}


def params_from_numpy(d: dict, device="cpu") -> dict:
    """A JAX trainable_params dict, its arrays as numpy, as the port's
    (float32 tensors on `device`), so that both packages differentiate
    the same values."""
    import torch

    return {k: torch.from_numpy(np.array(v, np.float32, order="C")).to(device)
            for k, v in d.items()}


def teapot_desc(obj: str):
    """The JAX SceneDesc of the tiny scene plus assets/Resource/Data/<obj>
    at scale 0.25 moved by (0, 2.5, 0): bench._builtin_bench_scene's scene
    for teapot.obj, bench._bigmesh_leg's (bench.py:458-466) for
    teapot_hires.obj (111,616 faces)."""
    import os

    from bench import _tiny_scene_desc
    from bhraytracer_tpu.scene import desc as D
    from bhraytracer_tpu.scene.obj_loader import load_obj

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sd = _tiny_scene_desc()
    sd.meshes.append(load_obj(os.path.join(repo, "assets", "Resource", "Data",
                                           obj)))
    t = D.Transform()
    t.scale(0.25, 0.25, 0.25)
    t.translate(np.array([0.0, 2.5, 0.0]))
    sd.nodes.append(D.NodeDesc(kind="mesh", name="hires", transform=t,
                               material=0, mesh=len(sd.meshes) - 1))
    return sd


@functools.lru_cache(maxsize=None)
def jax_scene(name: str):
    """(pack, camera) of the JAX package: "tiny" is
    __graft_entry__._tiny_scene, "bench" is bench._builtin_bench_scene,
    "bigmesh" is bench._bigmesh_leg's scene (a pack with treelets),
    "textured" is the port's data/textured.xml through the JAX package's
    own XML loader."""
    if name == "textured":
        from bhraytracer_tpu.scene.xml_loader import load_scene
        from bhraytracer_tpu_torch.scenes import ASSETS, TEXTURED_XML

        return load_scene(TEXTURED_XML, resource_root=ASSETS, lenient=False)
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene()
    if name == "bigmesh":
        from bhraytracer_tpu.scene.compile import compile_scene

        sd = teapot_desc("teapot_hires.obj")
        return compile_scene(sd), sd.camera
    from bench import _builtin_bench_scene

    return _builtin_bench_scene()


@functools.lru_cache(maxsize=None)
def port_pack(name: str):
    """The port's pack carried across from the JAX pack, on the CPU."""
    from bhraytracer_tpu_torch.scene.pack import pack_from_numpy

    return pack_from_numpy(pack_dict(jax_scene(name)[0]), device="cpu")


@contextlib.contextmanager
def pallas_on():
    """Route the JAX package's traces and shading through its Pallas
    kernels in interpret mode (tests/test_stream.py:127-134)."""
    from bhraytracer_tpu.ops import trace as T

    T.set_pallas_mode("on")
    try:
        yield
    finally:
        T.set_pallas_mode("auto")


def seeded_rays(n: int, seed: int):
    """(o, d) float32 numpy rays aimed into the scenes' common box (the
    spheres, the teapot and the ground around them), from a seed."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([-3.5, -2.0, -0.5]), np.array([3.5, 3.5, 3.5])
    o = rng.uniform(lo - 3.0, hi + 3.0, (n, 3))
    o[:, 2] = np.abs(o[:, 2]) + 0.2  # above the ground plane
    target = rng.uniform(lo, hi, (n, 3))
    return o.astype(np.float32), (target - o).astype(np.float32)
