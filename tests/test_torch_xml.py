"""The port's XML scene loader (scene/xml_loader.py) against the JAX
package's: the same files parse to equal SceneDescs, field by field (the
decoded texture images, meshes and transforms array-equal), and the two
packages' compile_scene give packs that are equal array by array. The
files are the port's data/textured.xml (its PNGs and the teapot through
resource_root, the banner mesh beside it) and a small scene written to
tmp_path: nested object transforms, a missing OBJ and a missing texture in
lenient mode, an OBJ with an MTL library (auto multi-material, illum
models, map_Kd and map_Ks on a PPM), a mesh instanced twice, a rotated
checker texture map and every light type. Everything is numpy on the
host, so the comparisons are exact.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from bhraytracer_tpu.scene.compile import compile_scene as j_compile
from bhraytracer_tpu.scene.xml_loader import parse_scene_xml as j_parse
from bhraytracer_tpu_torch.scene import load_scene, parse_scene_xml
from bhraytracer_tpu_torch.scene.compile import compile_scene
from bhraytracer_tpu_torch.scene.pack import _DATA, _META
from bhraytracer_tpu_torch.scenes import ASSETS, TEXTURED_XML

torch.set_num_threads(2)


def assert_same(a, b, where="scene"):
    """a (the port's) equals b (the JAX package's), recursing through
    dataclasses, lists and dicts; arrays equal in value and shape."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
        assert np.shape(a) == np.shape(b), where
    else:
        assert a == b, (where, a, b)


def assert_packs_equal(pack, jpack):
    for k in _DATA:
        a, b = getattr(pack, k).numpy(), np.asarray(getattr(jpack, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in _META:
        assert getattr(pack, k) == getattr(jpack, k), k


def test_textured_xml_matches_jax():
    sd = parse_scene_xml(TEXTURED_XML, resource_root=ASSETS, lenient=False)
    jsd = j_parse(TEXTURED_XML, resource_root=ASSETS, lenient=False)
    assert_same(sd, jsd)
    assert [t.kind for t in sd.textures] == ["file", "file", "checker"]
    assert len(sd.texmaps) == 5 and len(sd.meshes) == 2
    assert sd.background.texmap >= 0 and sd.environment.texmap >= 0
    assert sd.meshes[1].uvs.shape == (49 * 49, 3)
    pack, cam = load_scene(TEXTURED_XML, resource_root=ASSETS, lenient=False,
                           device="cpu")
    assert pack.device.type == "cpu"
    assert_packs_equal(pack, j_compile(jsd))
    assert pack.face_v.shape[0] == 1408 + 4608
    assert_same(cam, jsd.camera)


def _write_small_scene(d):
    """A small scene in tmp_path `d` exercising the loader's corners."""
    tex = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3) * 3
    (d / "tex.ppm").write_bytes(b"P6\n5 4\n255\n" + tex.tobytes())
    (d / "multi.mtl").write_text(
        "newmtl glassy\nKd 0.1 0.2 0.3\nKs 0.5 0.5 0.5\nNs 40\nNi 1.4\n"
        "Tf 0.2 0.3 0.4\nillum 7\nmap_Kd tex.ppm\n"
        "newmtl mirror\nKd 0.7 0.7 0.7\nKs 0.9 0.8 0.7\nNs 8\nillum 3\n"
        "map_Ks tex.ppm\n"
        "newmtl plain\nKd 0.3 0.6 0.9\nillum 2\n")
    (d / "multi.obj").write_text(
        "mtllib multi.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl glassy\nf 1/1 2/2 3/3 4/4\n"
        "usemtl plain\nf 1/1 2/2 6/3 5/4\n"
        "usemtl mirror\nf 2/1 3/2 6/3\n")
    (d / "scene.xml").write_text("""<xml>
  <scene>
    <background r="0.1" g="0.2" b="0.3"/>
    <environment value="0.5" texture="tex.ppm">
      <rotate x="0" y="0" z="1" angle="90"/>
    </environment>
    <object type="sphere" name="parent" material="m1">
      <scale x="2" y="1" z="1"/>
      <rotate x="0" y="0" z="1" angle="30"/>
      <translate x="1" y="0" z="0"/>
      <object type="plane" name="child" material="m2">
        <translate z="-1"/>
        <rotate x="1" y="0" z="0" angle="10"/>
        <object type="sphere" name="grandchild" material="m1">
          <scale value="0.5"/>
        </object>
      </object>
    </object>
    <object type="obj" name="missing.obj" material="m1"/>
    <object type="obj" name="multi.obj">
      <translate x="0" y="3" z="0"/>
    </object>
    <object type="obj" name="multi.obj" material="m2">
      <scale value="2"/>
      <rotate x="0" y="1" z="0" angle="45"/>
    </object>
    <object type="cone" name="unknown"/>
    <material type="blinn" name="m1">
      <diffuse r="0.5" g="0.5" b="0.5"/>
      <specular value="0.7" texture="checkerboard">
        <color1 r="1" g="0" b="0"/>
        <color2 value="0.5"/>
        <scale x="0.25" y="0.5" z="1"/>
        <rotate x="0" y="0" z="1" angle="45"/>
        <translate x="0.1" y="0.2" z="0"/>
      </specular>
      <glossiness value="25"/>
      <emission r="0.1" g="0" b="0"/>
      <reflection value="0.3" glossiness="0.1"/>
      <absorption r="0.1" g="0.2" b="0.3"/>
    </material>
    <material type="blinn" name="m2">
      <diffuse value="0.8" texture="missing.png"/>
      <refraction value="0.9" index="1.33" glossiness="0.05"/>
    </material>
    <material type="phong" name="unknown"/>
    <light type="ambient" name="amb"><intensity value="0.1"/></light>
    <light type="direct" name="sun">
      <intensity r="0.5" g="0.4" b="0.3"/>
      <direction x="1" y="1" z="-2"/>
    </light>
    <light type="point" name="bulb">
      <intensity value="20"/><position x="0" y="-2" z="5"/><size value="0.3"/>
    </light>
    <light type="area" name="unknown"/>
  </scene>
  <camera>
    <position x="0" y="-6" z="2"/><target x="0" y="0" z="0.5"/>
    <up x="0" y="0" z="1"/><fov value="35"/>
    <width value="40"/><height value="30"/>
  </camera>
</xml>
""")
    return str(d / "scene.xml")


def test_small_xml_matches_jax(tmp_path):
    path = _write_small_scene(tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sd = parse_scene_xml(path)
    with warnings.catch_warnings(record=True) as jcaught:
        warnings.simplefilter("always")
        jsd = j_parse(path)
    assert ([str(w.message) for w in caught]
            == [str(w.message) for w in jcaught])
    assert any("missing.obj" in str(w.message) for w in caught)
    assert any("missing.png" in str(w.message) for w in caught)
    assert_same(sd, jsd)
    # Three nodes from the nested objects, two mesh instances of one mesh.
    assert [n.kind for n in sd.nodes] == ["sphere", "plane", "sphere", "mesh",
                                          "mesh"]
    assert len(sd.meshes) == 1 and len(sd.textures) == 2
    # Auto multi-material: one material per MTL entry in usemtl order
    # (glassy, plain, mirror), named "<obj>#<i>", the illum models mapped
    # to reflection and refraction.
    names = [m.name for m in sd.materials]
    assert names == ["multi.obj#0", "multi.obj#1", "multi.obj#2", "m1", "m2"]
    glassy, plain, mirror = sd.materials[:3]
    assert (glassy.refraction.color > 0).all() and glassy.diffuse.texmap >= 0
    assert plain.diffuse.texmap == -1 and not plain.reflection.color.any()
    assert (mirror.reflection.color > 0).all()
    assert mirror.diffuse.texmap >= 0  # map_Ks, the reference's quirk
    assert sd.materials[4].diffuse.texmap == -1  # the missing texture
    pack = compile_scene(sd, device="cpu")
    assert_packs_equal(pack, j_compile(jsd))
    assert (pack.msh_mtl.numpy() == [-1, 4]).all()
    assert set(pack.face_mtl.numpy().tolist()) == {0, 1, 2}


def test_strict_mode_refuses_missing_files(tmp_path):
    path = _write_small_scene(tmp_path)
    for parse in (parse_scene_xml, j_parse):
        with pytest.raises(FileNotFoundError, match="missing"):
            parse(path, lenient=False)


def test_load_scene_defaults_to_the_card(tmp_path):
    """Without a device load_scene builds on the card; where there is none,
    the default raises instead of taking the CPU."""
    path = _write_small_scene(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if torch.cuda.is_available():
            assert load_scene(path)[0].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                load_scene(path)
        pack, cam = load_scene(path, device="cpu")
    assert pack.device.type == "cpu" and (cam.width, cam.height) == (40, 30)
    assert os.path.isabs(TEXTURED_XML)
