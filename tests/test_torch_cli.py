"""The port's command line (bhraytracer_tpu_torch/cli.py, `python -m
bhraytracer_tpu_torch`) with --cpu: `render` writes the PNG that
render_image gives, --progressive 2 the single pass's, --zbuffer and
--probe the render's z-buffer, --checkpoint resumes to the same bytes,
--save-photons the bytes of the JAX package's write_dat; `photonviz` and
`info` print and write what the JAX package's do; the live view serves its
page, image and status; and without a card and without --cpu the command
fails rather than render on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bhraytracer_tpu.cli import main as j_main
from bhraytracer_tpu.io.photon_dat import write_dat as j_write_dat
from bhraytracer_tpu_torch.cli import main
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.io.photon_dat import read_dat, write_dat
from bhraytracer_tpu_torch.models.pathtracer import (
    image_to_u8,
    render_image,
    zbuffer_to_u8,
)
from bhraytracer_tpu_torch.models.photonmap import build_photon_map
from bhraytracer_tpu_torch.scene.xml_loader import load_scene
from bhraytracer_tpu_torch.scenes import ASSETS, TEXTURED_XML
from bhraytracer_tpu_torch.utils.checkpoint import (
    load_render_state,
    save_render_state,
)
from bhraytracer_tpu_torch.utils.liveview import LiveView
from bhraytracer_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The textured scene at 32x24, one sample, one GI bounce, one filter tap.
ARGS = ["--cpu", "--resource-root", ASSETS, "--width", "32", "--height",
        "24", "--spp", "1", "--gi-bounces", "1", "--extra-refr-levels", "0",
        "--tir-bounces", "4", "--texture-taps", "1"]
CFG = dict(spp=1, gi_bounces=1, extra_refr_levels=0, tir_bounces=4,
           texture_sample_count=1, chunk_rays=16384, photon_count=1 << 17)
# tests/test_render.py's scene with a glass ball: caustics to deposit.
GLASS_SCENE = textwrap.dedent("""
    <xml>
      <scene>
        <background r="0.1" g="0.2" b="0.3"/>
        <object type="sphere" name="ball" material="glass">
          <scale value="1.5"/>
          <translate x="0" y="0" z="1.5"/>
        </object>
        <object type="plane" name="ground" material="white">
          <scale value="20"/>
        </object>
        <light type="point" name="sun">
          <intensity value="60"/>
          <position x="4" y="-4" z="8"/>
        </light>
        <material type="blinn" name="glass">
          <diffuse value="0"/><specular value="0.1"/>
          <glossiness value="100"/><refraction value="0.9" index="1.52"/>
        </material>
        <material type="blinn" name="white">
          <diffuse value="0.9"/><specular value="0"/>
        </material>
      </scene>
      <camera>
        <position x="0" y="-8" z="3"/>
        <target x="0" y="0" z="1"/>
        <up x="0" y="0" z="1"/>
        <fov value="40"/>
        <width value="8"/>
        <height value="6"/>
      </camera>
    </xml>
    """)


def _textured_render(**kw):
    pack, cam = load_scene(TEXTURED_XML, resource_root=ASSETS, device="cpu")
    cam.width, cam.height = 32, 24
    return render_image(pack, cam, RenderConfig(**dict(CFG, **kw)), seed=0,
                        return_aux=True)


@pytest.fixture(scope="module")
def textured():
    """(image, aux) of the render the command line's ARGS ask for."""
    img, aux = _textured_render()
    return img.numpy(), aux


def test_render_writes_render_image(tmp_path, textured, capsys):
    out, zb = str(tmp_path / "out.png"), str(tmp_path / "z.png")
    assert main(["render", TEXTURED_XML, "-o", out, "--zbuffer", zb,
                 "--probe", "5", "7"] + ARGS) == 0
    img, aux = textured
    np.testing.assert_array_equal(read_png(out), image_to_u8(img))
    zimg = read_png(zb)  # grey, read back as RGB
    for c in range(3):
        np.testing.assert_array_equal(zimg[..., c],
                                      zbuffer_to_u8(aux["zbuffer"]))
    assert 0 < (aux["zbuffer"] < 1e30).mean() < 1
    c, z = img[7, 5], aux["zbuffer"][7, 5]
    text = capsys.readouterr().out
    assert (f"pixel (5, 7): color ({c[0]:.6f}, {c[1]:.6f}, {c[2]:.6f}) "
            f"z {z:.6f}") in text
    assert "rendered 32x24 @ 1spp" in text and "segments/s" in text


def test_progressive_matches_single_pass(tmp_path):
    prog, single = str(tmp_path / "p.png"), str(tmp_path / "s.png")
    args = [a if a != "1" else "2" for a in ARGS]  # --spp 2 (and gi 2)
    assert main(["render", TEXTURED_XML, "-o", prog, "--progressive", "2"]
                + args) == 0
    assert main(["render", TEXTURED_XML, "-o", single] + args) == 0
    # u8 after averaging the passes in float: off by one at most
    # (tests/test_progressive.py).
    diff = np.abs(read_png(prog).astype(int) - read_png(single).astype(int))
    assert diff.max() <= 1
    assert main(["render", TEXTURED_XML, "-o", prog, "--progressive", "2",
                 "--checkpoint", str(tmp_path / "ck")] + args) == 2


def test_checkpoint_resumes_to_the_same_bytes(tmp_path):
    out, ck = str(tmp_path / "out.png"), str(tmp_path / "ck")
    args = ["render", TEXTURED_XML, "-o", out, "--checkpoint", ck,
            "--chunk-rays", "512"] + ARGS
    assert main(args) == 0
    with open(out, "rb") as f:
        first = f.read()
    # Corrupt the second chunk, mark it unfinished, and resume.
    cfg = RenderConfig(**dict(CFG, chunk_rays=512))
    accum, zbuf, done = load_render_state(ck, cfg, 32, 24, 0)
    assert done.tolist() == [True, True]
    done[1] = False
    accum = accum.copy()
    accum[512:] = 5.0
    save_render_state(ck, accum, zbuf, done, cfg, 32, 24, 0)
    os.remove(out)
    assert main(args) == 0
    with open(out, "rb") as f:
        assert f.read() == first
    # A finished checkpoint: nothing re-rendered, the same bytes again.
    assert main(args) == 0
    with open(out, "rb") as f:
        assert f.read() == first
    # What a finished chunk shows is the checkpoint's, not a new render's.
    accum, zbuf, done = load_render_state(ck, cfg, 32, 24, 0)
    accum = accum.copy()
    accum[:512] = 0.25
    save_render_state(ck, accum, zbuf, done, cfg, 32, 24, 0)
    assert main(args) == 0
    img = read_png(out).reshape(-1, 3)
    assert (img[:512] == image_to_u8(np.float32(0.25) ** (1 / 2.2))).all()
    with open(out, "wb") as f:
        f.write(first)
    assert (img[512:] == read_png(out).reshape(-1, 3)[512:]).all()


def test_save_photons_matches_jax_write_dat(tmp_path):
    scene = tmp_path / "glass.xml"
    scene.write_text(GLASS_SCENE)
    dat, out = str(tmp_path / "map.dat"), str(tmp_path / "out.png")
    assert main(["render", str(scene), "-o", out, "--cpu", "--spp", "1",
                 "--gi-bounces", "0", "--extra-refr-levels", "0",
                 "--tir-bounces", "4", "--texture-taps", "1", "--photon-map",
                 "--photon-count", "64", "--save-photons", dat]) == 0
    pack, _ = load_scene(str(scene), device="cpu")
    pmap = build_photon_map(pack, RenderConfig(photon_count=64,
                                               tir_bounces=4), seed=0)
    ref = str(tmp_path / "ref.dat")
    j_write_dat(ref, *(x.numpy() for x in (pmap.pos, pmap.dirn,
                                           pmap.power)))
    with open(dat, "rb") as a, open(ref, "rb") as b:
        got = a.read()
        assert got == b.read()
    assert len(got) == 24 * pmap.pos.shape[0] and pmap.pos.shape[0] > 0
    pos, _, _ = read_dat(dat)
    np.testing.assert_array_equal(pos, pmap.pos.numpy())


@pytest.mark.parametrize("axis", ["z", "x"])
def test_photonviz_matches_jax(tmp_path, capsys, axis):
    g = np.random.default_rng(2)
    n = 500
    dirn = g.normal(size=(n, 3))
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    dat = str(tmp_path / "map.dat")
    write_dat(dat, g.normal(size=(n, 3)), dirn, g.uniform(0, 1, (n, 3)))
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert main(["photonviz", dat, "-o", a, "--axis", axis, "--size",
                 "64"]) == 0
    text = capsys.readouterr().out
    assert j_main(["photonviz", dat, "-o", b, "--axis", axis, "--size",
                   "64"]) == 0
    assert text.replace(a, b) == capsys.readouterr().out
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert read_png(a).max() > 0


def test_info_matches_jax(capsys):
    """`python -m bhraytracer_tpu_torch info` (the package's __main__, in a
    child process) prints what the JAX package's `info` prints."""
    got = subprocess.run(
        [sys.executable, "-m", "bhraytracer_tpu_torch", "info", TEXTURED_XML,
         "--resource-root", ASSETS], cwd=REPO, check=True,
        capture_output=True, text=True, timeout=300).stdout
    assert j_main(["info", TEXTURED_XML, "--resource-root", ASSETS]) == 0
    assert got == capsys.readouterr().out
    info = json.loads(got)
    assert len(info["meshes"]) == 2 and info["camera"]["width"] > 0


def test_render_without_card_fails(tmp_path, monkeypatch, capsys):
    """No --cpu and no CUDA device: a message and a non-zero exit, no
    render on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out.png")
    assert main(["render", TEXTURED_XML, "-o", out, "--resource-root",
                 ASSETS]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(out)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get_allow_404(port, path):
    try:
        return _get(port, path)
    except urllib.error.HTTPError as e:
        return e.code, None, e.read()


def test_liveview_serves_page_image_and_status(tmp_path):
    """tests/test_liveview.py, on the port's copy of the live view, with an
    aux view registered as --progressive --serve registers them."""
    png, zpng = tmp_path / "render.png", tmp_path / "render.z.png"
    view = LiveView(str(png), spp_total=8)
    port = view.serve(0)  # ephemeral port
    try:
        code, ctype, body = _get(port, "/")
        assert code == 200 and ctype == "text/html" and b"image.png" in body
        assert _get_allow_404(port, "/image.png")[0] == 404
        write_png(str(png), np.zeros((4, 4, 3), np.uint8))
        code, ctype, body = _get(port, "/image.png")
        assert code == 200 and ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        view.register_aux("zbuffer", str(zpng))
        write_png(str(zpng), np.zeros((4, 4), np.uint8))
        assert _get(port, "/view/zbuffer.png")[0] == 200
        assert _get_allow_404(port, "/view/nope.png")[0] == 404
        view.note_pass(3, 3)
        st = json.loads(_get(port, "/status")[2])
        assert st["passes_done"] == 3 and st["spp_done"] == 3
        assert st["spp_total"] == 8 and not st["finished"]
        assert st["views"] == ["zbuffer"]
        view.finish()
        assert json.loads(_get(port, "/status")[2])["finished"]
    finally:
        view.shutdown()


def test_render_cli_defaults():
    """The default chunk is a whole 800x600 frame on the card, 16,384
    lanes on the CPU; the flags are the JAX command line's."""
    import argparse

    from bhraytracer_tpu import cli as J
    from bhraytracer_tpu_torch import cli as C

    def flags(mod):
        p = argparse.ArgumentParser()
        mod._add_render_args(p)
        return {a.dest for a in p._actions}

    assert flags(C) == flags(J)
    assert (C.CHUNK_CARD, C.CHUNK_CPU) == (480000, 16384)
    pack, cam = load_scene(TEXTURED_XML, resource_root=ASSETS, device="cpu")
    assert dataclasses.is_dataclass(cam) and cam.width * cam.height > 0
