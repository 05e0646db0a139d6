"""The textured slice as a whole: data/textured.xml loaded by the port's
load_scene and rendered by its render_image on the CPU (every trace
through the kernels' plain PyTorch twins; shading unfused, as the JAX
package's fused kernel gates itself off on texture maps), against the JAX
package's own load_scene and render_image (fused_levels=False) on the same
file, at 32x24, spp 2, gi_bounces 1, extra_refr_levels 1, tir_bounces 4,
with texture_sample_count 1 and 32 (the filter's taps on the checker
ground). The scene has a checker ground, a wood-textured sphere, a glass
sphere, the teapot and a uv-mapped banner textured with china.png, and a
textured background and environment.

Tolerances: tests/test_torch_render.py's mesh-scene ones (at least 99% of
pixels within 1e-4, mean absolute difference below 1e-3, segment counts
within 0.5%, drops 0/0/0): the JAX CPU path traces meshes with another
triangle test, XLA fuses multiply-adds the port rounds twice, and a
sphere's texture coordinates go through atan2 and asin, whose ulps differ.
The two JAX renders compile side by side in two threads from the module's
first test.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bhraytracer_tpu.config import RenderConfig as JConfig
from bhraytracer_tpu.models.pathtracer import render_image as j_render
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.models.pathtracer import render_image
from bhraytracer_tpu_torch.scenes import textured_scene
from tests._torch_parity import jax_scene

torch.set_num_threads(2)

W, H = 32, 24
TAPS = (1, 32)


def _cfg(taps):
    return dict(spp=2, gi_bounces=1, extra_refr_levels=1, tir_bounces=4,
                chunk_rays=W * H, texture_sample_count=taps)


def _jax_render(taps):
    jpack, jcam = jax_scene("textured")
    jimg, aux = j_render(jpack, dataclasses.replace(jcam, width=W, height=H),
                         JConfig(**_cfg(taps), fused_levels=False), seed=0,
                         return_aux=True)
    return np.asarray(jimg), aux


@pytest.fixture(scope="module")
def jax_renders():
    jax_scene("textured")  # loaded once, before the threads share it
    with ThreadPoolExecutor(len(TAPS)) as ex:
        yield {taps: ex.submit(_jax_render, taps) for taps in TAPS}


@pytest.fixture(scope="module")
def port_scene():
    pack, cam = textured_scene(device="cpu")
    cam.width, cam.height = W, H
    return pack, cam


@pytest.mark.parametrize("taps", TAPS)
def test_textured_render_matches_jax(jax_renders, port_scene, taps):
    pack, cam = port_scene
    assert pack.n_texmaps == 5
    img, st = render_image(pack, cam, RenderConfig(**_cfg(taps)), seed=0,
                           return_stats=True)
    jimg, aux = jax_renders[taps].result(timeout=900)
    img = img.numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    close = (np.abs(img - jimg).max(-1) <= 1e-4).mean()
    assert close >= 0.99, close
    assert np.abs(img - jimg).mean() < 1e-3
    assert abs(st.segments - aux["traced_segments"]) <= (
        0.005 * aux["traced_segments"])
    assert (st.drop_refr, st.drop_tir, st.drop_gi) == (0, 0, 0)
    assert img.std() > 0.05


def test_filter_taps_change_the_ground(jax_renders, port_scene):
    """The 32-tap filter acts on the checker ground only (the plane's ray
    differentials): the two renders differ there, in the port as in the
    JAX package."""
    pack, cam = port_scene
    imgs = [render_image(pack, cam, RenderConfig(**_cfg(t)), seed=0).numpy()
            for t in TAPS]
    jimgs = [jax_renders[t].result(timeout=900)[0] for t in TAPS]
    moved = np.abs(imgs[0] - imgs[1]).max(-1) > 1e-3
    jmoved = np.abs(jimgs[0] - jimgs[1]).max(-1) > 1e-3
    assert moved.sum() > 20
    assert (moved == jmoved).mean() >= 0.99
