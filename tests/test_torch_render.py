"""The slice as a whole: the port's render_image on the CPU (every trace
and shade setup through the kernels' plain PyTorch twins) against the JAX
package's render_image on the CPU (its jnp path), 32x24 at spp 2,
gi_bounces 1, extra_refr_levels 1, tir_bounces 4, one chunk per image.

The RNG streams are bit-equal (ops/rng.py), so lanes pair up one to one.
Tolerances, and why they are not exact:
  - The JAX CPU path traces meshes with the dominant-axis BVH test, the
    port with the affine-barycentric stream test; a seam ray may take the
    adjacent face at the same t, and a Monte Carlo decision downstream may
    then differ. XLA also fuses multiply-adds that the port rounds twice.
  - tiny_scene has no mesh: drop and segment counts are equal and at
    least 99.9% of pixels agree to 1e-4.
  - bench_scene: at least 99% of pixels agree to 1e-4, the mean absolute
    difference is below 1e-3 and the segment counts within 0.5%.
The JAX reference renders with fused_levels=False (per-level programs,
bit-identical numerics, pathtracer.py:1256), which compiles in about half
the time of the one-program chunk on the CPU, and the two scenes' JAX
renders compile side by side in two threads.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bhraytracer_tpu.config import RenderConfig as JConfig
from bhraytracer_tpu.models.pathtracer import render_image as j_render
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.models.pathtracer import image_to_u8, render_image
from tests._torch_parity import jax_scene, port_pack

torch.set_num_threads(2)

W, H = 32, 24
CFG = dict(spp=2, gi_bounces=1, extra_refr_levels=1, tir_bounces=4,
           chunk_rays=W * H)


def _camera(name):
    return dataclasses.replace(jax_scene(name)[1], width=W, height=H)


def _jax_render(name):
    jimg, aux = j_render(jax_scene(name)[0], _camera(name),
                         JConfig(**CFG, fused_levels=False), seed=0,
                         return_aux=True)
    return np.asarray(jimg), aux


@pytest.fixture(scope="module")
def jax_renders():
    """Both scenes' JAX renders, started together on first use."""
    with ThreadPoolExecutor(2) as ex:
        yield {name: ex.submit(_jax_render, name) for name in ("tiny", "bench")}


def _render_both(jax_renders, name):
    img, st = render_image(port_pack(name), _camera(name), RenderConfig(**CFG),
                           seed=0, return_stats=True)
    jimg, aux = jax_renders[name].result(timeout=900)
    return jimg, aux, img.numpy(), st


def test_tiny_scene_matches_jax(jax_renders):
    jimg, aux, img, st = _render_both(jax_renders, "tiny")
    drops = aux["dropped_lanes"]
    assert (st.drop_refr, st.drop_tir, st.drop_gi) == (
        drops["refr_overflow"], drops["tir_overflow"], drops["gi_overflow"])
    assert st.segments == aux["traced_segments"]
    close = (np.abs(img - jimg).max(-1) <= 1e-4).mean()
    assert close >= 0.999, close
    assert img.shape == (H, W, 3) and np.isfinite(img).all()


def test_bench_scene_matches_jax(jax_renders):
    jimg, aux, img, st = _render_both(jax_renders, "bench")
    close = (np.abs(img - jimg).max(-1) <= 1e-4).mean()
    assert close >= 0.99, close
    assert np.abs(img - jimg).mean() < 1e-3
    assert abs(st.segments - aux["traced_segments"]) <= 0.005 * aux["traced_segments"]
    np.testing.assert_array_equal(image_to_u8(torch.from_numpy(img)),
                                  image_to_u8(img))


def test_render_refuses_what_is_not_ported():
    pack, cam = port_pack("tiny"), _camera("tiny")
    for kw in (dict(use_photon_map=True), dict(differentiable=True),
               dict(use_denoiser=True), dict(use_dof=True),
               dict(adaptive_spp=4)):
        with pytest.raises(NotImplementedError):
            render_image(pack, cam, RenderConfig(**kw))
    with pytest.raises(NotImplementedError):
        render_image(pack, cam, checkpoint_dir="ckpt")
    for bad in (dataclasses.replace(pack, n_texmaps=1),
                dataclasses.replace(pack, face_v=torch.zeros((9000, 3)))):
        with pytest.raises(NotImplementedError):
            render_image(bad, cam)
