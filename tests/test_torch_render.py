"""The port as a whole: the port's render_image on the CPU (every trace
and shade setup through the kernels' plain PyTorch twins) against the JAX
package's render_image on the CPU (its jnp path), one chunk per image:
tiny_scene and bench_scene at 32x24, spp 2, gi_bounces 1,
extra_refr_levels 1, tir_bounces 4; the big-mesh scene (111,616 faces) at
16x12 with bench._bigmesh_leg's config (spp 1, gi_bounces 1,
extra_refr_levels 1, tir_bounces 8).

The RNG streams are bit-equal (ops/rng.py), so lanes pair up one to one.
Tolerances, and why they are not exact:
  - The JAX CPU path traces meshes with the dominant-axis BVH test, the
    port with the affine-barycentric stream test; a seam ray may take the
    adjacent face at the same t, and a Monte Carlo decision downstream may
    then differ. XLA also fuses multiply-adds that the port rounds twice.
  - tiny_scene has no mesh: drop and segment counts are equal and at
    least 99.9% of pixels agree to 1e-4.
  - bench_scene and the big-mesh scene: at least 99% of pixels agree to
    1e-4, the mean absolute difference is below 1e-3 and the segment
    counts within 0.5%.
The JAX reference renders with fused_levels=False (per-level programs,
bit-identical numerics, pathtracer.py:1256), which compiles in about half
the time of the one-program chunk on the CPU, and the three scenes' JAX
renders compile side by side in three threads.
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
from bhraytracer_tpu_torch.ops.bvh import STACK_DEPTH
from bhraytracer_tpu_torch.ops.trace import trace_route
from tests._torch_parity import jax_scene, port_pack

torch.set_num_threads(2)

SIZE = {"tiny": (32, 24), "bench": (32, 24), "bigmesh": (16, 12)}
CFG = {name: dict(spp=2, gi_bounces=1, extra_refr_levels=1, tir_bounces=4)
       for name in ("tiny", "bench")}
CFG["bigmesh"] = dict(spp=1, gi_bounces=1, extra_refr_levels=1,
                      tir_bounces=8)  # bench.py:473-475


def _camera(name):
    w, h = SIZE[name]
    return dataclasses.replace(jax_scene(name)[1], width=w, height=h)


def _cfg(name):
    w, h = SIZE[name]
    return dict(CFG[name], chunk_rays=w * h)


def _jax_render(name):
    jimg, aux = j_render(jax_scene(name)[0], _camera(name),
                         JConfig(**_cfg(name), fused_levels=False), seed=0,
                         return_aux=True)
    return np.asarray(jimg), aux


@pytest.fixture(scope="module")
def jax_renders():
    """The three scenes' JAX renders, started together on first use."""
    with ThreadPoolExecutor(3) as ex:
        yield {name: ex.submit(_jax_render, name)
               for name in ("bigmesh", "tiny", "bench")}


def _render_both(jax_renders, name):
    img, st = render_image(port_pack(name), _camera(name),
                           RenderConfig(**_cfg(name)), seed=0,
                           return_stats=True)
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
    w, h = SIZE["tiny"]
    assert img.shape == (h, w, 3) and np.isfinite(img).all()


def _check_mesh_scene(jax_renders, name):
    jimg, aux, img, st = _render_both(jax_renders, name)
    close = (np.abs(img - jimg).max(-1) <= 1e-4).mean()
    assert close >= 0.99, close
    assert np.abs(img - jimg).mean() < 1e-3
    assert abs(st.segments - aux["traced_segments"]) <= 0.005 * aux["traced_segments"]
    assert (st.drop_refr, st.drop_tir, st.drop_gi) == (0, 0, 0)
    np.testing.assert_array_equal(image_to_u8(torch.from_numpy(img)),
                                  image_to_u8(img))


def test_bench_scene_matches_jax(jax_renders):
    _check_mesh_scene(jax_renders, "bench")


def test_bigmesh_scene_matches_jax(jax_renders):
    """111,616 faces: level 0 on the BVH twins, levels >= 1 and the chain
    on the grouped-stream twins (13 s of the file's time on one worker)."""
    _check_mesh_scene(jax_renders, "bigmesh")


@pytest.mark.parametrize("name", ["tiny", "bench", "bigmesh"])
def test_trace_route_matches_reference(name):
    """The port's route for (pack, reorder) is the reference's
    (_stream_enabled / _stream_uses_hbm, bhraytracer_tpu/ops/trace.py:
    186-223): the packet BVH kernels where the stream is off, the flat
    stream kernels or the grouped ones where it is on. A mesh-free scene
    runs the analytic kernels, as the reference does (trace.py:530-543)."""
    from bhraytracer_tpu.ops import trace as JT

    jpack = jax_scene(name)[0]
    for reorder in (False, True):
        if not jpack.n_msh:
            expected = "analytic"
        elif not JT._stream_enabled(jpack, reorder):
            expected = "bvh"
        elif JT._stream_uses_hbm(jpack):
            expected = "stream_hbm"
        else:
            expected = "stream"
        assert trace_route(port_pack(name), reorder) == expected, reorder
    assert trace_route(port_pack(name), False) == (
        "bvh" if jpack.n_msh else "analytic")


def test_render_refuses_what_is_not_ported():
    # Every option of the reference's render_image is ported: the
    # denoiser, depth of field, adaptive sampling and checkpoints
    # (tests/test_torch_adaptive.py, tests/test_torch_denoiser.py), and
    # differentiable renders (tests/test_torch_gradients.py); each renders.
    pack = port_pack("tiny")
    cam = dataclasses.replace(_camera("tiny"), width=8, height=6)
    for kw in (dict(use_denoiser=True), dict(use_dof=True),
               dict(adaptive_spp=4)):
        img = render_image(pack, cam, RenderConfig(**CFG["tiny"], **kw))
        assert img.shape == (6, 8, 3) and bool(torch.isfinite(img).all())
    # A tree deeper than the BVH kernels' per-ray stack is refused; any
    # face count is taken, and texture maps are rendered
    # (tests/test_torch_textured_render.py).
    bench = port_pack("bench")
    with pytest.raises(NotImplementedError):
        render_image(dataclasses.replace(bench, bvh_depth=STACK_DEPTH - 1), cam)
