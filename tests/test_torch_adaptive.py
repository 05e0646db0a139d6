"""The rest of the port's render_image against the JAX package's: the aux
outputs (z-buffer, sample counts, first-hit albedo and normal, drop and
segment counts), the adaptive pass, sample_offset, depth of field, and
resumable renders (checkpoints). Both sides on the CPU, the port through its
kernels' plain twins, the JAX package with fused_levels=False (per-level
programs, bit-identical numerics, as tests/test_torch_render.py); its
renders compile side by side in threads from the module's first test.

tiny_scene and bench_scene at 32x24, spp 2, gi_bounces 1,
extra_refr_levels 1, tir_bounces 4, one chunk. Tolerances, and why:
  - sample counts, z-buffer hit masks, drop and segment counts: equal;
  - radiance and z: rtol = atol = 1e-5 (the RNG streams are bit-equal, so
    lanes pair up; XLA fuses multiply-adds that the port rounds twice);
  - albedo: equal (a table lookup of equal material ids);
  - normal: atol 5e-5. A sphere's normal divides the hit point's offset
    from the centre by the radius, so the hit point's fused-rounding
    difference (~1e-6 of t) shows there amplified: 2.8e-5 at most,
    measured on both scenes.
The photon scene (16x12, tests/test_torch_photon.py's config, one map
carried across) and the render at sample_offset 2 take the render
tolerances of tests/test_torch_render.py's mesh scenes (99% of pixels
within 1e-4, mean abs below 1e-3): a few of their pixels take another
Monte Carlo branch, a uniform within rounding of its threshold.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bhraytracer_tpu.config import RenderConfig as JConfig
from bhraytracer_tpu.models import photonmap as JP
from bhraytracer_tpu.models.pathtracer import render_image as j_render
from bhraytracer_tpu.models.pathtracer import zbuffer_to_u8 as j_zbuffer_to_u8
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.models import photonmap as P
from bhraytracer_tpu_torch.models.pathtracer import (
    _adaptive_select,
    render_image,
    zbuffer_to_u8,
)
from bhraytracer_tpu_torch.ops.linalg import BIG
from bhraytracer_tpu_torch.utils.checkpoint import (
    load_render_state,
    save_render_state,
)
from tests._torch_parity import jax_scene, port_pack

torch.set_num_threads(2)

W, H = 32, 24
BASE = dict(spp=2, gi_bounces=1, extra_refr_levels=1, tir_bounces=4,
            chunk_rays=W * H)
ADAPTIVE = dict(BASE, adaptive_spp=3, adaptive_fraction=0.25)
DOF = dict(BASE, use_dof=True)
# tests/test_torch_photon.py's render config, with the adaptive pass.
PHOTON = dict(spp=2, gi_bounces=1, extra_refr_levels=0, tir_bounces=4,
              chunk_rays=16 * 12, use_photon_map=True, photon_count=1024,
              photon_gather_max=32, adaptive_spp=3, adaptive_fraction=0.25)
AUX_KEYS = {"zbuffer", "sample_count", "albedo", "normal", "dropped_lanes",
            "traced_segments"}


def _camera(name, w=W, h=H, dof=None):
    cam = dataclasses.replace(jax_scene(name)[1], width=w, height=h)
    if dof is not None:
        cam.dof = dof
    return cam


def _photon_maps():
    """(the port's map, the JAX package's): the port's photons, indexed by
    the JAX package and carried back (tests/test_torch_photon.py)."""
    built = P.build_photon_map(port_pack("tiny"), RenderConfig(**PHOTON),
                               seed=0, batch=8192)
    jpmap = JP.build_grid_index(built.pos.numpy(), built.dirn.numpy(),
                                built.power.numpy(), built.radius)
    pmap = P.pmap_from_numpy(*(np.asarray(x) for x in jpmap[:5]),
                             *jpmap[5:], device="cpu")
    return pmap, jpmap


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX package's renders, started together on first use: name ->
    (future of (image, aux), port render_image keywords)."""
    pmap, jpmap = _photon_maps()
    jobs = {
        "tiny": ("tiny", _camera("tiny"), BASE, {}),
        "bench": ("bench", _camera("bench"), BASE, {}),
        "offset": ("tiny", _camera("tiny"), BASE, dict(sample_offset=2)),
        "adaptive": ("tiny", _camera("tiny"), ADAPTIVE, {}),
        "dof": ("tiny", _camera("tiny", dof=0.05), DOF, {}),
        "photon": ("tiny", _camera("tiny", 16, 12), PHOTON,
                   dict(photon_map=jpmap)),
    }
    with ThreadPoolExecutor(4) as ex:
        futs = {k: ex.submit(j_render, jax_scene(scene)[0], cam,
                             JConfig(**cfg, fused_levels=False), seed=0,
                             return_aux=True, **kw)
                for k, (scene, cam, cfg, kw) in jobs.items()}
        yield {k: (futs[k], scene, cam, cfg,
                   dict(kw, photon_map=pmap) if "photon_map" in kw else kw)
               for k, (scene, cam, cfg, kw) in jobs.items()}


def _both(jax_renders, name):
    """(port image, port aux, JAX image, JAX aux) of a job, as numpy."""
    fut, scene, cam, cfg, kw = jax_renders[name]
    img, aux = render_image(port_pack(scene), cam, RenderConfig(**cfg),
                            seed=0, return_aux=True, **kw)
    jimg, jaux = fut.result(timeout=900)
    return img.numpy(), aux, np.asarray(jimg), jaux


def _check_aux(aux, jaux):
    assert set(aux) == set(jaux) == AUX_KEYS
    np.testing.assert_array_equal(aux["sample_count"], jaux["sample_count"])
    assert aux["sample_count"].dtype == np.int32
    hit, jhit = aux["zbuffer"] < BIG, jaux["zbuffer"] < BIG
    np.testing.assert_array_equal(hit, jhit)
    assert hit.any() and not hit.all()
    np.testing.assert_allclose(aux["zbuffer"][hit], jaux["zbuffer"][hit],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(aux["albedo"], jaux["albedo"])
    np.testing.assert_allclose(aux["normal"], jaux["normal"], rtol=0,
                               atol=5e-5)
    assert not aux["normal"][~hit].any() and aux["normal"][hit].any()
    assert aux["dropped_lanes"] == jaux["dropped_lanes"]
    assert aux["traced_segments"] == jaux["traced_segments"]


@pytest.mark.parametrize("name", ["tiny", "bench"])
def test_render_aux_matches_jax(jax_renders, name):
    img, aux, jimg, jaux = _both(jax_renders, name)
    _check_aux(aux, jaux)
    assert (aux["sample_count"] == BASE["spp"]).all()
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-5)


def _reference_select(img_lin, fraction):
    """The JAX package's selection, as written inline in its render_image
    (bhraytracer_tpu/models/pathtracer.py:1565-1571)."""
    height, width = img_lin.shape[:2]
    total = height * width
    pad = np.pad(img_lin, ((1, 1), (1, 1), (0, 0)), mode="edge")
    blur = sum(pad[i:i + height, j:j + width]
               for i in range(3) for j in range(3)) / 9.0
    metric = np.abs(img_lin - blur).sum(-1).reshape(-1)
    k_sel = max(1, int(total * fraction))
    return np.sort(np.argpartition(metric, total - k_sel)[total - k_sel:])


@pytest.mark.parametrize("fraction", [0.0, 0.15, 0.25, 0.5])
def test_adaptive_select_matches_reference(fraction):
    g = np.random.default_rng(11)
    img = g.uniform(0, 1, (29, 37, 3)).astype(np.float32)
    img[:10, :10] = 0.5  # a flat patch: equal (zero) contrast, ties
    sel = _adaptive_select(img, fraction)
    np.testing.assert_array_equal(sel, _reference_select(img, fraction))
    assert sel.shape[0] == max(1, int(img.shape[0] * img.shape[1] * fraction))


def test_adaptive_pass_matches_jax(jax_renders):
    img, aux, jimg, jaux = _both(jax_renders, "adaptive")
    _check_aux(aux, jaux)
    sc = aux["sample_count"]
    assert (sc == 5).sum() == int(W * H * 0.25)
    assert ((sc == 2) | (sc == 5)).all()
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-5)
    # The base pass is untouched where the adaptive pass did not go.
    base = render_image(port_pack("tiny"), _camera("tiny"),
                        RenderConfig(**BASE), seed=0).numpy()
    np.testing.assert_array_equal(img[sc == 2], base[sc == 2])
    assert np.abs(img[sc == 5] - base[sc == 5]).max() > 1e-3


def test_adaptive_pass_escalates_dropped_chunks():
    """Where an adaptive chunk drops lanes (here GI children beyond a 5%
    capacity), it is re-rendered with escalating capacities as a base chunk
    is, so the render ends with no drop; the reference keeps the adaptive
    pass's lossy samples, which adaptive_full_capacity=False reproduces
    (ROADMAP, Queue 3)."""
    pack, cam = port_pack("tiny"), _camera("tiny")
    kw = dict(BASE, gi_capacity=0.05, adaptive_fraction=0.5)

    def drops(**extra):
        _, aux = render_image(pack, cam, RenderConfig(**kw, **extra), seed=0,
                              return_aux=True)
        return aux["dropped_lanes"]["gi_overflow"], aux["sample_count"]

    base, _ = drops(adaptive_full_capacity=False)
    lossy, sc = drops(adaptive_full_capacity=False, adaptive_spp=2)
    assert 0 < base < lossy  # the adaptive pass dropped lanes of its own
    kept, sc2 = drops(adaptive_spp=2)
    assert kept == 0
    for counts in (sc, sc2):
        assert (counts == 4).sum() == W * H // 2


def test_photon_adaptive_pass_matches_jax(jax_renders):
    img, aux, jimg, jaux = _both(jax_renders, "photon")
    np.testing.assert_array_equal(aux["sample_count"], jaux["sample_count"])
    assert (aux["sample_count"] == 5).sum() == int(16 * 12 * 0.25)
    assert aux["dropped_lanes"] == jaux["dropped_lanes"]
    assert aux["traced_segments"] == jaux["traced_segments"]
    close = (np.abs(img - jimg).max(-1) <= 1e-4).mean()
    assert close >= 0.99, close
    assert np.abs(img - jimg).mean() < 1e-3


def test_sample_offset_partitions_stream():
    """Two half-budget renders at offsets 0 and 1 average to the full one
    (tests/test_progressive.py)."""
    pack, cam = port_pack("tiny"), _camera("tiny")
    cfg = RenderConfig(**dict(BASE, use_gamma=False))
    full = render_image(pack, cam, cfg, seed=0)
    half = dataclasses.replace(cfg, spp=1)
    a = render_image(pack, cam, half, seed=0, sample_offset=0)
    b = render_image(pack, cam, half, seed=0, sample_offset=1)
    np.testing.assert_allclose(((a + b) / 2.0).numpy(), full.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_sample_offset_matches_jax(jax_renders):
    """Offset 2's streams: 2 of the 768 pixels take another Monte Carlo
    branch on the two sides (1.5e-3 off, measured; a uniform within
    rounding of its threshold), so the image takes the render tolerances
    of tests/test_torch_render.py's mesh scenes; everything else is held
    as at offset 0."""
    img, aux, jimg, jaux = _both(jax_renders, "offset")
    _check_aux(aux, jaux)
    close = (np.abs(img - jimg).max(-1) <= 1e-4).mean()
    assert close >= 0.99, close
    assert np.abs(img - jimg).mean() < 1e-3
    _, _, timg, _ = _both(jax_renders, "tiny")
    assert np.abs(img - timg).max() > 1e-3  # other samples


def test_dof_matches_jax(jax_renders):
    img, aux, jimg, jaux = _both(jax_renders, "dof")
    _check_aux(aux, jaux)
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-5)
    pin = render_image(port_pack("tiny"), _camera("tiny", dof=0.05),
                       RenderConfig(**BASE), seed=0).numpy()
    assert np.abs(img - pin).max() > 1e-3  # the lens moved the eye


def test_zbuffer_to_u8_matches_jax():
    g = np.random.default_rng(3)
    z = g.uniform(1.0, 9.0, (12, 16)).astype(np.float32)
    z[g.uniform(size=z.shape) < 0.3] = BIG
    np.testing.assert_array_equal(zbuffer_to_u8(z), j_zbuffer_to_u8(z))
    np.testing.assert_array_equal(zbuffer_to_u8(np.full((2, 2), BIG)),
                                  np.zeros((2, 2), np.uint8))


def _ckpt_cfg():
    return RenderConfig(spp=1, gi_bounces=1, extra_refr_levels=0,
                        tir_bounces=2, chunk_rays=128,
                        texture_sample_count=1)


def test_render_resume_exact(tmp_path):
    """A killed render continues where it stopped and ends on the image of
    an uninterrupted render (tests/test_checkpoint.py), aux included."""
    pack, cam = port_pack("tiny"), _camera("tiny", 16, 12)
    cfg = _ckpt_cfg()
    ckpt = str(tmp_path / "ck")
    full, faux = render_image(pack, cam, cfg, seed=5, return_aux=True)
    img1 = render_image(pack, cam, cfg, seed=5, checkpoint_dir=ckpt)
    np.testing.assert_array_equal(img1.numpy(), full.numpy())
    state = load_render_state(ckpt, cfg, cam.width, cam.height, 5)
    assert state is not None
    accum, zbuf, done = state
    assert done.all() and done.shape == (2,)
    # Corrupt the second chunk's accumulation, mark it unfinished, resume.
    done[1] = False
    accum = accum.copy()
    accum[128:] = 7.0
    save_render_state(ckpt, accum, zbuf, done, cfg, cam.width, cam.height, 5)
    img2, aux2 = render_image(pack, cam, cfg, seed=5, checkpoint_dir=ckpt,
                              return_aux=True)
    np.testing.assert_array_equal(img2.numpy(), full.numpy())
    np.testing.assert_array_equal(aux2["zbuffer"], faux["zbuffer"])


def test_render_checkpoint_config_mismatch(tmp_path):
    pack, cam = port_pack("tiny"), _camera("tiny", 16, 12)
    cfg = _ckpt_cfg()
    ckpt = str(tmp_path / "ck")
    render_image(pack, cam, cfg, seed=5, checkpoint_dir=ckpt)
    # Another seed, size or config: the checkpoint is not resumed.
    assert load_render_state(ckpt, cfg, cam.width, cam.height, 6) is None
    assert load_render_state(ckpt, cfg, cam.width, 11, 5) is None
    assert load_render_state(ckpt, dataclasses.replace(cfg, spp=2),
                             cam.width, cam.height, 5) is None
    assert load_render_state(ckpt, cfg, cam.width, cam.height, 5) is not None
