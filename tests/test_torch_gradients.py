"""Reverse-mode gradients of the port (cfg.differentiable) against the JAX
package, on the setups of tests/test_gradients.py (a sphere over a ground
plane) and tests/test_gradients_mesh.py (a textured quad mesh over a
checker plane), both at 24x18 with their config (spp 1, gi_bounces 1,
extra_refr_levels 0, tir_bounces 2, one texture tap), built by
bhraytracer_tpu_torch.scenes with the JAX package's SceneDesc and carried
across with pack_from_numpy (the JAX trainable_params, carried as numpy by
params_from_numpy, equal the port's bit for bit); and a third, the sphere
setup with its sphere textured ("textured").

The JAX side runs in child processes (tests/_torch_gradients_jax.py, one
per setup, started by the module's first test): one jitted
value_and_grad of the mean radiance over every key of
trainable_params(include_geometry=True, include_textures=True) each, and
the photon gather's gradient with respect to its query points. The port's
own tests (finite differences, the parameter round trip, a 64x64 descent
step) run meanwhile.

Tolerances, and why:
  - forward radiance rtol = atol = 1e-5 (the ROADMAP standard); z0 rtol
    1e-5 (distances ~10, XLA contracts multiply-adds the port rounds);
    segment and drop counts equal;
  - gradients |g_port - g_jax| <= 1e-3 max|g_jax| + 1e-9 per array: the
    same math, summed in another order (XLA's reductions and contracted
    multiply-adds). The absolute term stays far below the smallest
    nonzero gradient (the mesh atlas's), so the relative term decides.
    Measured, error (max|g_jax|), sphere / mesh / textured:
      mtl_diffuse      2.2e-8 (0.11)    1.1e-8 (0.062)   3.0e-8 (0.11)
      mtl_specular     1.3e-9 (9.0e-3)  4.7e-10 (1.6e-3) 9.3e-10 (9.0e-3)
      mtl_gloss        5.8e-11 (2.7e-4) 1.5e-11 (1.8e-4) 8.7e-11 (2.7e-4)
      mtl_refraction   5.8e-10 (2.4e-4) 4.0e-11 (4.9e-5) 5.8e-10 (2.4e-4)
      mtl_absorption   0 (0)            0 (0)            0 (0)
      light_intensity  5.8e-10 (1.4e-3) 1.2e-10 (8.6e-4) 4.7e-10 (1.2e-3)
      light_vec        7.5e-9 (0.023)   1.9e-9 (0.016)   7.5e-9 (0.022)
      cam_pos          4.5e-8 (0.029)   7.5e-9 (0.027)   3.0e-8 (0.025)
      cam_dir          3.4e-7 (0.25)    6.7e-8 (0.25)    2.4e-7 (0.26)
      cam_up           4.1e-8 (0.012)   1.9e-8 (7.5e-3)  3.8e-8 (0.011)
      verts            0 (0)            4.0e-9 (2.9e-3)  0 (0)
      tex_c1, tex_c2   0 (0)            4.1e-8 (0.061)   0 (0)
      atlas            0 (0)            1.2e-11 (5.6e-6) 1.1e-11 (2.8e-5)
    worst 3.5e-6 of max|g_jax| (cam_up);
  - finite differences: the JAX tests' eps and tolerances
    (test_gradients.py:97-103, test_gradients_mesh.py:117-124) on the
    three coordinates of largest gradient;
  - the gather's gradient: exactly 0 on both sides.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bhraytracer_tpu_torch import scenes
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.models import photonmap as P
from bhraytracer_tpu_torch.models.pathtracer import _render_chunk, render_image
from bhraytracer_tpu_torch.ops import rng
from bhraytracer_tpu_torch.ops.camera import from_scene_camera
from bhraytracer_tpu_torch.ops.trace import (
    resolve_hit,
    rows_from_pools,
    trace_closest,
    trace_shadow,
)
from bhraytracer_tpu_torch.parallel.sharding import (
    _apply_params,
    loss_and_grads,
    train_step,
    trainable_params,
)
from bhraytracer_tpu_torch.scene.pack import pack_from_numpy
from tests import _torch_gradients_jax as J

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Child processes: the mesh setup's program is the slowest to compile.
CHILDREN = (("mesh",), ("sphere",), ("textured", "gather"))
KEYS = ("mtl_diffuse", "mtl_specular", "mtl_gloss", "mtl_refraction",
        "mtl_absorption", "light_intensity", "light_vec", "cam_pos",
        "cam_dir", "cam_up", "verts", "tex_c1", "tex_c2", "atlas")


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """Start the JAX side's children with the module's first test; the
    fixture gives part -> that part's results (waiting for its child)."""
    tmp = tmp_path_factory.mktemp("jax_grads")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for parts in CHILDREN:
        path = str(tmp / ("_".join(parts) + ".npz"))
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_torch_gradients_jax.py"),
             path, *parts], env=env, cwd=REPO)
        procs.update({p: (proc, path) for p in parts})

    def result(part: str) -> dict:
        proc, path = procs[part]
        assert proc.wait(timeout=900) == 0, f"JAX child for {part} failed"
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    yield result
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class Setup:
    """A setup on the CPU: the port's pack (the JAX pack carried across),
    its camera at 24x18 as CameraParams, the config, the lanes and key."""

    def __init__(self, name: str, width: int = 0, height: int = 0):
        from bhraytracer_tpu.scene import desc as JD
        from bhraytracer_tpu.scene.compile import compile_scene
        from tests._torch_parity import pack_dict

        sd = J.scene_desc(name, JD)
        self.pack = pack_from_numpy(pack_dict(compile_scene(sd)),
                                    device="cpu")
        self.cam = from_scene_camera(sd.camera, "cpu")
        self.w = width or sd.camera.width
        self.h = height or sd.camera.height
        self.cfg = RenderConfig(**J.cfg_kw(self.w, self.h))
        idx = torch.arange(self.w * self.h)
        self.px, self.py = idx % self.w, idx // self.w
        self.key = rng.prng_key(J.KEY, "cpu")

    def params(self):
        return trainable_params(self.pack, self.cam, include_geometry=True,
                                include_textures=True)

    def render(self, params):
        pk, cm = _apply_params(self.pack, self.cam, params)
        return _render_chunk(pk, self.cfg, cm, self.w, self.h, self.px,
                             self.py, self.key)

    def mean_grads(self):
        """(rad, z0, stats, {key: gradient of the mean radiance})."""
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in self.params().items()}
        rad, z0, st = self.render(leaves)
        gs = torch.autograd.grad(rad.mean(), list(leaves.values()),
                                 allow_unused=True)
        return (rad.detach(), z0, st,
                {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), gs)})


@functools.lru_cache(maxsize=None)
def setup(name: str) -> Setup:
    return Setup(name)


@functools.lru_cache(maxsize=None)
def port_grads(name: str):
    return setup(name).mean_grads()


# ---------------------------------------------------------------------------
# the port alone (while the JAX side compiles)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,param,eps,tol", [
    ("sphere", "mtl_diffuse", 1e-3, 0.08),
    ("sphere", "light_intensity", 1e-2, 0.08),
    ("sphere", "cam_pos", 1e-3, 0.15),
    ("mesh", "verts", 2e-3, 0.15),
    ("mesh", "tex_c1", 1e-3, 0.08),
    ("mesh", "atlas", 0.5, 0.08),  # the 0..255 scale
])
def test_grad_matches_fd(name, param, eps, tol):
    """Autograd against central differences on the three coordinates of
    largest gradient, as the JAX tests probe theirs."""
    s = setup(name)
    g = port_grads(name)[3][param].numpy().ravel()
    base = s.params()
    flat = base[param].detach().double().numpy().ravel()
    shape = base[param].shape
    assert np.isfinite(g).all() and np.abs(g).max() > 1e-8, param

    def loss(x):
        with torch.no_grad():
            p = dict(base, **{param: torch.from_numpy(
                x.reshape(shape)).float()})
            return float(s.render(p)[0].mean())

    for i in np.argsort(-np.abs(g))[:3]:
        if abs(g[i]) < 1e-6:
            continue
        dv = np.zeros_like(flat)
        dv[i] = eps
        fd = (loss(flat + dv) - loss(flat - dv)) / (2 * eps)
        assert abs(fd - g[i]) <= tol * max(abs(fd), abs(g[i]), 1e-4), (
            param, i, fd, g[i])


@pytest.mark.parametrize("name", ["sphere", "mesh"])
def test_grads_nonzero_and_finite(name):
    """tests/test_gradients.py:test_grad_nonzero_and_finite's parameters,
    and on the mesh setup the vertices and texture tables."""
    grads = port_grads(name)[3]
    keys = ["mtl_diffuse", "mtl_specular", "light_intensity", "cam_pos"]
    if name == "mesh":
        keys += ["verts", "tex_c1", "tex_c2", "atlas"]
    for k in grads:
        assert torch.isfinite(grads[k]).all(), k
    for k in keys:
        assert float(grads[k].abs().max()) > 1e-8, k


def test_trainable_params_roundtrip():
    """verts and the texture tables enter and leave the parameters intact
    (test_gradients_mesh.py:test_trainable_params_roundtrip); the atlas is
    float32 on its 0..255 scale, and the camera keys land on the camera."""
    s = setup("mesh")
    params = s.params()
    assert set(params) == set(KEYS)
    assert params["atlas"].dtype == torch.float32
    assert torch.equal(params["atlas"], s.pack.atlas.float())
    pk, cm = _apply_params(s.pack, s.cam, {k: v + 0.0 for k, v in
                                           params.items()})
    assert pk.verts.shape == s.pack.verts.shape
    assert pk.atlas.dtype == torch.float32
    assert torch.equal(cm.pos, s.cam.pos) and torch.equal(cm.up, s.cam.up)
    assert pk.cache == {} and pk.stream_rows is s.pack.stream_rows


def test_inverse_step_64_descends():
    """One value_and_grad at 64x64 (4096 lanes) against a target rendered
    with the diffuse table scaled by 0.7, then the backtracking step along
    mtl_diffuse of test_gradients_mesh.py:161-202 descends; train_step is
    the same gradient's SGD step."""
    s = Setup("mesh", 64, 64)
    params = trainable_params(s.pack, s.cam, include_geometry=True)
    with torch.no_grad():
        target = s.render(dict(params,
                               mtl_diffuse=params["mtl_diffuse"] * 0.7))[0]
    args = (s.pack, s.cfg, s.cam, s.w, s.h, s.px, s.py, target, s.key)
    l0, grads = loss_and_grads(params, *args)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert float(grads["mtl_diffuse"].abs().max()) > 0
    l1 = None
    for lr in (0.05, 0.01, 0.002):
        new = dict(params, mtl_diffuse=params["mtl_diffuse"]
                   - lr * grads["mtl_diffuse"])
        with torch.no_grad():
            l1 = float(torch.mean((s.render(new)[0] - target) ** 2))
        if l1 < float(l0):
            break
    assert l1 < float(l0), (l1, float(l0))
    stepped, state, loss = train_step(params, None, *args, lr=1e-2)
    assert state is None and float(loss) == float(l0)
    assert torch.equal(stepped["verts"], params["verts"] - 1e-2 * grads["verts"])


def test_rows_from_pools_equal_resolve_rows():
    """rows_from_pools rebuilds the compiled resolve rows bit for bit (on
    the mesh setup and the 1,408-face teapot), from the pools."""
    for pack in (setup("mesh").pack, scenes.bench_scene("cpu")[0]):
        assert torch.equal(rows_from_pools(pack), pack.resolve_rows)
    s = setup("mesh")
    verts = s.pack.verts.clone().requires_grad_()
    rows = rows_from_pools(dataclasses.replace(s.pack, verts=verts))
    (g,) = torch.autograd.grad(rows[:, 0:9].sum(), verts)
    assert float(g.abs().sum()) > 0


def test_lookup_rows_matches_indexing():
    """lookup_rows (index_select) gives advanced indexing's values and
    gradients on a small table read by many duplicate indices, the
    material and light lookups' shape."""
    from bhraytracer_tpu_torch.ops.compact import lookup_rows

    g = torch.Generator().manual_seed(0)
    tab = torch.rand(4, 3, generator=g, requires_grad=True)
    idx = torch.randint(0, 4, (5000,), generator=g, dtype=torch.int32)
    w = torch.rand(5000, 3, generator=g)
    a = lookup_rows(tab, idx)
    b = tab[idx.long()]
    assert torch.equal(a, b)
    (ga,) = torch.autograd.grad((a * w).sum(), tab)
    (gb,) = torch.autograd.grad((b * w).sum(), tab)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-4)
    assert torch.equal(lookup_rows(tab, idx.reshape(50, 100)),
                       tab[idx.long().reshape(50, 100)])


def test_traces_are_detached():
    """Traces take detached rays, as the JAX package's stop_gradient: no
    kernel or twin output carries a graph."""
    s = setup("mesh")
    o = torch.tensor([[0.0, -8.0, 3.0]]).repeat(4, 1).requires_grad_()
    d = torch.tensor([[0.0, 1.0, -0.2], [0.05, 1.0, -0.1], [0.0, 1.0, 0.3],
                      [0.0, 1.0, -0.35]]).requires_grad_()
    hit = trace_closest(s.pack, o, d, reorder=False)
    assert not hit.t.requires_grad and bool(hit.hit.any())
    occ = trace_shadow(s.pack, o, d, torch.ones(4, requires_grad=True), 1e-5)
    assert not occ.requires_grad
    # The surface is recomputed differentiably from the frozen ids.
    assert resolve_hit(s.pack, o, d, hit).p.requires_grad


def test_render_image_differentiable(tmp_path):
    """render_image renders a differentiable config forward (unfused, as
    the JAX package) like the default one, and with the other four options
    (adaptive sampling, depth of field, the denoiser, a checkpoint)."""
    pack, cam = scenes.gradient_scene("cpu")
    cam.width, cam.height = 16, 12
    kw = dict(spp=1, gi_bounces=1, extra_refr_levels=0, tir_bounces=2,
              chunk_rays=192)
    img, st = render_image(pack, cam, RenderConfig(**kw, differentiable=True),
                           return_stats=True)
    ref = render_image(pack, cam, RenderConfig(**kw))
    assert img.shape == (12, 16, 3) and bool(torch.isfinite(img).all())
    assert st.drop_refr == st.drop_tir == st.drop_gi == 0
    assert float((img - ref).abs().amax(-1).le(1e-4).float().mean()) >= 0.99
    cfg = RenderConfig(**kw, differentiable=True, adaptive_spp=2,
                       use_dof=True, use_denoiser=True)
    ck = str(tmp_path / "ck")
    img, aux = render_image(pack, cam, cfg, return_aux=True,
                            checkpoint_dir=ck)
    assert img.shape == (12, 16, 3) and bool(torch.isfinite(img).all())
    assert set(np.unique(aux["sample_count"])) == {1, 3}
    again = render_image(pack, cam, cfg, checkpoint_dir=ck)  # resumed
    assert torch.equal(again, img)


def test_photon_map_built_without_graph():
    """The map is a constant of a render: built under no_grad even from a
    pack whose light table requires grad."""
    pack, _ = scenes.tiny_scene("cpu")
    pack = dataclasses.replace(
        pack, light_intensity=pack.light_intensity.clone().requires_grad_())
    cfg = RenderConfig(photon_count=256)
    pmap = P.build_photon_map(pack, cfg, seed=0, batch=1024)
    assert not pmap.rows.requires_grad and pmap.rows.shape[0] > 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _close_grad(g, jg):
    """|g - jg| <= 1e-3 max|jg| + 1e-9; returns the error over max|jg|."""
    err = float(np.abs(g - jg).max()) if g.size else 0.0
    lim = 1e-3 * float(np.abs(jg).max(initial=0.0)) + 1e-9
    assert err <= lim, (err, lim)
    return err / max(float(np.abs(jg).max(initial=0.0)), 1e-30)


@pytest.mark.parametrize("name", ["sphere", "mesh", "textured"])
def test_params_carry_across(jax_side, name):
    """The JAX package's trainable_params, carried across as numpy
    (params_from_numpy), equal the port's from the carried pack bit for
    bit: both packages differentiate the same values."""
    from tests._torch_parity import params_from_numpy

    ref = jax_side(name)
    pre = f"{name}/param/"
    jp = params_from_numpy({k[len(pre):]: v for k, v in ref.items()
                            if k.startswith(pre)})
    own = setup(name).params()
    assert set(jp) == set(own) == set(KEYS)
    for k in KEYS:
        assert jp[k].shape == own[k].shape and torch.equal(jp[k], own[k]), k


@pytest.mark.parametrize("name", ["sphere", "mesh", "textured"])
def test_forward_matches_jax(jax_side, name):
    """_render_chunk's radiance, z0 and counts, port against JAX."""
    ref = jax_side(name)
    rad, z0, st, _ = port_grads(name)
    np.testing.assert_allclose(rad.numpy(), ref[f"{name}/rad"], rtol=1e-5,
                               atol=1e-5)
    jz = ref[f"{name}/z0"]
    hit = jz < 1e29
    np.testing.assert_array_equal(z0.detach().numpy() < 1e29, hit)
    np.testing.assert_allclose(z0.detach().numpy()[hit], jz[hit], rtol=1e-5)
    np.testing.assert_array_equal([int(x) for x in st], ref[f"{name}/stats"])
    assert int(st.segments) > 0


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("name", ["sphere", "mesh"])
def test_grad_matches_jax(jax_side, name, key):
    """The gradient of the mean radiance, port against JAX, per key."""
    ref = jax_side(name)
    g = port_grads(name)[3][key].numpy()
    jg = ref[f"{name}/grad/{key}"]
    assert g.shape == jg.shape
    _close_grad(g, jg)


def test_sphere_uv_is_not_differentiated(jax_side):
    """Repair: a textured sphere's uv comes from the detached hit point
    (bhraytracer_tpu/ops/trace.py:842), so the camera's gradients equal
    the JAX package's; differentiating the uv moves cam_pos's."""
    ref = jax_side("textured")
    grads = port_grads("textured")[3]
    for k in ("cam_pos", "cam_dir", "mtl_diffuse", "atlas"):
        _close_grad(grads[k].numpy(), ref[f"textured/grad/{k}"])
    assert float(grads["cam_pos"].abs().max()) > 1e-6


def test_mesh_resolve_reaches_verts(jax_side):
    """Repair: mesh hits resolve through rows_from_pools on the
    differentiable path, so the vertex gradient is nonzero and equal to
    the JAX package's (through the compiled resolve_rows it would be 0)."""
    ref = jax_side("mesh")
    g = port_grads("mesh")[3]["verts"].numpy()
    assert np.abs(g).max() > 1e-4
    _close_grad(g, ref["mesh/grad/verts"])


def test_gather_gradient_is_zero(jax_side):
    """The photon gather's outputs carry no gradient to the query points
    and normals: jax.grad of the XLA fold is exactly 0, and the port's
    gather (its twin on the CPU; kernel 10 on the card) is 0 too, on the
    JAX map carried across, with equal values."""
    from bhraytracer_tpu.models import photonmap as JP

    ref = jax_side("gather")
    assert not ref["gather/grad_pos"].any()
    assert not ref["gather/grad_normal"].any()
    pos, dirn, power, qp, qn = J.photon_population()
    jpmap = JP.build_grid_index(pos, dirn, power, J.RADIUS)
    pmap = P.pmap_from_numpy(*(np.asarray(x) for x in jpmap[:5]),
                             *jpmap[5:], device="cpu")
    p = torch.from_numpy(qp).requires_grad_()
    n = torch.from_numpy(qn).requires_grad_()
    irr, ds = P.gather_irradiance(pmap, p, n, k=J.GATHER_K)
    np.testing.assert_allclose(irr.numpy(), ref["gather/irr"], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ds.numpy(), ref["gather/ds"], rtol=1e-3,
                               atol=1e-3)
    assert (ref["gather/irr"] > 0).any(1).mean() > 0.3
    f = ((irr * torch.from_numpy(ref["gather/w_irr"])).sum()
         + (ds * torch.from_numpy(ref["gather/w_ds"])).sum())
    assert not f.requires_grad
    gp, gn = torch.autograd.grad(f + 0.0 * (p.sum() + n.sum()), (p, n))
    assert not gp.any() and not gn.any()
