"""The JAX side of tests/test_torch_gradients.py, run in a child process
(reverse-mode XLA:CPU compiles are kept out of the pytest workers,
tests/conftest.py:61-64):

    python tests/_torch_gradients_jax.py OUT.npz [PART ...]

PART is a setup of SCENES or "gather" (all by default). For each setup, one jitted value_and_grad of the mean radiance
of _render_chunk over trainable_params(include_geometry=True,
include_textures=True) writes the lanes' radiance, z0 and stats and every
gradient; for the photon gather, the gradient of its outputs with respect
to the query points and normals (the XLA fold). It also writes the
parameters it differentiated; the test builds the same packs, the port's
copies of them, and holds the port's parameters equal to these.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

KEY = 7  # the JAX tests' PRNGKey(7)
# Photon gather: tests/test_torch_photon.py's skewed population, 512 lanes.
N_PH, N_Q, RADIUS, GATHER_K = 4096, 512, 0.25, 32


def cfg_kw(width: int, height: int) -> dict:
    """tests/test_gradients.py:61-64's config."""
    return dict(spp=1, gi_bounces=1, extra_refr_levels=0, tir_bounces=2,
                chunk_rays=width * height, texture_sample_count=1,
                differentiable=True)


def scene_desc(name: str, desc):
    """The setup `name` as a SceneDesc of module `desc` (the port's
    bhraytracer_tpu_torch.scenes builders take the desc module)."""
    from bhraytracer_tpu_torch import scenes

    if name == "mesh":
        return scenes.gradient_mesh_scene_desc(desc)
    return scenes.gradient_scene_desc(desc, textured=name == "textured")


SCENES = ("sphere", "mesh", "textured")


def photon_population(seed: int = 0):
    """(pos, dirn, power, query points, query normals) as numpy: the skewed
    population of tests/test_torch_photon.py, every fourth query."""
    g = np.random.default_rng(seed)
    pos = g.uniform(-2, 2, (N_PH, 3)).astype(np.float32)
    pos[:N_PH // 2] = (0.3 + g.normal(0, 0.02, (N_PH // 2, 3))).astype(np.float32)
    dirn = g.normal(size=(N_PH, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    power = g.uniform(0, 1, (N_PH, 3)).astype(np.float32)
    qp = g.uniform(-2, 2, (4 * N_Q, 3)).astype(np.float32)
    qp[:2 * N_Q] = (0.3 + g.normal(0, 0.05, (2 * N_Q, 3))).astype(np.float32)
    qn = g.normal(size=(4 * N_Q, 3)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    return pos, dirn, power, qp[::4], qn[::4]


def _scene_grads(name: str, out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from bhraytracer_tpu.config import RenderConfig
    from bhraytracer_tpu.models.pathtracer import _render_chunk
    from bhraytracer_tpu.ops.camera import from_scene_camera
    from bhraytracer_tpu.parallel.sharding import _apply_params, trainable_params
    from bhraytracer_tpu.scene import desc as D
    from bhraytracer_tpu.scene.compile import compile_scene

    sd = scene_desc(name, D)
    pack, cam = compile_scene(sd), sd.camera
    w, h = cam.width, cam.height
    cfg = RenderConfig(**cfg_kw(w, h))
    cam_p = from_scene_camera(cam)
    idx = np.arange(w * h)
    px = jnp.asarray(idx % w, jnp.int32)
    py = jnp.asarray(idx // w, jnp.int32)
    key = jax.random.PRNGKey(KEY)
    params = trainable_params(pack, cam_p, include_geometry=True,
                              include_textures=True)

    @jax.jit
    def vg(p):
        def loss(p_):
            pk, cm = _apply_params(pack, cam_p, p_)
            rad, z0, st = _render_chunk(pk, cfg, cm, w, h, px, py, key)
            return jnp.mean(rad), (rad, z0, jnp.stack(list(st)))

        return jax.value_and_grad(loss, has_aux=True)(p)

    (_, (rad, z0, st)), grads = vg(params)
    for k, v in params.items():
        out[f"{name}/param/{k}"] = np.asarray(v)
    out[f"{name}/rad"] = np.asarray(rad)
    out[f"{name}/z0"] = np.asarray(z0)
    out[f"{name}/stats"] = np.asarray(st)
    for k, g in grads.items():
        out[f"{name}/grad/{k}"] = np.asarray(g)


def _gather_grads(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from bhraytracer_tpu.models import photonmap as JP

    pos, dirn, power, qp, qn = photon_population()
    jpmap = JP.build_grid_index(pos, dirn, power, RADIUS)
    g = np.random.default_rng(1)
    w_irr = jnp.asarray(g.normal(size=(N_Q, 3)), jnp.float32)
    w_ds = jnp.asarray(g.normal(size=(N_Q, 3)), jnp.float32)

    @jax.jit
    def vg(p, n):
        def f(p_, n_):
            irr, ds = JP.gather_irradiance(jpmap, p_, n_, k=GATHER_K)
            return jnp.sum(irr * w_irr) + jnp.sum(ds * w_ds), (irr, ds)

        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, n)

    (_, (irr, ds)), (gp, gn) = vg(jnp.asarray(qp), jnp.asarray(qn))
    out["gather/irr"] = np.asarray(irr)
    out["gather/ds"] = np.asarray(ds)
    out["gather/w_irr"] = np.asarray(w_irr)
    out["gather/w_ds"] = np.asarray(w_ds)
    out["gather/grad_pos"] = np.asarray(gp)
    out["gather/grad_normal"] = np.asarray(gn)


def main(path: str, parts) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for part in parts or (*SCENES, "gather"):
        if part == "gather":
            _gather_grads(out)
        else:
            _scene_grads(part, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
