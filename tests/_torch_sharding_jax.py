"""The JAX side of tests/test_torch_sharding.py, run in a child process
(XLA:CPU compiles are kept out of the pytest workers, tests/conftest.py:
61-64):

    python tests/_torch_sharding_jax.py OUT.npz

On conftest's 8-device virtual CPU mesh, with tests/test_sharding.py:
30-39's tiny-scene config (CFG), it writes:
  - rad/<n>: render_radiance_sharded of LANES lanes (KEY) on make_mesh(n),
    n in WORLDS;
  - single/<n>: the same lanes as one jitted _render_chunk a shard on one
    device, shard r keyed fold_in(KEY, r * shard): what the shard_map body
    computes, compiled outside it;
  - image: render_image_distributed on make_mesh(2) at IMAGE_SIZE with
    IMAGE_CFG and IMAGE_SEED;
  - loss, grad/<name>: train_step_sharded on make_mesh(2), keyed
    PRNGKey(KEY_TRAIN), with trainable_params(pack, cam) and `target()`:
    its loss, and its gradients read back from the step as
    (params - new params) / GRAD_LR in float64. GRAD_LR is a power of two,
    so lr * g is exact, and so large that the float32 rounding of
    params - lr * g is ~6e-8 of |g| after the division;
  - vg_loss, vg_grad/<name>: the same loss and gradients as one jitted
    value_and_grad on one device, the scene, lanes, target and key closed
    over: the same function as the step, compiled as another program. The
    two differ on one of the 512 lanes, where a Monte Carlo decision takes
    the other branch (the step's loss 2.3e-5 above this one's); the test
    bounds the port by that difference too.

The shared constants of tests/test_torch_sharding.py's rank processes
(tests/_torch_dist_ranks.py) are here too: DROP_CFG / DROP_LANES, a
config that drops refraction and GI lanes on the tiny scene over three
levels, so a sharded render's compactions run over several segments of
global rows (ops/compact.py:LaneFrame).
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

LANES = 512
WORLDS = (2, 4)
KEY, KEY_TRAIN = 3, 4  # tests/test_sharding.py's PRNGKey(3) and (4)
CFG = dict(spp=1, gi_bounces=1, extra_refr_levels=0, tir_bounces=2,
           chunk_rays=512, texture_sample_count=1, differentiable=True)
# 25x19 = 475 pixels in one chunk, padded by one lane on 2 devices; two
# samples (each a compile of its own on the JAX side).
IMAGE_SIZE, IMAGE_SEED = (25, 19), 3
IMAGE_CFG = dict(CFG, spp=2)
GRAD_LR = 2.0 ** 30
# Drops 150 refraction lanes (of 278 candidates) and 1,921 GI lanes.
DROP_CFG = dict(CFG, gi_bounces=2, refr_capacity=0.01, gi_capacity=0.25,
                tir_head_trips=1)
DROP_LANES, DROP_KEY = 4096, 6


def lanes(width: int, height: int, n: int = LANES):
    """tests/test_sharding.py:_lanes as numpy int32 (px, py)."""
    idx = np.linspace(0, width * height - 1, n).astype(np.int64)
    return (idx % width).astype(np.int32), (idx // width).astype(np.int32)


def target() -> np.ndarray:
    """The train step's (LANES, 3) target, from a seed."""
    return np.random.default_rng(12).uniform(0.0, 0.6, (LANES, 3)).astype(
        np.float32)


def main(path: str) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import dataclasses

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from __graft_entry__ import _tiny_scene
    from bhraytracer_tpu.config import RenderConfig
    from bhraytracer_tpu.models.pathtracer import _render_chunk
    from bhraytracer_tpu.parallel.sharding import _apply_params
    from bhraytracer_tpu.ops.camera import from_scene_camera
    from bhraytracer_tpu.parallel.sharding import (
        make_mesh,
        render_image_distributed,
        render_radiance_sharded,
        train_step_sharded,
        trainable_params,
    )

    pack, cam = _tiny_scene()
    cfg = RenderConfig(**CFG)
    cam_p = from_scene_camera(cam)
    w, h = cam.width, cam.height
    px, py = (jnp.asarray(a) for a in lanes(w, h))
    out = {}

    def sharded(n):
        out[f"rad/{n}"] = np.asarray(render_radiance_sharded(
            pack, cfg, cam_p, w, h, px, py, jax.random.PRNGKey(KEY),
            make_mesh(n)))

    def single(n):
        shard = LANES // n
        run = jax.jit(lambda px_s, py_s, k: _render_chunk(
            pack, cfg, cam_p, w, h, px_s, py_s, k)[0])
        out[f"single/{n}"] = np.concatenate([np.asarray(run(
            px[r * shard:(r + 1) * shard], py[r * shard:(r + 1) * shard],
            jax.random.fold_in(jax.random.PRNGKey(KEY), r * shard)))
            for r in range(n)])

    def image():
        icam = dataclasses.replace(cam, width=IMAGE_SIZE[0],
                                   height=IMAGE_SIZE[1])
        out["image"] = render_image_distributed(
            pack, icam, RenderConfig(**IMAGE_CFG), make_mesh(2),
            seed=IMAGE_SEED)

    params = trainable_params(pack, cam_p)
    tgt, tkey = jnp.asarray(target()), jax.random.PRNGKey(KEY_TRAIN)

    def grads():
        new, _, loss = train_step_sharded(params, None, pack, cfg, cam_p, w,
                                          h, px, py, tgt, tkey, make_mesh(2),
                                          lr=GRAD_LR)
        out["loss"] = np.asarray(loss)
        for k, v in params.items():
            out[f"param/{k}"] = np.asarray(v)
            out[f"grad/{k}"] = ((np.asarray(v, np.float64)
                                 - np.asarray(new[k], np.float64)) / GRAD_LR)

    def value_and_grad():
        def loss(p):
            pk, cm = _apply_params(pack, cam_p, p)
            rad, _, _ = _render_chunk(pk, cfg, cm, w, h, px, py, tkey)
            return jnp.mean((rad - tgt) ** 2)

        lv, g = jax.jit(jax.value_and_grad(loss))(params)
        out["vg_loss"] = np.asarray(lv)
        out.update({f"vg_grad/{k}": np.asarray(v) for k, v in g.items()})

    # The programs compile side by side (XLA releases the GIL).
    with ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(grads), ex.submit(value_and_grad),
                  ex.submit(image),
                  *(ex.submit(fn, n) for n in WORLDS
                    for fn in (sharded, single))]:
            f.result()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
