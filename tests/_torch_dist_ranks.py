"""One rank of tests/test_torch_sharding.py's gloo worlds on the CPU:

    python tests/_torch_dist_ranks.py RANK WORLD INIT_FILE OUT_DIR

Joins the world at file://INIT_FILE, makes the "dp" mesh and runs every
port-side check of the module on the tiny scene (the same scene and
config as tests/_torch_sharding_jax.py, whose top level imports numpy
only), writing OUT_DIR/rank<RANK>.npz. This module imports torch and the
port, never JAX.
"""

from __future__ import annotations

import datetime
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests import _torch_sharding_jax as J  # noqa: E402

LR, STEPS = 0.05, 5  # tests/test_sharding.py:143-163


def main(rank: int, world: int, init: str, out: str) -> None:
    import dataclasses

    from bhraytracer_tpu_torch.config import RenderConfig
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.parallel import sharding as S
    from bhraytracer_tpu_torch.parallel.multihost import init_group, shutdown
    from bhraytracer_tpu_torch.scenes import tiny_scene

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    init_group(cpu, init_method=f"file://{init}", world_size=world,
               rank=rank, timeout=datetime.timedelta(seconds=300))
    res = {}
    try:
        S.make_mesh(world + 1, device="cpu")
    except ValueError:
        res["mesh_refused"] = True
    mesh = S.make_mesh(device="cpu")
    res["mesh_size"] = mesh.size()

    pack, cam = tiny_scene(cpu)
    cfg = RenderConfig(**J.CFG)
    cam_p = from_scene_camera(cam, cpu)
    w, h = cam.width, cam.height
    px, py = (torch.from_numpy(a.astype(np.int64)) for a in J.lanes(w, h))
    key = rng.prng_key(J.KEY)

    def sharded(px_, py_, key_=key):
        return S.render_radiance_sharded(pack, cfg, cam_p, w, h, px_, py_,
                                         key_, mesh)

    seen, real = [], S._render_chunk

    def spy(*args, **kw):
        seen.append(tuple(args[5].shape))
        return real(*args, **kw)

    S._render_chunk = spy
    try:
        res["rad"] = sharded(px, py)
    finally:
        S._render_chunk = real
    res["local_shapes"] = np.array(seen)
    res["rad_again"] = sharded(px, py)
    try:
        sharded(px[:-1], py[:-1])
    except ValueError:
        res["split_refused"] = True
    qx, qy = (torch.from_numpy(a.astype(np.int64))
              for a in J.lanes(w, h, J.LANES // world))
    res["rad_tiled"] = sharded(qx.repeat(world), qy.repeat(world),
                               rng.prng_key(5))

    if world == 2:
        icam = dataclasses.replace(cam, width=J.IMAGE_SIZE[0],
                                   height=J.IMAGE_SIZE[1])
        img, st = S.render_image_distributed(
            pack, icam, RenderConfig(**J.IMAGE_CFG), mesh, seed=J.IMAGE_SEED,
            return_stats=True)
        res["image_is_tensor"] = isinstance(img, torch.Tensor)
        res["image"], res["image_stats"] = img, np.array(list(st))

        params = S.trainable_params(pack, cam_p)
        tkey = rng.prng_key(J.KEY_TRAIN)
        target = torch.from_numpy(J.target())
        loss, grads = S.loss_and_grads_sharded(params, pack, cfg, cam_p, w, h,
                                               px, py, target, tkey, mesh)
        res["loss"] = loss
        res.update({f"grad/{k}": g for k, g in grads.items()})
        res.update({f"param/{k}": v for k, v in params.items()})
        new, state, loss1 = S.train_step_sharded(
            params, "state", pack, cfg, cam_p, w, h, px, py, target, tkey,
            mesh, lr=LR)
        res["state_passed"] = state == "state"
        res["loss_step"] = loss1
        res.update({f"new/{k}": v for k, v in new.items()})

        # tests/test_sharding.py:143-163: toward a half-bright target.
        half, _, _ = S._render_chunk(pack, cfg, cam_p, w, h, px, py, tkey)
        half = half.detach() * 0.5
        p, losses = params, []
        for _ in range(STEPS):
            p, _, lv = S.train_step_sharded(p, None, pack, cfg, cam_p, w, h,
                                            px, py, half, tkey, mesh, lr=LR)
            losses.append(float(lv))
        res["losses"] = np.array(losses)
    shutdown()
    res["jax_imported"] = "jax" in sys.modules or "bhraytracer_tpu" in \
        sys.modules
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in res.items()})


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
