"""One rank of tests/test_torch_sharding.py's gloo worlds on the CPU:

    python tests/_torch_dist_ranks.py RANK WORLD INIT_FILE OUT_DIR

Joins the world at file://INIT_FILE, makes the "dp" mesh and runs every
port-side check of the module on the tiny scene (the same scene and
config as tests/_torch_sharding_jax.py, whose top level imports numpy
only), writing OUT_DIR/rank<RANK>.npz. Rank 0 of the world of 2 also
computes what one process gets (`single*`: loss_and_grads of all lanes,
and DROP_CFG's render of all DROP_LANES lanes), outside any collective,
and the camera gradients' lane mass (`camera_mass`). This module imports
torch and the port, never JAX.
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
CAMERA = ("cam_pos", "cam_dir", "cam_up")


def camera_mass(params, pack, cfg, cam, w, h, px, py, target, key):
    """For each camera parameter's element e, sum_i |d l_i / d theta_e| /
    (3N) over the lanes' squared errors l_i = |rad_i - target_i|^2: the
    loss gradient's terms before they cancel in its sum (forward-mode AD,
    one pass an element, one process)."""
    import torch.autograd.forward_ad as fwd

    from bhraytracer_tpu_torch.parallel import sharding as S

    out = {}
    for name in CAMERA:
        cols = []
        for j in range(params[name].numel()):
            with fwd.dual_level():
                tan = torch.zeros_like(params[name])
                tan.view(-1)[j] = 1.0
                leaves = dict(params,
                              **{name: fwd.make_dual(params[name], tan)})
                pk, cm = S._apply_params(pack, cam, leaves)
                rad, _, _ = S._render_chunk(pk, cfg, cm, w, h, px, py, key)
                lanes = ((rad - target) ** 2).sum(-1)
                cols.append(fwd.unpack_dual(lanes).tangent.abs().sum())
        out[name] = torch.stack(cols).view_as(params[name]) / (
            3 * px.shape[0])
    return out


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

    params = S.trainable_params(pack, cam_p)
    tkey = rng.prng_key(J.KEY_TRAIN)
    target = torch.from_numpy(J.target())
    loss, grads = S.loss_and_grads_sharded(params, pack, cfg, cam_p, w, h,
                                           px, py, target, tkey, mesh)
    res["loss"] = loss
    res.update({f"grad/{k}": g for k, g in grads.items()})
    res.update({f"param/{k}": v for k, v in params.items()})

    # DROP_CFG: this rank's lanes in the frame of all DROP_LANES lanes.
    dcfg, dkey = RenderConfig(**J.DROP_CFG), rng.prng_key(J.DROP_KEY)
    dx, dy = (torch.from_numpy(a.astype(np.int64))
              for a in J.lanes(w, h, J.DROP_LANES))
    shard = J.DROP_LANES // world
    mine = slice(rank * shard, (rank + 1) * shard)
    with torch.no_grad():
        rad, _, st = S._render_chunk(
            pack, dcfg, cam_p, w, h, dx[mine], dy[mine], dkey,
            frame=S.lane_frame(mesh, J.DROP_LANES, cpu))
        res["drop_rad"], res["drop_stats"] = rad, np.array(list(st))
    if rank == 0 and world == 2:
        one_loss, one_grads = S.loss_and_grads(params, pack, cfg, cam_p, w,
                                               h, px, py, target, tkey)
        res["single_loss"] = one_loss
        res.update({f"single_grad/{k}": g for k, g in one_grads.items()})
        with torch.no_grad():
            rad, _, st = S._render_chunk(pack, dcfg, cam_p, w, h, dx, dy,
                                         dkey)
        res["drop_single_rad"] = rad
        res["drop_single_stats"] = np.array(list(st))
        res.update({f"camera_mass/{k}": v for k, v in camera_mass(
            params, pack, cfg, cam_p, w, h, px, py, target, tkey).items()})

    if world == 2:
        icam = dataclasses.replace(cam, width=J.IMAGE_SIZE[0],
                                   height=J.IMAGE_SIZE[1])
        img, st = S.render_image_distributed(
            pack, icam, RenderConfig(**J.IMAGE_CFG), mesh, seed=J.IMAGE_SEED,
            return_stats=True)
        res["image_is_tensor"] = isinstance(img, torch.Tensor)
        res["image"], res["image_stats"] = img, np.array(list(st))

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
