"""Inverse rendering demo (BASELINE config 5, the port of
examples/inverse_render.py): recover material colours by gradient descent
on a rendered target.

Ground-truth scene (scenes.tiny_scene) -> render the target lanes; perturb
the diffuse table (seed 0, +-0.35, clipped to [0.02, 0.98]); optimise it
back with Adam (torch.optim.Adam: optax.adam's update and eps), clipping
to [0, 1] after each step; write start / recovered / truth PNGs (spp 4).
On the card by default, on the CPU with --cpu:

    python -m bhraytracer_tpu_torch.examples.inverse_render [--steps 60]
        [--lanes 2048] [--lr 5e-2] [--out DIR] [--cpu]

DIR defaults to invrender/ under the system's temporary directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "invrender"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bhraytracer_tpu_torch.config import RenderConfig
    from bhraytracer_tpu_torch.models.pathtracer import (
        _render_chunk,
        image_to_u8,
        render_image,
    )
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.parallel.sharding import (
        _apply_params,
        loss_and_grads,
        trainable_params,
    )
    from bhraytracer_tpu_torch.scenes import tiny_scene
    from bhraytracer_tpu_torch.utils.png import write_png

    dev = "cpu" if args.cpu else None
    pack, cam = tiny_scene(dev)
    dev = pack.device
    cfg = RenderConfig(
        spp=1, gi_bounces=1, extra_refr_levels=0, tir_bounces=2,
        chunk_rays=args.lanes, texture_sample_count=1, differentiable=True,
    )
    cam_p = from_scene_camera(cam, dev)
    n = args.lanes
    idx = torch.from_numpy(
        np.linspace(0, cam.width * cam.height - 1, n).astype(np.int64)).to(dev)
    px, py = idx % cam.width, idx // cam.width
    key = rng.prng_key(11, dev)

    # Ground truth + target lanes.
    with torch.no_grad():
        target, _, _ = _render_chunk(pack, cfg, cam_p, cam.width, cam.height,
                                     px, py, key)
    true_diffuse = pack.mtl_diffuse.cpu().numpy().copy()

    # Perturb: wrong material colours. Optimise ONLY the diffuse table (the
    # full parameter set includes camera basis vectors, which a hot Adam LR
    # would denormalise).
    full_params = trainable_params(pack, cam_p)
    g = np.random.default_rng(0)
    diffuse0 = torch.from_numpy(np.clip(
        true_diffuse + g.uniform(-0.35, 0.35, true_diffuse.shape), 0.02,
        0.98).astype(np.float32)).to(dev)
    diffuse = diffuse0.clone().requires_grad_()
    opt = torch.optim.Adam([diffuse], lr=args.lr)

    def step():
        loss, grads = loss_and_grads(dict(full_params, mtl_diffuse=diffuse),
                                     pack, cfg, cam_p, cam.width, cam.height,
                                     px, py, target, key,
                                     wrt=("mtl_diffuse",))
        opt.zero_grad()
        diffuse.grad = grads["mtl_diffuse"]
        opt.step()
        with torch.no_grad():
            diffuse.clamp_(0.0, 1.0)
        return loss

    def image(d):
        pk, _ = _apply_params(pack, cam_p, dict(full_params,
                                                 mtl_diffuse=d.detach()))
        return image_to_u8(render_image(pk, cam, dataclasses.replace(
            cfg, spp=4)))

    def err(d):
        return float(np.abs(d.detach().cpu().numpy() - true_diffuse).mean())

    os.makedirs(args.out, exist_ok=True)
    write_png(os.path.join(args.out, "start.png"), image(diffuse0))
    err0 = err(diffuse)
    for i in range(args.steps):
        loss = step()
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}  diffuse L1 err "
                  f"{err(diffuse):.4f}")
    err1 = err(diffuse)
    write_png(os.path.join(args.out, "recovered.png"), image(diffuse))
    write_png(os.path.join(args.out, "truth.png"), image(pack.mtl_diffuse))
    print(f"diffuse L1 error: {err0:.4f} -> {err1:.4f}")
    print(f"images in {args.out}/ (start / recovered / truth)")
    return err0, err1


if __name__ == "__main__":
    main()
