"""Inverse rendering: the trainable parameters of a render and one
gradient step (the port of bhraytracer_tpu/parallel/sharding.py:101-176).

`train_step` is `train_step_sharded` on one device: the JAX package shards
the lanes over a mesh and all-reduces the gradients, which on one device
is the same function. The mesh, `render_image_distributed` and
multihost.py are not ported yet.

Gradients are torch.autograd's through `_render_chunk` with
cfg.differentiable (models/pathtracer.py): hit ids stay frozen, and the
continuous remainder (shading, resolve, texture lookups) is
differentiated.
"""

from __future__ import annotations

import dataclasses

import torch

from bhraytracer_tpu_torch.models.pathtracer import _render_chunk

# trainable_params keys that live on the camera (the rest on the pack).
_CAMERA = {"cam_pos": "pos", "cam_dir": "dir", "cam_up": "up"}


def trainable_params(pack, cam, include_geometry: bool = False,
                     include_textures: bool = False) -> dict:
    """The differentiable parameters: material table, lights and camera
    (sharding.py:101-131). include_geometry adds the local-frame mesh
    vertex pool `verts`; include_textures adds the checker colours and the
    image atlas, promoted to float32 on its 0..255 scale (the texture
    lookups' 1/255 stays right), so texels are differentiated through the
    bilinear and filter weights. The tensors are the pack's and the
    camera's (the atlas a float copy)."""
    d = dict(
        mtl_diffuse=pack.mtl_diffuse,
        mtl_specular=pack.mtl_specular,
        mtl_gloss=pack.mtl_gloss,
        mtl_refraction=pack.mtl_refraction,
        mtl_absorption=pack.mtl_absorption,
        light_intensity=pack.light_intensity,
        light_vec=pack.light_vec,
        cam_pos=cam.pos,
        cam_dir=cam.dir,
        cam_up=cam.up,
    )
    if include_geometry:
        d["verts"] = pack.verts
    if include_textures:
        d["tex_c1"] = pack.tex_c1
        d["tex_c2"] = pack.tex_c2
        d["atlas"] = pack.atlas.float()
    return d


def _apply_params(pack, cam, params: dict):
    """(pack, camera) with the parameters in place (sharding.py:134-151).
    dataclasses.replace gives the pack an empty cache; the traces keep the
    compiled geometry tables, so only the resolve sees new vertices, as in
    the JAX package."""
    fields = {k: v for k, v in params.items() if k not in _CAMERA}
    pack = dataclasses.replace(pack, **fields)
    cam = cam._replace(**{_CAMERA[k]: params[k] for k in _CAMERA})
    return pack, cam


def loss_and_grads(params: dict, pack, cfg, cam, width: int, height: int, px,
                   py, target, key, photon_map=None, wrt=None):
    """The mean squared error of the radiance of lanes (px, py) against
    target (N,3), and its gradient with respect to the parameters named in
    `wrt` (all by default; the others are held constant): (loss (),
    {name: grad}). cfg must be differentiable."""
    if not cfg.differentiable:
        raise ValueError("loss_and_grads needs cfg.differentiable")
    wrt = list(params) if wrt is None else list(wrt)
    leaves = {k: v.detach().requires_grad_(k in wrt)
              for k, v in params.items()}
    pk, cm = _apply_params(pack, cam, leaves)
    rad, _, _ = _render_chunk(pk, cfg, cm, width, height, px, py, key,
                              photon_map)
    loss = torch.mean((rad - target) ** 2)
    grads = torch.autograd.grad(loss, [leaves[k] for k in wrt],
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in zip(wrt, grads)}


def train_step(params: dict, opt_state, pack, cfg, cam, width: int,
               height: int, px, py, target, key, lr: float = 1e-2):
    """One SGD step of inverse rendering (train_step_sharded,
    sharding.py:153-176, on one device): (new params, opt_state, loss)."""
    loss, grads = loss_and_grads(params, pack, cfg, cam, width, height, px,
                                 py, target, key)
    new = {k: (v.detach() - lr * grads[k]) for k, v in params.items()}
    return new, opt_state, loss
