"""Inverse rendering and data parallelism over lanes (the port of
bhraytracer_tpu/parallel/sharding.py).

The flat (pixel, sample) lane axis is sharded over a 1-D "dp" mesh of
torch.distributed ranks, one process per device, and the scene is
replicated on every rank (`make_mesh`, parallel/multihost.py). Rank r
renders lanes [r*shard, (r+1)*shard).

  - `render_radiance_sharded`: every rank passes the global lanes and
    gets the global (N, 3) radiance back (one all-gather). Rank r keys
    its shard by its global lane offset, fold_in(key, r*shard), as the
    JAX package's shard_map body does (sharding.py:61-93): the same
    estimator as a one-device render with decorrelated streams, not the
    same bits.
  - `render_image_distributed`: a whole image, chunk by chunk, each chunk
    as `render_radiance_sharded` renders it, the samples summed on each
    rank before one all-gather a chunk.
  - `train_step_sharded`: one SGD step; each rank differentiates its
    lanes' part of the image MSE, and the loss and gradients are summed
    over the ranks in one all-reduce. As the JAX step (one global program
    keyed by `key`), it is the one-device step at any world size: each
    rank renders its lanes in the lane frame of the whole chunk
    (`lane_frame`, models/pathtracer.py), keyed by `key`, so its draws
    and compactions are those of one process rendering every lane; the
    frame's compactions exchange counts (one all-gather of a few int64
    each, about two a tree level).
  - `train_step` is the one-device step (no mesh).

Gradients are torch.autograd's through `_render_chunk` with
cfg.differentiable (models/pathtracer.py): hit ids stay frozen, and the
continuous remainder (shading, resolve, texture lookups) is
differentiated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from bhraytracer_tpu_torch.models.pathtracer import ChunkStats, _render_chunk
from bhraytracer_tpu_torch.ops import rng
from bhraytracer_tpu_torch.ops.camera import from_scene_camera
from bhraytracer_tpu_torch.ops.compact import LaneFrame
from bhraytracer_tpu_torch.ops.trace import check_traceable
from bhraytracer_tpu_torch.parallel.multihost import init_group, rank_device

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


def _value_and_grad(params: dict, wrt, loss_fn):
    """(loss, {name: grad}) of loss_fn(leaves), the leaves the parameters
    detached, those named in `wrt` (all where None) requiring grad; an
    unused parameter's gradient is zeros."""
    wrt = list(params) if wrt is None else list(wrt)
    leaves = {k: v.detach().requires_grad_(k in wrt)
              for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in wrt],
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in zip(wrt, grads)}


def loss_and_grads(params: dict, pack, cfg, cam, width: int, height: int, px,
                   py, target, key, photon_map=None, wrt=None):
    """The mean squared error of the radiance of lanes (px, py) against
    target (N,3), and its gradient with respect to the parameters named in
    `wrt` (all by default; the others are held constant): (loss (),
    {name: grad}). cfg must be differentiable."""
    if not cfg.differentiable:
        raise ValueError("loss_and_grads needs cfg.differentiable")

    def loss_fn(leaves):
        pk, cm = _apply_params(pack, cam, leaves)
        rad, _, _ = _render_chunk(pk, cfg, cm, width, height, px, py, key,
                                  photon_map)
        return torch.mean((rad - target) ** 2)

    return _value_and_grad(params, wrt, loss_fn)


def _sgd(params: dict, grads: dict, lr: float) -> dict:
    return {k: v.detach() - lr * grads[k] for k, v in params.items()}


def train_step(params: dict, opt_state, pack, cfg, cam, width: int,
               height: int, px, py, target, key, lr: float = 1e-2):
    """One SGD step of inverse rendering (train_step_sharded,
    sharding.py:153-176, on one device): (new params, opt_state, loss)."""
    loss, grads = loss_and_grads(params, pack, cfg, cam, width, height, px,
                                 py, target, key)
    return _sgd(params, grads, lr), opt_state, loss


# ---------------------------------------------------------------------------
# the mesh and the sharded lanes
# ---------------------------------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, device=None) -> DeviceMesh:
    """The 1-D DeviceMesh, dimension "dp", over every rank of the process
    group (sharding.py:35-39). Without a group, a world of one starts on a
    local HashStore, so a plain single-process call works as the JAX one
    does; its backend is `backend_for` the device (the card unless
    `device` names another; the CPU raises without a card).

    One process drives one device, so the mesh is the world: n_devices
    must be None or the world size (ValueError otherwise). The JAX
    package's first-n-devices of one process is not ported (ROADMAP
    Queue 3)."""
    dev = rank_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a world of {world} "
                         "ranks: one process drives one device, so the mesh "
                         "spans the world")
    if not dist.is_initialized():
        init_group(dev, store=dist.HashStore(), world_size=1, rank=0)
    return DeviceMesh(dev.type, list(range(world)), mesh_dim_names=("dp",))


def _dp(mesh: DeviceMesh, n: int):
    """(group, this rank, shard) of n lanes on the mesh's "dp"."""
    ndev = mesh.size()
    if n % ndev:
        raise ValueError(f"{n} lanes do not split over {ndev} ranks")
    return mesh.get_group("dp"), mesh.get_local_rank("dp"), n // ndev


def _shard(x, r: int, shard: int):
    return x[r * shard:(r + 1) * shard]


def _all_gather(x, group):
    """The ranks' x (each (shard, ...)) stacked in rank order: one
    all_gather_into_tensor."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _count_exchange(group, rank: int, counts):
    """(the sum over lower ranks, the sum over all) of each rank's (S,)
    int64 counts: one all_gather_into_tensor on the mesh's group."""
    every = _all_gather(counts, group).view(-1, counts.shape[0])
    return every[:rank].sum(0), every.sum(0)


def lane_frame(mesh: DeviceMesh, n: int, device) -> LaneFrame:
    """This rank's lanes [r*shard, (r+1)*shard) of n global lanes as a lane
    frame on `device` (ops/compact.py): `_render_chunk(...,
    frame=lane_frame(mesh, n, device))` of those lanes renders them as one
    process renders all n, its compactions exchanging counts over the
    mesh."""
    group, r, shard = _dp(mesh, n)
    dev = torch.device(device)
    return LaneFrame(
        rows=torch.arange(r * shard, (r + 1) * shard, device=dev), width=n,
        seg=torch.zeros(shard, dtype=torch.int64, device=dev), n_seg=1,
        exchange=lambda counts: _count_exchange(group, r, counts))


def _render_shard(pack, cfg, cam, width, height, px, py, key, r, shard):
    """_render_chunk of rank r's lanes of the global (px, py), keyed by the
    shard's global lane offset: fold_in(key, r * shard) (sharding.py:
    86-88)."""
    return _render_chunk(pack, cfg, cam, width, height, _shard(px, r, shard),
                         _shard(py, r, shard), rng.fold_in(key, r * shard))


def render_radiance_sharded(pack, cfg, cam, width: int, height: int, px, py,
                            key, mesh: DeviceMesh):
    """The (N, 3) radiance of the global lanes (px, py) (N), on every rank
    (sharding.py:61-93): rank r renders lanes [r*shard, (r+1)*shard)
    keyed fold_in(key, r*shard), and one all-gather assembles them. N must
    divide by the mesh's size. Not bit-identical to a one-device render of
    the same lanes: the same estimator with other streams."""
    group, r, shard = _dp(mesh, px.shape[0])
    rad, _, _ = _render_shard(pack, cfg, cam, width, height, px, py, key, r,
                              shard)
    return _all_gather(rad, group)


def loss_and_grads_sharded(params: dict, pack, cfg, cam, width: int,
                           height: int, px, py, target, key,
                           mesh: DeviceMesh):
    """The image MSE over the global lanes (px, py) against target (N, 3),
    and its gradients with respect to every parameter, the same on every
    rank: (loss (), {name: grad}), loss_and_grads' at any world size up to
    the order of float sums. Rank r differentiates
    sum((rad_r - target_r)**2) / (3N) of its lanes, rendered in the lane
    frame of all N keyed by `key` (lane_frame); the loss and the gradients
    are summed over the ranks in one all-reduce of one flat buffer."""
    if not cfg.differentiable:
        raise ValueError("loss_and_grads_sharded needs cfg.differentiable")
    n = px.shape[0]
    group, r, shard = _dp(mesh, n)

    frame = lane_frame(mesh, n, px.device)

    def loss_fn(leaves):
        pk, cm = _apply_params(pack, cam, leaves)
        rad, _, _ = _render_chunk(pk, cfg, cm, width, height,
                                  _shard(px, r, shard), _shard(py, r, shard),
                                  key, frame=frame)
        return torch.sum((rad - _shard(target, r, shard)) ** 2) / (3 * n)

    loss, grads = _value_and_grad(params, None, loss_fn)
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1)
                                          for g in grads.values()])
    dist.all_reduce(flat, group=group)
    parts = flat[1:].split([g.numel() for g in grads.values()])
    return flat[0], {k: p.view_as(g)
                     for (k, g), p in zip(grads.items(), parts)}


def train_step_sharded(params: dict, opt_state, pack, cfg, cam, width: int,
                       height: int, px, py, target, key, mesh: DeviceMesh,
                       lr: float = 1e-2):
    """One SGD step of inverse rendering on sharded lanes (sharding.py:
    154-176): (new params, opt_state passed through, loss), the same on
    every rank and, up to the order of float sums, `train_step`'s at any
    world size. The gradients are loss_and_grads_sharded's."""
    loss, grads = loss_and_grads_sharded(params, pack, cfg, cam, width,
                                         height, px, py, target, key, mesh)
    return _sgd(params, grads, lr), opt_state, loss


# ---------------------------------------------------------------------------
# full-image distributed render
# ---------------------------------------------------------------------------


def render_image_distributed(pack, camera, cfg, mesh: DeviceMesh,
                             seed: int = 0, return_stats: bool = False):
    """A whole image, its lanes sharded over the mesh (sharding.py:
    184-233): (H, W, 3) float32 after gamma on the pack's device, on every
    rank, as `render_image` returns it; with return_stats also the
    ChunkStats summed over the image and the ranks (padding lanes
    included).

    Chunks of max(ndev, (cfg.chunk_rays // ndev) * ndev) pixels, the last
    padded to a multiple of the mesh's size by repeating its first pixel;
    sample s of the chunk at `start` keyed fold_in(fold_in(PRNGKey(seed),
    s), start), each shard by its lane offset (render_radiance_sharded).
    Each rank sums its shard's samples on the device, and one all-gather a
    chunk assembles them. No escalation, aux, adaptive pass or photon map:
    the JAX function has none."""
    check_traceable(pack)
    dev = pack.device
    cam = from_scene_camera(camera, dev)
    width, height = camera.width, camera.height
    total = width * height
    ndev = mesh.size()
    chunk = max(ndev, (cfg.chunk_rays // ndev) * ndev)
    key = rng.prng_key(seed, dev)
    accum = torch.zeros((total, 3), device=dev)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    for start in range(0, total, chunk):
        stop = min(start + chunk, total)
        idx = torch.arange(start, stop + (start - stop) % ndev, device=dev)
        idx = torch.where(idx < stop, idx, start)
        px, py = idx % width, idx // width
        group, r, shard = _dp(mesh, idx.shape[0])
        acc = None
        for s in range(cfg.spp):
            ck = rng.fold_in(rng.fold_in(key, s), start)
            rad, _, st = _render_shard(pack, cfg, cam, width, height, px, py,
                                       ck, r, shard)
            acc = rad if acc is None else acc + rad
            stats = stats + torch.stack(list(st))
        accum[start:stop] = _all_gather(acc, group)[:stop - start]
    img = accum / cfg.spp
    if cfg.use_gamma:
        img = torch.pow(torch.clamp_min(img, 0.0), 1.0 / cfg.gamma)
    img = img.reshape(height, width, 3)
    if not return_stats:
        return img
    dist.all_reduce(stats, group=mesh.get_group("dp"))
    return img, ChunkStats(*(int(x) for x in stats.cpu()))
