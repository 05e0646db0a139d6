"""Checkpoint and resume (the port of bhraytracer_tpu/utils/checkpoint.py).

The reference's only persistence is the photon map's `.dat` dump: a killed
render loses everything. Here the render's accumulation and the state of a
training loop can be saved and reloaded:

  - render state: the accumulation buffer, the z-buffer, the per-chunk
    completion map, the denoiser's first-hit albedo and normal where the
    render keeps them, and a fingerprint of the port's RenderConfig, the
    image size and the seed (a resumed render continues the same sample
    streams; another config, size or seed starts over);
  - train state: a dict of tensors and an optimizer's `state_dict`, in npz
    and JSON.

Every file is published by an atomic replace, so a kill mid-save leaves the
previous checkpoint whole.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch


def _cfg_fingerprint(cfg, width: int, height: int, seed: int) -> str:
    d = dataclasses.asdict(cfg)
    d.update(width=width, height=height, seed=seed)
    return json.dumps(d, sort_keys=True)


def _publish(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_render_state(path: str, accum, zbuffer, done, cfg, width, height,
                      seed, aux=None) -> None:
    """The render's (total,3) accumulation, (total,) z-buffer and per-chunk
    done map (numpy), under `path`; with `aux`, the (total,3) first-hit
    albedo and normal too."""
    os.makedirs(path, exist_ok=True)
    arrs = dict(accum=np.asarray(accum, np.float32),
                zbuffer=np.asarray(zbuffer, np.float32),
                done=np.asarray(done, bool))
    if aux is not None:
        arrs.update(albedo=np.asarray(aux[0], np.float32),
                    normal=np.asarray(aux[1], np.float32))
    _publish(os.path.join(path, "render_state.npz"),
             lambda f: np.savez_compressed(f, **arrs))
    _publish(os.path.join(path, "render_meta.json"),
             lambda f: f.write(_cfg_fingerprint(cfg, width, height,
                                                seed).encode()))


def load_render_state(path: str, cfg, width, height, seed,
                      with_aux: bool = False):
    """(accum, zbuffer, done) as numpy, or None where the checkpoint is
    absent or belongs to another config, size or seed. With with_aux, a
    fourth item: the saved (albedo, normal), or None."""
    npz = os.path.join(path, "render_state.npz")
    meta = os.path.join(path, "render_meta.json")
    if not (os.path.exists(npz) and os.path.exists(meta)):
        return None
    with open(meta) as f:
        if f.read() != _cfg_fingerprint(cfg, width, height, seed):
            return None  # another render: start over
    data = np.load(npz)
    state = (data["accum"], data["zbuffer"], data["done"])
    if not with_aux:
        return state
    aux = ((data["albedo"], data["normal"]) if "albedo" in data.files
           else None)
    return state + (aux,)


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------


def save_train_state(path: str, params: dict, opt_state: dict | None = None
                     ) -> None:
    """`params` (name -> tensor) and an optimizer's state_dict (its tensors
    in the npz, its param_groups in JSON) under `path`."""
    os.makedirs(path, exist_ok=True)
    arrs = {f"params/{k}": v.detach().cpu().numpy() for k, v in params.items()}
    groups = None
    if opt_state is not None:
        for i, st in opt_state["state"].items():
            for k, v in st.items():
                arrs[f"opt/{i}/{k}"] = (v.detach().cpu().numpy()
                                        if isinstance(v, torch.Tensor)
                                        else np.asarray(v))
        groups = opt_state["param_groups"]
    _publish(os.path.join(path, "state.npz"), lambda f: np.savez(f, **arrs))
    _publish(os.path.join(path, "state.json"),
             lambda f: f.write(json.dumps({"param_groups": groups}).encode()))


def load_train_state(path: str, device=None) -> Optional[tuple]:
    """(params, opt_state or None) as save_train_state wrote them, the
    tensors on `device` (the CPU by default); None where nothing was
    saved. The optimizer's step counts stay on the CPU, as torch keeps
    them."""
    npz = os.path.join(path, "state.npz")
    meta = os.path.join(path, "state.json")
    if not (os.path.exists(npz) and os.path.exists(meta)):
        return None
    data = np.load(npz)
    with open(meta) as f:
        groups = json.load(f)["param_groups"]
    params, state = {}, {}
    for k in data.files:
        kind, *rest = k.split("/")
        t = torch.from_numpy(data[k])
        if kind == "params":
            params[rest[0]] = t.to(device) if device is not None else t
        else:
            i, name = int(rest[0]), rest[1]
            on = device if device is not None and name != "step" else None
            state.setdefault(i, {})[name] = t.to(on) if on is not None else t
    if groups is None:
        return params, None
    for g in groups:  # JSON keeps tuples (Adam's betas) as lists
        g.update({k: tuple(v) for k, v in g.items()
                  if k != "params" and isinstance(v, list)})
    return params, {"state": state, "param_groups": groups}
