"""Camera basis and primary-ray generation (the port of
bhraytracer_tpu/ops/camera.py).

BeginRender's basis (Main.cpp:178-192) and PathTracing's jittered pixel
sampling (Main.cpp:132-155), including the reference's integer-division
quirk `(i + 1/2) == i`: pixel positions are corners, not centres; and the
thin-lens eye jitter of depth of field (viewport.cpp:238-243).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bhraytracer_tpu_torch.ops.linalg import cross, norm, normalize


class CameraParams(NamedTuple):
    pos: torch.Tensor  # (3,)
    dir: torch.Tensor  # (3,) orthonormal with up (xmlload.cpp:124-127)
    up: torch.Tensor  # (3,)
    fov: torch.Tensor  # () degrees
    focaldist: torch.Tensor  # ()
    # Thin-lens aperture radius (scene.h:518 `dof`); only renders with
    # cfg.use_dof read it, as the reference's integrator never does.
    dof: torch.Tensor | float = 0.0


def from_scene_camera(cam, device=None) -> CameraParams:
    """The camera's tensors on `device`: the card unless the caller asks
    for the CPU (scene/pack.py:resolve_device, which raises where no card
    exists)."""
    from bhraytracer_tpu_torch.scene.pack import resolve_device

    device = resolve_device(device)

    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return CameraParams(pos=f(cam.pos), dir=f(cam.dir), up=f(cam.up),
                        fov=f(cam.fov), focaldist=f(cam.focaldist),
                        dof=f(getattr(cam, "dof", 0.0)))


def camera_basis(cam: CameraParams, width: int, height: int):
    """(top_left, dd_x, dd_y) as Main.cpp:179-192."""
    aor = width / float(height)
    # The reference's PI macro is 3.14159265 (Main.cpp:39).
    tan_h = torch.tan(cam.fov / 2.0 * 3.14159265 / 180.0)
    ell = cam.focaldist
    h = 2.0 * ell * tan_h
    w = aor * h
    cam_z = -cam.dir
    cam_y = cam.up
    cam_x = cross(cam_y, cam_z)
    top_left = cam.pos - cam_z * ell + cam_y * (h / 2.0) - cam_x * (w / 2.0)
    return top_left, cam_x * (w / width), cam_y * (h / height)


def gen_rays(cam: CameraParams, width: int, height: int, px, py, u):
    """Jittered primary rays for pixel columns px, rows py and (N,2) jitter
    uniforms u; directions are unnormalised (t = 1 at the image plane).
    With (N,4) uniforms, columns 2-3 also jitter the eye over the aperture
    disc of radius cam.dof, in the (dir x up, up) plane; the target stays
    on the focal plane, so objects there render sharp."""
    top_left, dd_x, dd_y = camera_basis(cam, width, height)
    center = (top_left[None, :] + px[:, None].float() * dd_x[None, :]
              - py[:, None].float() * dd_y[None, :])
    pixel_len = norm(dd_x)
    jitter = (normalize(dd_x)[None, :]
              * ((u[:, 0] * 2.0 - 1.0) * pixel_len / 2.0)[:, None]
              + normalize(dd_y)[None, :]
              * ((u[:, 1] * 2.0 - 1.0) * pixel_len / 2.0)[:, None])
    target = center + jitter
    if u.shape[1] >= 4:
        cam_x = cross(cam.up, -cam.dir)  # == dir x up (the reference's v)
        r = torch.sqrt(u[:, 2]) * cam.dof
        a = u[:, 3] * 2.0 * torch.pi
        o = (cam.pos[None, :] + (r * torch.cos(a))[:, None] * cam_x[None, :]
             + (r * torch.sin(a))[:, None] * cam.up[None, :])
        return o, target - o
    return cam.pos.expand(target.shape), target - cam.pos
