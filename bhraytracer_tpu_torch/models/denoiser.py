"""The learned denoiser (the port of bhraytracer_tpu/models/denoiser.py), in
place of the reference's OIDN filter (DenoiseImage, Main.cpp:60-95: colour
in, colour out, optional albedo and normal auxiliaries).

A small convolutional U-Net: two 3x3 convolutions with ReLU at each encoder
width, 2x2 average pooling after each, a bottleneck convolution, nearest x2
upsampling with a skip concatenation and a convolution at each decoder
width, and a 3-channel output convolution added to the input colour. Its
convolutions are `torch.nn.functional.conv2d` (the reference's are flax
`nn.Conv`, XLA outside any Pallas kernel). Images are (H, W, C) at the API,
as in the reference; the module computes in NCHW.

Weights carry across from the reference's npz layout (`save_weights` /
`load_weights`): keys `params/Conv_i/kernel` (3, 3, in, out) and
`params/Conv_i/bias`, the convolutions numbered in creation order, plus
`__aux_channels__` and `__features__`. The shipped weights
(`denoiser_weights.npz`, beside this module) are a copy of the reference's.
On the card, cuDNN computes the convolutions in TF32 while
`torch.backends.cudnn.allow_tf32` is on (PyTorch's default); this module
sets no global flag, so a caller that compares with float32 turns it off.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_PRETRAINED = "denoiser_weights.npz"


class DenoiserUNet(nn.Module):
    """U-Net-lite: 2 downsamples, skip connections, residual output.
    `convs[i]` is the reference's `Conv_i`."""

    def __init__(self, features: Sequence[int] = (16, 32, 64),
                 aux_channels: int = 0):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.aux_channels = int(aux_channels)
        convs, cin = [], 3 + self.aux_channels
        for f in self.features[:-1]:
            convs += [nn.Conv2d(cin, f, 3, padding=1),
                      nn.Conv2d(f, f, 3, padding=1)]
            cin = f
        convs.append(nn.Conv2d(cin, self.features[-1], 3, padding=1))
        cin = self.features[-1]
        for f in reversed(self.features[:-1]):
            convs.append(nn.Conv2d(cin + f, f, 3, padding=1))
            cin = f
        convs.append(nn.Conv2d(cin, 3, 3, padding=1))
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        """x: (B, H, W, 3 + aux), H and W divisible by 4 -> (B, H, W, 3)."""
        color = x[..., :3]
        h = x.permute(0, 3, 1, 2)
        convs = iter(self.convs)
        skips = []
        for _ in self.features[:-1]:
            h = F.relu(next(convs)(h))
            h = F.relu(next(convs)(h))
            skips.append(h)
            h = F.avg_pool2d(h, 2)
        h = F.relu(next(convs)(h))
        for skip in reversed(skips):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = F.relu(next(convs)(torch.cat([h, skip], 1)))
        delta = next(convs)(h)
        # Residual: a correction to the noisy colour.
        return color + delta.permute(0, 2, 3, 1)


def init_denoiser(generator: torch.Generator, aux_channels: int = 0,
                  features: Sequence[int] = (16, 32, 64)) -> DenoiserUNet:
    """A fresh model, initialised as flax's nn.Conv is: kernels from a
    truncated normal of variance 1 / fan_in (lecun_normal), biases 0,
    drawn from `generator`."""
    model = DenoiserUNet(features, aux_channels)
    with torch.no_grad():
        for conv in model.convs:
            fan_in = conv.in_channels * 9
            # lecun_normal's truncated normal, rescaled to unit variance.
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, std=std, a=-2.0 * std,
                                  b=2.0 * std, generator=generator)
            conv.bias.zero_()
    return model


def _device_of(model: DenoiserUNet) -> torch.device:
    return next(model.parameters()).device


def _pad4(x):
    """Edge-pad (..., H, W, C) to H and W multiples of 4: (x, H, W)."""
    h, w = x.shape[-3:-1]
    ph, pw = (-h) % 4, (-w) % 4
    if ph or pw:
        lead = x.shape[:-3]
        y = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
        y = F.pad(y, (0, pw, 0, ph), mode="replicate")
        x = y.permute(0, 2, 3, 1).reshape(lead + (h + ph, w + pw,
                                                  x.shape[-1]))
    return x, h, w


def _as_input(model: DenoiserUNet, x):
    """x as float32 on the model's device: a numpy array is copied there; a
    tensor must already be there."""
    dev = _device_of(model)
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    if x.device != dev:
        raise ValueError(f"denoiser on {dev}, input on {x.device}: put both "
                         "on one device")
    return x.float()


def denoise(model: DenoiserUNet, img, aux=None) -> torch.Tensor:
    """Denoise an (H, W, 3) image, with (H, W, aux_channels) aux when the
    model takes them (OIDN's filter.execute); on the model's device."""
    x = _as_input(model, img)[None]
    if aux is not None:
        x = torch.cat([x, _as_input(model, aux)[None]], -1)
    x, h, w = _pad4(x)
    with torch.no_grad():
        out = model(x)
    return out[0, :h, :w]


def train_denoiser(model: DenoiserUNet, noisy, clean, steps: int = 200,
                   lr: float = 1e-3, batch: int = 4, seed: int = 0,
                   weights: Optional[np.ndarray] = None) -> list:
    """Self-supervised training on (low-spp, high-spp) render pairs, noisy
    (N, H, W, 3+aux) and clean (N, H, W, 3), with Adam in place: each step
    draws `batch` pairs with np.random.default_rng(seed).integers, as the
    reference does. `weights` (N,) rebalances the per-pair MSE so that one
    noisy scene cannot dominate the loss. Returns the losses."""
    noisy, _, _ = _pad4(_as_input(model, noisy))
    clean, _, _ = _pad4(_as_input(model, clean))
    w = (torch.ones(noisy.shape[0], device=noisy.device) if weights is None
         else _as_input(model, weights))
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, noisy.shape[0],
                                            size=batch)).to(noisy.device)
        pred = model(noisy[idx])
        per = ((pred - clean[idx]) ** 2).mean((1, 2, 3))
        loss = (per * w[idx]).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses


def save_weights(model: DenoiserUNet, path: str) -> None:
    """The model's weights in the reference's npz layout (atomic replace)."""
    arrs = {}
    for i, conv in enumerate(model.convs):
        arrs[f"params/Conv_{i}/bias"] = conv.bias.detach().cpu().numpy()
        arrs[f"params/Conv_{i}/kernel"] = (
            conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy())
    arrs["__aux_channels__"] = np.int32(model.aux_channels)
    arrs["__features__"] = np.asarray(model.features, np.int32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_weights(path: str, device=None) -> DenoiserUNet:
    """Inverse of save_weights, and the reader of the reference's files:
    (3, 3, in, out) kernels become torch's (out, in, 3, 3). On `device`:
    the card unless the caller asks for the CPU (scene/pack.py:
    resolve_device, which raises where no card exists)."""
    from bhraytracer_tpu_torch.scene.pack import resolve_device

    device = resolve_device(device)
    data = np.load(path)
    feats = (tuple(int(x) for x in data["__features__"])
             if "__features__" in data.files else (16, 32, 64))
    model = DenoiserUNet(feats, int(data["__aux_channels__"]))
    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            k = torch.from_numpy(data[f"params/Conv_{i}/kernel"])
            conv.weight.copy_(k.permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(data[f"params/Conv_{i}/bias"]))
    return model.to(device)


def load_pretrained(device=None) -> DenoiserUNet:
    """The shipped weights (features (24, 48, 96), albedo and normal aux),
    on `device`: the card unless the caller asks for the CPU, as
    scene/pack.py:resolve_device."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        _PRETRAINED)
    return load_weights(path, device)


def render_training_pairs(pack, camera, base_cfg, n_pairs: int = 4,
                          noisy_spp: int = 2, clean_spp: int = 64,
                          seed: int = 0, with_aux: bool = False):
    """(noisy, clean) numpy stacks of renders of one scene, seeds
    seed + 1000 + i and seed + 2000 + i; with with_aux the noisy images gain
    the first-hit albedo and normal channels (Main.cpp:68-77)."""
    import dataclasses

    from bhraytracer_tpu_torch.models.pathtracer import render_image

    noisy, clean = [], []
    for i in range(n_pairs):
        cfg_n = dataclasses.replace(base_cfg, spp=noisy_spp, use_gamma=False)
        cfg_c = dataclasses.replace(base_cfg, spp=clean_spp, use_gamma=False)
        if with_aux:
            img, aux = render_image(pack, camera, cfg_n, seed=seed + 1000 + i,
                                    return_aux=True)
            noisy.append(np.concatenate(
                [img.cpu().numpy(), aux["albedo"], aux["normal"]], -1))
        else:
            noisy.append(render_image(pack, camera, cfg_n,
                                      seed=seed + 1000 + i).cpu().numpy())
        clean.append(render_image(pack, camera, cfg_c,
                                  seed=seed + 2000 + i).cpu().numpy())
    return np.stack(noisy), np.stack(clean)
