"""The plain reference of the inverse-rendering step: the image loss of
the reference renderer (reference/render.py) over every pixel of one
chunk, its gradients by autograd, and a plain Adam update of the diffuse
table clamped to [0, 1].

The estimator is the one the renderer specifies for gradients: hits are
found on detached rays (discrete), and every continuous quantity of the
hit (t, the point, the normal's barycentric weights) is worked out again
from the scene's tensors, so that gradients reach the materials, the
lights, the camera and the mesh's vertices.

Leaves, by the names the benchmark compares them under: mtl_diffuse,
mtl_specular, mtl_gloss, mtl_refraction, mtl_absorption, light_intensity,
light_vec, cam_pos, cam_dir, cam_up, verts.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import render as R
from portbench.reference import threefry as tf

LEAVES = {"mtl_diffuse": "diffuse", "mtl_specular": "specular", "mtl_gloss": "gloss",
          "mtl_refraction": "refraction", "mtl_absorption": "absorption",
          "light_intensity": "light_intensity", "light_vec": "light_vec",
          "cam_pos": "cam_pos", "cam_dir": "cam_dir", "cam_up": "cam_up", "verts": "verts"}
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def radiance(scene, width, height, key, settings, tracer):
    """(N,3) radiance of the chunk of every pixel keyed `key` (camera
    jitter fold_in(key, 0), shade tree fold_in(key, 1)), no escalation."""
    r = R.Renderer(scene, width, height, tracer=tracer)
    rad, stats = r.chunk(key, settings)
    return rad, stats


def follow(scene, width, height, seed: int, d0, traffic: dict, settings, steps: int,
           lanes=None):
    """The reference's first `steps` steps from the diffuse table d0: (the
    losses, the first step's gradients {leaf: tensor}, the diffuse table
    after the steps). `lanes` (a slice), where given, is the lanes the loss
    takes its mean over (a fault the check must catch); all by default."""
    tracer = R.Tracer(scene)
    base = tf.prng_key(seed, scene.device)
    with torch.no_grad():
        target, _ = radiance(scene, width, height, tf.fold_in(base, traffic["target_key"]),
                             settings, tracer)
    d = d0.clone()
    m = torch.zeros_like(d)
    v = torch.zeros_like(d)
    losses, first = [], None
    for i in range(steps):
        leaves = {k: getattr(scene, f).detach().clone().requires_grad_() for k, f in LEAVES.items()}
        leaves["mtl_diffuse"] = d.detach().clone().requires_grad_()
        sc = dataclasses.replace(scene, **{LEAVES[k]: x for k, x in leaves.items()})
        rad, _ = radiance(sc, width, height, tf.fold_in(base, i), settings, tracer)
        sel = slice(None) if lanes is None else lanes
        loss = torch.mean((rad[sel] - target[sel]) ** 2)
        names = list(leaves)
        gs = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, gs)}
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        g = grads["mtl_diffuse"].detach()
        t = i + 1
        m = BETA1 * m + (1.0 - BETA1) * g
        v = BETA2 * v + (1.0 - BETA2) * g * g
        step = traffic["lr"] * (m / (1.0 - BETA1 ** t)) / (torch.sqrt(v / (1.0 - BETA2 ** t)) + EPS)
        d = torch.clamp(d - step, 0.0, 1.0)
    return losses, first, d
