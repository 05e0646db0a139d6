"""Inverse-rendering steps (traffic kind "inverse"): step i is

    loss, grads = loss_and_grads(params, pack, cfg, cam, W, H, px, py, target,
                                 fold_in(PRNGKey(seed), i))

over every entry of trainable_params(pack, cam, include_geometry=True)
(materials, lights, camera, vertices) and all W x H pixels as lanes of one
chunk, then one torch.optim.Adam update of the diffuse table, clamped to
[0, 1] (examples/inverse_render.py). A step ends when the updated table is
on the device and synchronised. The geometry is not updated: the traces'
tables are built once.

Set-up: the scene compiled on the card, the target rendered from the true
tables with the key fold_in(PRNGKey(seed), target_key), the diffuse table
perturbed from the seed (uniform in +-perturb, clipped), the Adam state,
and the first `first_steps` steps through the same step function: the
ones the reference follows. The window then runs whole steps until
--seconds have elapsed; `train_step_ms` is its wall over its steps. With
--trace 1 the window is `trace_steps` steps under the profiler instead.

After the window, and after the program's state is freed, the reference
(portbench/reference/train.py) follows the first steps from the same
inputs, and the harness compares each step's loss, each leaf's first
gradient and the diffuse table's change element by element
(portbench/checks.py).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import checks, host, program, tracing
from portbench.loops import progressive
from portbench.loops.progressive import Result, timed_window


def perturbed_diffuse(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """The diffuse table the steps start from: the configuration's, plus
    uniform noise in +-perturb drawn from the seed, clipped."""
    true = np.array([m["diffuse"] for m in config["materials"]], np.float32)
    noise = np.random.default_rng(seed).uniform(-traffic["perturb"], traffic["perturb"],
                                                true.shape)
    lo, hi = traffic["clip"]
    return np.clip(true + noise, lo, hi).astype(np.float32)


class Run(progressive.Run):
    """One run of an inverse-rendering cell (the fields: progressive.Run)."""

    def go(self) -> Result:
        import torch

        from bhraytracer_tpu_torch.models.pathtracer import _pixels, _render_chunk
        from bhraytracer_tpu_torch.ops import rng
        from bhraytracer_tpu_torch.ops.camera import from_scene_camera
        from bhraytracer_tpu_torch.parallel.sharding import loss_and_grads, trainable_params

        tr = self.traffic
        width, height = tr["width"], tr["height"]
        dev = torch.device(self.device)
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        parts = {"start_s": self.setup_clock()}
        t0 = time.perf_counter()
        pack, cam = program.compile_scene(self.config, self.root, dev)
        cfg = program.render_config(self.config, chunk_rays=width * height, **tr["render"])
        parts["compile_scene_s"] = time.perf_counter() - t0
        parts["load_kernels_s"] = program.load_kernels(dev)
        t0 = time.perf_counter()
        cam_p = from_scene_camera(cam, dev)
        px, py = _pixels(width, height, width * height, 0, dev)
        base = rng.prng_key(self.seed, dev)
        with torch.no_grad():
            target = _render_chunk(pack, cfg, cam_p, width, height, px, py,
                                   rng.fold_in(base, tr["target_key"]))[0]
        parts["target_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        d0 = perturbed_diffuse(self.config, tr, self.seed)
        params = dict(trainable_params(pack, cam_p, include_geometry=True),
                      mtl_diffuse=torch.from_numpy(d0).to(dev))
        diffuse = params["mtl_diffuse"].clone().requires_grad_()
        opt = torch.optim.Adam([diffuse], lr=tr["lr"])

        def step(i):
            loss, grads = loss_and_grads(dict(params, mtl_diffuse=diffuse), pack, cfg, cam_p,
                                         width, height, px, py, target, rng.fold_in(base, i))
            opt.zero_grad()
            diffuse.grad = grads["mtl_diffuse"]
            opt.step()
            with torch.no_grad():
                diffuse.clamp_(0.0, 1.0)
            sync()
            return loss, grads

        losses, first = [], None
        for i in range(tr["first_steps"]):
            loss, grads = step(i)
            losses.append(float(loss))
            if i == 0:
                first = {k: g.detach().cpu() for k, g in grads.items()}
                # The diffuse gradient as the optimizer got it, from its
                # first moment after one step (none where it took no step).
                m1 = opt.state.get(diffuse, {}).get("exp_avg", torch.zeros_like(diffuse))
                first["mtl_diffuse"] = (m1 / (1.0 - opt.defaults["betas"][0])).detach().cpu()
        d_first = diffuse.detach().cpu().numpy().copy()
        parts["first_steps_s"] = time.perf_counter() - t0
        setup_s = self.setup_clock()

        def window_step(k):
            return bool(torch.isfinite(step(tr["first_steps"] + k)[0]))

        trace = None
        h0 = host.snapshot()
        if self.trace:
            t_win = time.perf_counter()
            ok, trace = tracing.traced(
                lambda: [window_step(k) for k in range(tr["trace_steps"])], sync)
            window_s = time.perf_counter() - t_win
        else:
            ok, _, window_s = timed_window(window_step, self.seconds)
        host_use = host.delta(h0, host.snapshot())
        n_steps, failed = len(ok), ok.count(False)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        del pack, params, diffuse, opt, target
        if on_card:
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        gaps, ref = self.check(losses, first, d0, d_first, dev)
        correct, chk = checks.judge([gaps], self.limits)
        notes = {"steps": n_steps, "window_s": window_s, "setup_s": setup_s, "setup_parts": parts,
                 "losses": losses, "reference_losses": ref["losses"],
                 "grad_norms": ref["grad_norms"], "grad_gap_leaves": ref["grad_gap_leaves"],
                 "grad_gap_worst": ref["grad_gap_worst"],
                 "change_elements_left_out": ref["change_elements_left_out"],
                 "reference_s": time.perf_counter() - t0, "gaps": gaps, "host": host_use}
        e2e = {"setup_s": setup_s}
        if not self.trace:
            e2e["train_step_ms"] = window_s * 1e3 / n_steps
        layer_ctx = {"kind": "inverse", "trace": trace, "units": n_steps}
        return Result(correct=correct and failed == 0, attempted=n_steps, failed=failed,
                      e2e=e2e, memory_peak_bytes=peak, checks=chk, notes=notes, trace=trace,
                      layer_ctx=layer_ctx)

    def check(self, losses, first, d0, d_first, dev):
        """The reference's first steps from the same inputs, and the
        compared numbers (checks.train_gaps)."""
        import torch

        from portbench.reference import render as ref_render
        from portbench.reference import scene as ref_scene
        from portbench.reference import train as ref_train

        tr = self.traffic
        scene = ref_scene.build_scene(self.config, self.root, dev)
        settings = ref_render.Settings(**{k: tr["render"][k] for k in (
            "gi_bounces", "extra_refr_levels", "tir_bounces", "refr_capacity")})
        r_losses, r_first, r_d = ref_train.follow(
            scene, tr["width"], tr["height"], self.seed, torch.from_numpy(d0).to(dev), tr,
            settings, len(losses))
        r_first = {k: g.cpu() for k, g in r_first.items()}
        gaps, info = checks.train_gaps(losses, r_losses, first, r_first, d_first - d0,
                                       r_d.cpu().numpy() - d0, tr["lr"])
        return gaps, dict(info, losses=r_losses)
