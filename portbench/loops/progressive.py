"""Progressive passes (traffic kind "progressive"): pass k is the frame's
one sample at offset k,

    render_image(pack, camera, cfg, seed=<seed>, return_aux=True, sample_offset=k)

with the whole frame in one chunk, and the pass ends when its image is on
the host. The window runs whole passes, k = 0, 1, 2, ..., until
--seconds have elapsed, and `samples_per_s` is the pixel samples of all of
them over the window's wall. A pass fails where it still drops lanes after
render_image's escalations.

Set-up: the scene compiled from the configuration on the card (the BVH
and cluster tables), the kernels loaded (built into the checkout's build/
on a first run), and `warm_passes` passes at an offset the window never
reaches. With --trace 1 the window is `trace_passes` passes under the
profiler instead.

After the window, and after the program's state is freed, `check_passes`
passes drawn from the seed are rendered again by the plain reference
(portbench/reference/) and compared, each pass by itself and the
refraction pixels over all of them (portbench/checks.py).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench import checks, host, program, tracing

WARM_OFFSET = 1 << 30  # the warm passes' sample offsets start here


def timed_window(unit, seconds: float, clock=time.perf_counter):
    """Run unit(k) for k = 0, 1, ... until `seconds` have elapsed since
    the first began, whole units only: (the units' results, each unit's
    wall, the window's wall from the first unit's start to the last's
    end). A rate over the window is units over that wall, so a stalled
    unit counts in full."""
    out, walls = [], []
    t_win = clock()
    k = 0
    while True:
        t0 = clock()
        out.append(unit(k))
        t1 = clock()
        walls.append(t1 - t0)
        k += 1
        if t1 - t_win >= seconds:
            return out, walls, t1 - t_win


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    e2e: dict
    memory_peak_bytes: int
    checks: dict
    notes: dict
    trace: object = None
    layer_ctx: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """One run of a cell: its files, the run's arguments, the clock of
    the process's age, and the device (a test may give the CPU)."""

    root: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    setup_clock: object
    device: str = "cuda"

    def go(self) -> Result:
        import torch

        from bhraytracer_tpu_torch.models.pathtracer import render_image

        tr = self.traffic
        width, height = tr["width"], tr["height"]
        dev = torch.device(self.device)
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        parts = {"start_s": self.setup_clock()}
        t0 = time.perf_counter()
        pack, cam = program.compile_scene(self.config, self.root, dev)
        cam.width, cam.height = width, height
        cfg = program.render_config(self.config, chunk_rays=width * height, **tr["render"])
        parts["compile_scene_s"] = time.perf_counter() - t0
        parts["load_kernels_s"] = program.load_kernels(dev)
        t0 = time.perf_counter()

        def one_pass(k):
            img, aux = render_image(pack, cam, cfg, seed=self.seed, return_aux=True,
                                    sample_offset=k)
            return img.cpu().numpy(), aux

        for j in range(tr["warm_passes"]):
            one_pass(WARM_OFFSET + j)
        sync()
        parts["warm_passes_s"] = time.perf_counter() - t0
        setup_s = self.setup_clock()

        trace, walls = None, []
        h0 = host.snapshot()
        if self.trace:
            t_win = time.perf_counter()
            passes, trace = tracing.traced(
                lambda: [one_pass(k) for k in range(tr["trace_passes"])], sync)
            window_s = time.perf_counter() - t_win
        else:
            passes, walls, window_s = timed_window(one_pass, self.seconds)
        host_use = host.delta(h0, host.snapshot())
        images = [img for img, _ in passes]
        segs = [aux["traced_segments"] for _, aux in passes]
        drops = [sum(aux["dropped_lanes"].values()) for _, aux in passes]
        n = len(images)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        del pack
        if on_card:
            torch.cuda.empty_cache()

        gaps, ref_s, ref_stats, counts = self.check(images, dev)
        correct, chk = checks.judge(gaps, self.limits)
        failed = sum(1 for x in drops if x)
        notes = {"passes": n, "window_s": window_s, "setup_s": setup_s, "setup_parts": parts,
                 "pass_walls_s": walls, "segments": segs, "reference_s": ref_s,
                 "reference_stats": ref_stats, "gaps": gaps, "host": host_use}
        e2e = {"setup_s": setup_s}
        if not self.trace:
            e2e["samples_per_s"] = n * width * height / window_s
        layer_ctx = {"kind": "progressive", "trace": trace, "units": n,
                     "pixels": width * height, "segments": sum(segs),
                     "scene_counts": counts}
        return Result(correct=correct and failed == 0, attempted=n, failed=failed, e2e=e2e,
                      memory_peak_bytes=peak, checks=chk, notes=notes, trace=trace,
                      layer_ctx=layer_ctx)

    def check(self, images, dev):
        """The compared numbers of `check_passes` passes drawn from the
        seed, each against the reference's render of the same pass, and
        the refraction pixels' number over all of them."""
        import torch

        from portbench.reference import render as ref_render
        from portbench.reference import scene as ref_scene

        t0 = time.perf_counter()
        rng = np.random.default_rng(self.seed)
        picks = rng.choice(len(images), size=min(self.traffic["check_passes"], len(images)),
                           replace=False)
        scene = ref_scene.build_scene(self.config, self.root, dev)
        r = ref_render.Renderer(scene, self.traffic["width"], self.traffic["height"])
        settings = ref_render.Settings(**self.config["render"])
        gaps, stats, refs, masks = [], [], [], []
        for k in sorted(int(x) for x in picks):
            with torch.no_grad():
                img, st = r.render_pass(self.seed, k, settings)
            involved = st.pop("involved").cpu().numpy()
            refs.append(img.cpu().numpy())
            masks.append(involved)
            gaps.append(checks.image_gaps(images[k], refs[-1], involved))
            stats.append(dict(st, passes=k, involved_share=float(involved.mean())))
        z2, tiles = checks.refraction_z2([images[k] for k in sorted(int(x) for x in picks)],
                                         refs, masks, self.traffic["refr_tile"])
        gaps.append({"refr_tile_z2": z2})
        stats.append({"refr_tiles": tiles})
        counts = (scene.faces.shape[0], scene.sph.shape[0], scene.pln.shape[0])
        return gaps, time.perf_counter() - t0, stats, counts
