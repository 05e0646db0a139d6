#!/usr/bin/env python3
"""Smoke test of bhraytracer_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc and g++. It builds the CUDA kernels (one nvcc
per source, in parallel) and the host helper from the checkout's sources;
holds each of the ten kernels against its plain PyTorch twin on the card
at the main paths' shapes (480,000 lanes); holds the culling flat closest
kernel (1) to its twin key for key on the closest calls a bench frame and
a textured32 frame make (the chain trips and the levels) and on a
synthetic 8192-face mesh, the culling flat any-hit kernel (2) bit for bit
on those frames' shadow calls (levels >= 1), each with per-ray cull
counts and timed beside the BVH kernel on the same rays, kernel 3 with
its device time, registers, occupancy and the launches of one shade
step, kernels 4 and 5 on the bench scene's level-0 rays and on the
textured32 frame's level-0 calls (every lane against the brute-force
twin) with their results and per-ray box and triangle test counts equal
to `bvh_walk_ref`'s on 16,384-lane subsets and with their device times,
registers and occupancy, kernel 8 at the photon build's 32,768 lanes,
kernel 9 on a photon frame's shadow calls, and kernels 1, 2 and 4-9 on
tables of 40 spheres and 40 planes; renders the scenes beyond the fused
shade kernel's tables (scenes.LIMIT_SCENES, and one with a photon map) on
the card against the CPU, and traces and renders a 204,800-face mesh
through the BVH route; times both level-0 routes (BVH and stream) on the
same rays; renders the five main paths through
`render_image`, each once to warm and once timed with the kernels' launch
counters set to 0 just before it (and the device memory's peak over it):
the bench scene (1,408 faces) at 800x600 with bench.py's headline config,
the big-mesh scene (111,616 faces) with bench.py's `_bigmesh_leg` config,
the mesh-free tiny scene with the caustic photon map (`_photon_leg`'s
config, the map built first by `build_photon_map`), and the textured scene
(data/textured.xml through `load_scene`: checker, wood and china texture
maps, a textured background and environment) with `_textured_leg`'s config
(spp 4, one level, 1 filter tap) and with the headline's six levels at the
default 32 taps; checks the images, a 64x48 render of the small scenes and
of the textured scene (the photon render with one map carried to both) and
a 32x24 render of the big-mesh scene and of the textured scene with a
photon map against the CPU twins; runs the inverse-rendering path (the
bench scene at 1024x1024 through one differentiable _render_chunk: a
target, one value_and_grad over the trainable parameters with its
forward and backward times, launches, syncs and peak memory, then 5 Adam
steps that must lower the loss and the diffuse error; kernels 1, 2, 4
and 5 held against their twins on every trace call of its forward),
times the gradient of the textured scene at 1024x1024 with 32 filter
taps, and holds the card's gradients and radiance to the CPU's on the two
finite-difference setups of the JAX tests and on the photon scene; runs
the finished render (the bench scene at 800x600 with HEADLINE, 4 adaptive
samples on the 15% highest-contrast pixels, the aux outputs and the
shipped denoiser: base pass, adaptive pass and denoise timed, launches,
peak memory; kernels 1, 2, 4 and 5 held against their twins on every
trace call of its adaptive pass), the same with 2 adaptive samples at
64x48 on the card against the CPU (the bench scene and the photon scene,
radiance, z-buffer, sample counts and the denoised image), and the
command line (`python -m bhraytracer_tpu_torch render` of the textured
scene at 800x600 with 2 adaptive samples, a z-buffer and a checkpoint,
twice: the resumed run writes the same bytes); runs the data-parallel
path (parallel/): a world of one rank over NCCL in this process
(init_multihost with a local coordinator, make_mesh) renders the bench
scene at 800x600 with HEADLINE through render_image_distributed (timed
against render_image, launch counts, peak memory; kernels 1, 2, 4 and 5
against their twins on every trace call of the frame and kernel 3 on
every shade setup) and takes one train_step_sharded of the inverse path
at 1024x1024 (timed against train_step; its loss and gradients against
train_step's on the same inputs; its lane frames' count exchanges
counted and timed), with the all-gather's and the all-reduce's times and
the dryrun_multichip counterpart on tiny_scene; then a world of two child
processes sharing the card over gloo (their gathered radiance of the frame
equal to one process's render of each half with the same folded keys,
their reduced loss and gradients those of one process's train_step within
GRAD_RTOL / GRAD_ATOL: a sharded step does not depend on the world size)
and, beside it, a world of two over gloo on the CPU (the 64x48 image of
the card's world within 1e-4 on 99% of pixels, stats equal); and prints
the card, the numbers and one JSON line per result. The last line is the device line. Any failed check,
a child rank's included, raises and the script exits non-zero; so does a
run without a CUDA card or outside a checkout.

    python3 chip_smoke.py --profile [bench] [bigmesh] [photon] [textured]
                                    [textured32]

builds the kernels and profiles one warm frame of each named main path
(all by default) with torch.profiler instead (launches, device busy time,
kernels by device time, host operators by CPU time, the texture lookups'
device time), writing the tables under chiprun_out/. The photon frame
gathers from a map built before it.

    python3 chip_smoke.py --frames N [bench] [bigmesh] [photon] [textured]
                                     [textured32]

builds the kernels and times N frames of each named main path after one
warm frame (host clock around each frame, ending in a synchronise), one
JSON line per frame; a photon frame builds its map first and prints the
build's time beside the frame's. For bench and bigmesh these two modes
read only `<name>_scene` and `render_image`, so a copy of this script
placed in an older checkout times or profiles that checkout.

    python3 chip_smoke.py --inverse

builds the kernels and runs only the inverse-rendering path (1024x1024 on
the bench scene: a value_and_grad with its forward and backward times,
launches, syncs and peak memory, then 5 Adam steps, and the checks of
its trace calls), the textured gradient and the card-vs-CPU gradient
comparisons of the default run.

    python3 chip_smoke.py --finish

builds the kernels and runs only the finished render's three checks of
the default run (800x600 with its trace calls, card against CPU, the
command line).

    python3 chip_smoke.py --distributed

builds the kernels and runs only the data-parallel phase of the default
run (world 1 over NCCL, world 2 on the card and on the CPU over gloo).
Its world-2 ranks are this script run as `--dist-rank RANK WORLD ADDRESS
DEVICE OUT`, a mode for the phase alone.

    python3 chip_smoke.py --textured-gradient

builds the kernels and times only the textured scene's 1024x1024
gradient (forward, backward, peak memory).

    python3 chip_smoke.py --save-inputs PATH
    python3 chip_smoke.py --timing PATH

    python3 chip_smoke.py --kernel9 N

builds the kernels and holds kernel 9 to its twin on the tiny scene's
480K level-0 shadow rays and on a photon frame's shadow calls, then takes
its device time on each N times: one JSON line with every value, the
medians, the bounds and the bounds' shares. It reads only APIs older
checkouts have, so a copy of this script in one times that checkout's
kernel 9 on the same rays.

The first writes the inputs of kernels 1-5 and 7-9 at the shapes their
main paths give them (480K scattered bench rays, the closest and shadow
calls of a bench frame, a synthetic 8192-face mesh; the bench scene's
level-0 lanes and shadow rays; the big-mesh scene's level-0 camera and
shadow rays and its scattered rays, sorted and not; the tiny scene's rays
at 480K and at the photon build's 32,768 lanes, its level-0 shadow rays
and a photon frame's shadow calls) to PATH; the second times each kernel
on them, through its wrapper and on the device, with the registers,
stack and occupancy of the shade and BVH kernels and the launches of one
shade step. `--timing` reads only APIs that older checkouts have too (the
BVH kernels on the node table the checkout's wrapper reads), so a copy of
this script placed in one times that checkout's kernels on the same
inputs.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LANES = 480000
SUBSET = 16384  # lanes the brute-force twins check on the big-mesh scene
CLUSTER_SIZES = (32, 64, 128)  # faces a cluster, held and timed in compare_hbm
TILE_SIZES = (32, 64, 128)  # photons a tile, held and timed in compare_photon
DENSE = 4000  # photons in range of a lane near the focus (the sweep's tail)
PHOTON_BATCH_LANES = 1 << 15  # a photon build round (the JAX default batch)
# Small renders of the limit scenes: tests/test_torch_render.py's config.
SMALL = dict(spp=1, gi_bounces=1, extra_refr_levels=1, tir_bounces=4)
# Headline config of bench.py:167-176, less fused_levels (a TPU knob);
# texture_sample_count=1 changes nothing on the untextured scenes.
HEADLINE = dict(spp=1, gi_bounces=3, extra_refr_levels=2, tir_bounces=16,
                chunk_rays=480000, refr_capacity=0.08, texture_sample_count=1)
# bench.py:473-475 (_bigmesh_leg), less the same two knobs.
BIGMESH = dict(spp=1, gi_bounces=1, extra_refr_levels=1, tir_bounces=8,
               chunk_rays=480000)
# bench.py:426-430 (_photon_leg) on tiny_scene, with one 480,000-lane chunk
# (its 65,536 was a TPU compile workaround) and the gather's defaults (k
# 1000, radius 0.5). Its map is built as render_image builds it: seed 1,
# build_photon_map's default batch.
PHOTON = dict(spp=1, gi_bounces=3, extra_refr_levels=2, tir_bounces=16,
              chunk_rays=480000, use_photon_map=True, photon_count=1 << 17)
# bench.py:412-419 (_textured_leg), less fused_levels, on the port's
# textured scene (data/textured.xml through load_scene), with one
# 480,000-lane chunk; and HEADLINE's six levels at spp 1 with the default
# 32-tap texture filter.
TEXTURED = dict(spp=4, gi_bounces=0, extra_refr_levels=0, tir_bounces=16,
                chunk_rays=480000, texture_sample_count=1)
TEXTURED32 = dict(HEADLINE, texture_sample_count=32)
# Inverse rendering: BASELINE.json's 1024x1024 target on the bench scene,
# with tests/test_gradients.py:61-64's config (examples/inverse_render.py:
# 51-54); all 1,048,576 lanes in one _render_chunk, as train_step_sharded
# takes them; 5 Adam steps at examples/inverse_render.py's rate.
INVERSE = dict(spp=1, gi_bounces=1, extra_refr_levels=0, tir_bounces=2,
               texture_sample_count=1, differentiable=True)
INVERSE_SIZE, INVERSE_STEPS, INVERSE_LR = 1024, 5, 5e-2
# The finished render: the bench scene with HEADLINE, 4 adaptive samples on
# the 15% highest-contrast pixels (72,000 pixels, one 72,704-lane chunk a
# sample), the aux outputs and the shipped denoiser; and its card-vs-CPU
# check at FINISH_SIZE on SMALL with 2 adaptive samples.
FINISH = dict(HEADLINE, adaptive_spp=4, adaptive_fraction=0.15,
              use_denoiser=True)
FINISH_SMALL = dict(SMALL, adaptive_spp=2, adaptive_fraction=0.15)
FINISH_SIZE = (64, 48)
# Gradients on the card against the CPU: |g_gpu - g_cpu| <= GRAD_RTOL *
# max|g_cpu| + GRAD_ATOL per parameter. The hit ids are equal (kernel ==
# twin), so the two differ by the order of float sums (the backward's
# scatter-adds are atomic on the card) and by the ulps of CUDA's and the
# CPU's transcendental functions: the tolerance of the port against the
# JAX package (tests/test_torch_gradients.py). GRAD_ATOL stays far below
# the smallest nonzero gradient (the atlas's, 5.6e-6 at most), so the
# relative term decides; measured (H100): 3.0e-5 of max|g| at worst.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-9
# The distributed phase (parallel/): world 1 over NCCL in this process;
# world DIST_WORLD as child processes sharing the one card over gloo (NCCL
# refuses two ranks on one GPU, and the two time-slice the card: their
# walls are correctness runs, not scaling) and the same over gloo on the
# CPU. DRYRUN is __graft_entry__.dryrun_multichip's config
# (__graft_entry__.py:126-129), DRYRUN_LANES its lanes a rank; the
# collectives are timed over COLLECTIVE_REPS calls.
DIST_WORLD = 2
DRYRUN = dict(spp=1, gi_bounces=1, extra_refr_levels=0, tir_bounces=2,
              chunk_rays=64, texture_sample_count=1, differentiable=True)
DRYRUN_LANES = 16
COLLECTIVE_REPS = 20
# name -> (scene function of bhraytracer_tpu_torch.scenes, config)
PATHS = {"bench": ("bench_scene", HEADLINE),
         "bigmesh": ("bigmesh_scene", BIGMESH),
         "photon": ("tiny_scene", PHOTON),
         "textured": ("textured_scene", TEXTURED),
         "textured32": ("textured_scene", TEXTURED32)}

KERNELS = {
    "bhrt_stream_closest": dict(
        name="stream_closest", source="bhraytracer_tpu_torch/csrc/stream.cu",
        replaces="bhraytracer_tpu/ops/pallas_stream.py:415"),
    "bhrt_stream_anyhit": dict(
        name="stream_anyhit", source="bhraytracer_tpu_torch/csrc/stream.cu",
        replaces="bhraytracer_tpu/ops/pallas_stream.py:462"),
    "bhrt_shade_setup": dict(
        name="shade_setup", source="bhraytracer_tpu_torch/csrc/shade.cu",
        replaces="bhraytracer_tpu/ops/pallas_shade.py:593"),
    "bhrt_bvh_closest": dict(
        name="bvh_closest", source="bhraytracer_tpu_torch/csrc/bvh.cu",
        replaces="bhraytracer_tpu/ops/pallas_bvh.py:335"),
    "bhrt_bvh_anyhit": dict(
        name="bvh_anyhit", source="bhraytracer_tpu_torch/csrc/bvh.cu",
        replaces="bhraytracer_tpu/ops/pallas_bvh.py:519"),
    "bhrt_stream_closest_hbm": dict(
        name="stream_closest_hbm",
        source="bhraytracer_tpu_torch/csrc/stream_hbm.cu",
        replaces="bhraytracer_tpu/ops/pallas_stream_hbm.py:295"),
    "bhrt_stream_anyhit_hbm": dict(
        name="stream_anyhit_hbm",
        source="bhraytracer_tpu_torch/csrc/stream_hbm.cu",
        replaces="bhraytracer_tpu/ops/pallas_stream_hbm.py:342"),
    "bhrt_analytic_closest": dict(
        name="analytic_closest",
        source="bhraytracer_tpu_torch/csrc/analytic.cu",
        replaces="bhraytracer_tpu/ops/pallas_trace.py:149"),
    "bhrt_analytic_anyhit": dict(
        name="analytic_anyhit",
        source="bhraytracer_tpu_torch/csrc/analytic.cu",
        replaces="bhraytracer_tpu/ops/pallas_trace.py:240"),
    "bhrt_photon_sweep": dict(
        name="photon_sweep", source="bhraytracer_tpu_torch/csrc/photon.cu",
        replaces="bhraytracer_tpu/ops/pallas_photon.py:211"),
}
# The __global__ functions of csrc/, as the profiler names them.
PORT_KERNEL_FUNCTIONS = ("cull_closest_kernel", "cull_anyhit_kernel",
                         "shade_kernel", "bvh_closest_kernel",
                         "bvh_anyhit_kernel", "analytic_closest_kernel",
                         "analytic_anyhit_kernel", "photon_sweep_kernel")
FLAT = ("bhrt_stream_closest", "bhrt_stream_anyhit")
BVH = ("bhrt_bvh_closest", "bhrt_bvh_anyhit")
HBM = ("bhrt_stream_closest_hbm", "bhrt_stream_anyhit_hbm")
ANALYTIC = ("bhrt_analytic_closest", "bhrt_analytic_anyhit")

# Published H100 SXM peaks: float32 outside the
# tensor cores, and HBM bandwidth.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# Operations per test, counted from the formulas in csrc/ (multiplies,
# adds, divides, square roots and compares); a triangle test counts only
# the plane test every test runs before its early exit.
TRI_TEST_OPS = 16  # n.d, |pd| = tdiv * inv_nlen * inv_dlen, n.o, t, compares
BOX_TEST_OPS = 25  # slab test: 6 sub, 6 mul, 10 min/max, 3 compares
SPHERE_OPS = 67  # local ray 33, quadratic 22, roots and selects 12
PLANE_OPS = 45  # local ray 33, t 2, extent and side 10
# A photon pair test: difference 3, squared distance 5, compare 1.
PAIR_OPS = 9
# BVH calls of a frame timed one by one (compare_bvh_calls): the finished
# render's adaptive pass makes 12 of each kind, 4 a try.
TIMED_CALLS = 4


def render_config(cfg_kw):
    """RenderConfig(**cfg_kw). Only in a checkout from before texture maps,
    whose RenderConfig has no texture_sample_count (a field that changes
    nothing on the untextured scenes), is that one field left out, so that
    --timing, --frames and --profile of the untextured paths still run from
    a copy of this script placed in one; any other unknown field raises."""
    import dataclasses

    from bhraytracer_tpu_torch.config import RenderConfig

    if "texture_sample_count" not in {
            f.name for f in dataclasses.fields(RenderConfig)}:
        cfg_kw = {k: v for k, v in cfg_kw.items()
                  if k != "texture_sample_count"}
    return RenderConfig(**cfg_kw)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls after one warm call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, names) -> float:
    """Mean device time of fn() in the kernels whose name holds one of
    `names`, from torch.profiler over reps calls after one warm call. A
    profile that recorded none of them is taken again, up to five times,
    each over twice the calls of the one before (the profiler has returned
    a profile without the kernels' records, late in a long run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(5):
        calls = reps * 2 ** attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        col = ("self_device_time_total"
               if hasattr(ka[0], "self_device_time_total")
               else "self_cuda_time_total")
        us = sum(getattr(e, col) for e in ka
                 if e.device_type == DeviceType.CUDA
                 and any(n in e.key for n in names))
        if us > 0:
            return us / calls / 1e3
    raise AssertionError(f"no device time recorded for {names}")


def launch_count(fn) -> int:
    """Kernel launches (the port's and PyTorch's) of one fn() call, after a
    warm call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


def ptxas_report(kernel: str) -> dict:
    """Registers, stack frame and spills of the __global__ function whose
    name holds `kernel`, from nvcc's -Xptxas -v report that the build
    writes beside the library."""
    import re

    from bhraytracer_tpu_torch.ops import kernels

    with open(kernels.library_path() + ".log") as f:
        log = f.read()
    m = re.search(r"Function properties for \S*" + kernel + r"\S*\n\s*(\d+) "
                  r"bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                  r"spill loads\n.*?Used (\d+) registers", log)
    check(m is not None, f"no ptxas report of {kernel}")
    stack, st, ld, regs = (int(x) for x in m.groups())
    return dict(registers=regs, stack_bytes=stack, spill_store_bytes=st,
                spill_load_bytes=ld)


def trace_args(fn, kernel: str) -> dict:
    """What the profiler's trace records of the launch of `kernel` in one
    fn() call (registers, block and grid, and Kineto's occupancy estimate:
    the resident blocks an SM the kernel's resources allow, capped by the
    grid, over the SM's 2048 threads)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bhraytracer_tpu_torch.ops import kernels

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".json",
                                     dir=kernels.BUILD_DIR) as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            events = json.load(g)["traceEvents"]
    for e in events:
        if e.get("cat") == "kernel" and kernel in e.get("name", ""):
            a = e.get("args", {})
            return {k: a[k] for k in (
                "registers per thread", "shared memory", "block", "grid",
                "blocks per SM", "warps per SM", "est. achieved occupancy %")
                if k in a}
    return {}


def flat_boxes(pack):
    """(cluster_boxes, super_boxes) of the pack's cluster tables, which the
    culling flat closest kernel reads beside the pack's stream rows."""
    from bhraytracer_tpu_torch.ops.cull import cluster_tables

    return cluster_tables(pack)[1:]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take: bytes at the HBM rate or
    operations at the float32 peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(n_bytes), bound_ops=int(ops))


def analytic_ops(pack, n: int) -> int:
    return n * (pack.n_sph * SPHERE_OPS + pack.n_pln * PLANE_OPS)


def elementwise_ops(fn) -> int:
    """Elements produced by the arithmetic and compare ops of fn() (a plain
    PyTorch twin), counted with a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "pow",
             "exp", "log", "sin", "cos", "atan2", "acos", "asin", "minimum",
             "maximum", "clamp", "clamp_min", "clamp_max", "where", "eq", "ne",
             "lt", "le", "gt", "ge", "logical_and", "logical_or",
             "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
             "reciprocal", "floor", "sign", "amax", "amin", "sum"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__.split(".")[0].rstrip("_") in arith:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Count.n += sum(o.numel() for o in outs if hasattr(o, "numel"))
            return out

    with Count():
        fn()
    return Count.n


def level0(pack, cam, dev, cfg_kw=HEADLINE):
    """The main path's level-0 inputs at 800x600 = 480,000 lanes: camera
    rays, their closest hits (the BVH route, as the render takes it), the
    shade mask and the level's uniforms."""
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.ops.trace import trace_closest

    cfg = render_config(cfg_kw)
    key = rng.fold_in(rng.fold_in(rng.prng_key(0, dev), 0), 0)
    o, d, _ = PT._raygen(pack, cfg, from_scene_camera(cam, dev), 800, 600,
                         LANES, 0, key)
    hit = trace_closest(pack, o, d, "front", reorder=False)
    u_tab = rng.uniform(rng.fold_in(PT._level_key(key, 0), 1), (LANES, 13))
    return cfg, o.contiguous(), d.contiguous(), hit, hit.hit.clone(), u_tab


def scattered(o, d, hit, seed: int):
    """A scattered secondary population: random directions from the hit
    points (the camera rays' origins where they missed)."""
    import torch

    gen = torch.Generator(device=o.device).manual_seed(seed)
    d2 = torch.randn(o.shape, generator=gen, device=o.device)
    o2 = torch.where(hit.hit[:, None], o + d * hit.t[:, None].clamp_max(1e3)
                     - 1e-3 * d, o)
    return o2.contiguous(), d2.contiguous()


def aimed(pack, o, d, hit, seed: int):
    """Secondary rays from the hit points (the camera rays' origins where
    they missed) toward random points of the pack's mesh bounds (its BVH's
    root box): most of them reach the mesh."""
    import torch

    gen = torch.Generator(device=o.device).manual_seed(seed)
    o2 = torch.where(hit.hit[:, None], o + d * hit.t[:, None].clamp_max(1e3)
                     - 1e-3 * d, o)
    lo, hi = pack.bvh_bmin[0], pack.bvh_bmax[0]
    tgt = lo + (hi - lo) * torch.rand(o.shape, generator=gen, device=o.device)
    return o2.contiguous(), (tgt - o2).contiguous()


def _traversal_ops(pack, o, run) -> dict:
    import torch

    counts = torch.empty((o.shape[0], 2), dtype=torch.int32, device=o.device)
    run(counts)
    box, tri = counts.sum(0).tolist()
    return dict(ops=box * BOX_TEST_OPS + tri * TRI_TEST_OPS
                + analytic_ops(pack, o.shape[0]), box_tests=box, tri_tests=tri)


def closest_ops(pack, o, d, t_init, side: str) -> dict:
    """Operations the closest hits of these rays need, whichever kernel
    computes them: the box and triangle tests of their BVH traversal
    (kernel 4's per-ray counts) and the analytic tests."""
    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops.trace import analytic_tables

    sph, pln = analytic_tables(pack)
    return _traversal_ops(pack, o, lambda counts: B.bvh_closest(
        pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth, sph, pln, o, d,
        t_init, side, counts))


def occlusion_ops(pack, o, d, t_max, t_min, ana_bias) -> dict:
    """Operations the occlusion of these rays needs, as closest_ops counts
    them (kernel 5's traversal, which stops at the first occluder)."""
    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops.trace import analytic_tables

    sph, pln = analytic_tables(pack)
    return _traversal_ops(pack, o, lambda counts: B.bvh_anyhit(
        pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth, sph, pln, o, d,
        t_max, t_min, ana_bias, counts=counts))


def op_bound(n_bytes: float, work: dict) -> dict:
    """bound() of closest_ops / occlusion_ops work, with its counts."""
    return dict(**bound(n_bytes, work["ops"]), box_tests=work["box_tests"],
                tri_tests=work["tri_tests"])


def bvh_bytes(pack, sph, pln) -> tuple:
    """Bytes of the tables kernels 4 and 5 read (the sibling-pair table,
    the face rows, the analytic tables), and the same with the JAX
    package's 64-byte node rows in place of the pair table: the yardstick
    of the kernels before the pair table, reported beside the bound as
    `node_rows_bound_ms` so that old and new kernels can be compared."""
    tab = nbytes(pack.bvh_pairs, pack.bvh_faces, sph, pln)
    return tab, tab - nbytes(pack.bvh_pairs) + pack.bvh_left.shape[0] * 64


def bvh_bound(tabs: tuple, ray_bytes: int, work: dict) -> dict:
    """op_bound() of a BVH kernel's work over `tabs` (bvh_bytes) and rays
    of `ray_bytes`, with the bound under the 64-byte node rows beside it."""
    return dict(**op_bound(tabs[0] + ray_bytes, work),
                node_rows_bound_ms=bound(tabs[1] + ray_bytes,
                                         work["ops"])["bound_ms"])


def compare_exact(what, t1, k1, t0, k0):
    """Kernel (t1, k1) against twin (t0, k0): same hit set, t and keys
    equal. Returns the max abs t error over the hits."""
    import torch

    from bhraytracer_tpu_torch.ops.linalg import BIG

    hit = t0 < BIG
    check(bool(((t1 < BIG) == hit).all()), f"{what}: hit sets differ")
    check(bool(hit.any()), f"{what}: no hit to compare")
    err = float((t1[hit] - t0[hit]).abs().max())
    n_bad = int((k1 != k0).sum())
    check(err == 0.0 and n_bad == 0,
          f"{what}: max abs t err {err}, {n_bad} keys differ")
    return err


def compare_stream(pack, tiny, cam, dev):
    """Kernels 1 and 2 against their twins at 480,000 lanes. Kernel 1 also
    with its per-ray cull counts on the scattered rays, and timed there
    beside the BVH kernel on the same rays."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables

    cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev)
    t_init = torch.full((LANES,), BIG, device=dev)
    o2, d2 = scattered(o, d, hit, 0)
    out = {}
    errs, refs = [], []
    for p, oo, dd, side in ((pack, o, d, "front"), (pack, o2, d2, "both"),
                            (tiny, o, d, "front")):
        sph, pln = analytic_tables(p)
        t1, k1 = K.stream_closest(p.stream_rows, sph, pln, oo, dd, t_init,
                                  side, boxes=flat_boxes(p))
        t0, k0 = K.stream_closest_ref(p.stream_rows, sph, pln, oo, dd, t_init,
                                      K.SIDES[side])
        errs.append(compare_exact("stream_closest", t1, k1, t0, k0))
        refs.append((t0, k0))
    t0, k0 = refs[1]  # the scattered rays
    sph, pln = analytic_tables(pack)
    rows, boxes = pack.stream_rows, flat_boxes(pack)

    def flat(counts=None):
        return K.stream_closest(rows, sph, pln, o2, d2, t_init, "both",
                                boxes=boxes, counts=counts)

    counts = torch.empty((LANES, 3), dtype=torch.int32, device=dev)
    tc, kc = flat(counts)
    compare_exact("stream_closest (with counts)", tc, kc, t0, k0)
    out["bhrt_stream_closest"] = dict(
        max_abs_err=max(errs), lanes_compared=4 * LANES,
        ms=cuda_ms(flat, 5),
        device_ms=device_ms(flat, 5, ("closest_kernel",)),
        bvh_same_rays_ms=cuda_ms(lambda: B.bvh_closest(
            pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth, sph, pln, o2, d2,
            t_init, "both"), 5),
        plain_ms=cuda_ms(lambda: K.stream_closest_ref(rows, sph, pln, o2, d2,
                                                      t_init, 2), 2),
        shape="480K scattered rays x 1408 faces, side both",
        cull=cull_stats(counts, pack.wtri_v0.shape[0]),
        **op_bound(nbytes(rows, *boxes, sph, pln, o2, d2, t_init) + LANES * 8,
                   closest_ops(pack, o2, d2, t_init, "both")))

    fo = S.shade_setup(pack, cfg, o, d, hit, shade, u_tab)
    so, sd, tm = fo.shadow_o, fo.shadow_d, fo.shadow_tmax
    n_bad = 0
    for p in (pack, tiny):
        sph, pln = analytic_tables(p)
        a1 = K.stream_anyhit(p.stream_rows, sph, pln, so, sd, tm,
                             MESH_SHADOW_BIAS, cfg.shadow_bias, False,
                             boxes=flat_boxes(p))
        a0 = K.stream_anyhit_ref(p.stream_rows, sph, pln, so, sd, tm,
                                 MESH_SHADOW_BIAS, cfg.shadow_bias, False)
        check(bool(a0.any()), "stream_anyhit: no occluded lane to compare")
        n_bad += int((a1 != a0).sum())
    check(n_bad == 0, f"stream_anyhit: {n_bad} lanes differ")
    sph, pln = analytic_tables(pack)

    def shadow(counts=None):
        return K.stream_anyhit(rows, sph, pln, so, sd, tm, MESH_SHADOW_BIAS,
                               cfg.shadow_bias, boxes=boxes, counts=counts)

    counts = torch.empty((LANES, 3), dtype=torch.int32, device=dev)
    check(bool(torch.equal(shadow(counts), shadow())),
          "stream_anyhit: a run with counts gave another result")
    out["bhrt_stream_anyhit"] = dict(
        max_abs_err=float(n_bad), lanes_compared=2 * LANES,
        ms=cuda_ms(shadow, 5),
        device_ms=device_ms(shadow, 5, ("cull_anyhit_kernel",)),
        bvh_same_rays_ms=cuda_ms(lambda: B.bvh_anyhit(
            pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth, sph, pln, so, sd,
            tm, MESH_SHADOW_BIAS, cfg.shadow_bias), 5),
        bvh_same_rays_device_ms=device_ms(lambda: B.bvh_anyhit(
            pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth, sph, pln, so, sd,
            tm, MESH_SHADOW_BIAS, cfg.shadow_bias), 5,
            ("bvh_anyhit_kernel",)),
        plain_ms=cuda_ms(lambda: K.stream_anyhit_ref(
            rows, sph, pln, so, sd, tm, MESH_SHADOW_BIAS, cfg.shadow_bias,
            False), 2),
        shape="480K level-0 shadow rays x 1408 faces",
        cull=cull_stats(counts, pack.wtri_v0.shape[0]),
        **op_bound(nbytes(rows, *boxes, sph, pln, so, sd, tm) + LANES,
                   occlusion_ops(pack, so, sd, tm, MESH_SHADOW_BIAS,
                                 cfg.shadow_bias)))
    return out


def shade_call_check(args, what: str):
    """Kernel 3 (`shade_lanes`) against its twin on one call's arguments:
    the discrete outputs (mtl, gate, rr0) equal on every lane, the floats
    within 1e-5 on the shaded lanes (miss lanes carry junk every consumer
    masks). Returns (kernel outputs, largest float difference)."""
    import torch

    from bhraytracer_tpu_torch.ops import shade as S

    k = S.shade_lanes(*args)
    r = S.shade_setup_ref(*args)
    for name in ("mtl", "gate", "rr0"):
        bad = int((getattr(k, name) != getattr(r, name)).sum())
        check(bad == 0, f"{what}: shade_setup {name} differs on {bad} lanes")
    shade, n = args[6], args[0].shape[0]
    fields = [f for f in S.ShadeSetup._fields if f not in ("mtl", "gate",
                                                           "rr0")]
    fk = torch.cat([getattr(k, f).reshape(n, -1)[shade] for f in fields], 1)
    fr = torch.cat([getattr(r, f).reshape(n, -1)[shade] for f in fields], 1)
    close = torch.isclose(fk, fr, rtol=1e-5, atol=1e-5)
    bad = int((~close.all(1)).sum())
    check(bad == 0, f"{what}: shade_setup {bad} shaded lanes beyond 1e-5")
    return k, float((fk - fr).abs().max()) if fk.numel() else 0.0


def compare_shade(pack, cam, dev):
    """Kernel 3 against its twin at 480,000 lanes (shade_call_check); with
    its device time and the launches of one fused shade step (shade setup,
    shadow trace and visibility fold)."""
    import torch

    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops import shade as S

    cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev)
    inst, mtl, light = S.shade_tables(pack)
    args = (o, d, hit.kind, hit.inst, hit.face, hit.front, shade, u_tab,
            pack.resolve_rows, inst, pack.n_sph, pack.n_pln, pack.n_msh, mtl,
            light, cfg.bias)
    check(bool(shade.sum() > LANES // 4), "shade_setup: too few shaded lanes")
    k, err = shade_call_check(args, "level 0")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return {"bhrt_shade_setup": dict(
        max_abs_err=err, lanes_compared=LANES,
        ms=cuda_ms(lambda: S.shade_lanes(*args), 5),
        device_ms=device_ms(lambda: S.shade_lanes(*args), 5,
                            ("shade_kernel",)),
        plain_ms=cuda_ms(lambda: S.shade_setup_ref(*args), 2),
        shape="480K level-0 lanes",
        launches_shade_setup=launch_count(lambda: S.shade_setup(
            pack, cfg, o, d, hit, shade, u_tab)),
        launches_fused_step=launch_count(lambda: PT._shade_fused(
            pack, cfg, o, d, hit, shade, u_tab, False)),
        ptxas=ptxas_report("shade_kernel"),
        occupancy=trace_args(lambda: S.shade_lanes(*args), "shade_kernel"),
        **bound(nbytes(*tensors, *k), elementwise_ops(
            lambda: S.shade_setup_ref(*args)))),
    }


def subset(dev, n: int = LANES):
    """The fixed lanes the brute-force twins check on the big-mesh scene:
    SUBSET lanes spread evenly over the n (480,000), in runs of 128."""
    import torch

    run = 128
    nb = SUBSET // run
    starts = torch.arange(nb, device=dev) * (n // run // nb)
    return (starts[:, None] * run
            + torch.arange(run, device=dev)).reshape(-1)


def bvh_tabs(pack):
    """(node table, faces, depth) that the checkout's BVH kernels read: the
    sibling-pair table, or the 16-float node rows in checkouts from before
    it (so --timing runs in either)."""
    nodes = pack.bvh_pairs if hasattr(pack, "bvh_pairs") else pack.bvh_nodes
    return nodes, pack.bvh_faces, pack.bvh_depth


def bvh_times(tabs, sph, pln, o, d, aux, side=None, shadow=None) -> dict:
    """Kernel 4 (closest hits, `aux` the seeds, `side`) or kernel 5
    (occlusion, `aux` the t_max, `shadow` (t_min, ana_bias,
    plane_world_bug)) on rays o, d: through the wrapper (CUDA events) and
    on the device (the profiler)."""
    from bhraytracer_tpu_torch.ops import bvh as B

    if shadow is None:
        def run():
            return B.bvh_closest(*tabs, sph, pln, o, d, aux, side)
    else:
        def run():
            return B.bvh_anyhit(*tabs, sph, pln, o, d, aux, *shadow)
    name = "bvh_closest_kernel" if shadow is None else "bvh_anyhit_kernel"
    return dict(lanes=o.shape[0], ms=cuda_ms(run, 5),
                device_ms=device_ms(run, 5, (name,)))


def walk_counts(pack, sph, pln, o, d, aux, idx, side=2, shadow=None):
    """Kernel 4 (or 5, with `shadow`) on every lane with its per-ray counts,
    against bvh_walk_ref on the lanes `idx`: the result and the counts must
    be equal. Returns the kernel's counts (all lanes) and the lanes
    compared."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B

    tabs = bvh_tabs(pack)
    counts = torch.empty((o.shape[0], 2), dtype=torch.int32, device=o.device)
    if shadow is None:
        out = B.bvh_closest(*tabs, sph, pln, o, d, aux,
                            ("front", "back", "both")[side], counts)
    else:
        out = (B.bvh_anyhit(*tabs, sph, pln, o, d, aux, *shadow,
                            counts=counts),)
    ref = B.bvh_walk_ref(pack.bvh_pairs, pack.bvh_faces, sph, pln, o[idx],
                         d[idx], aux[idx], side, shadow)
    what = "bvh_closest" if shadow is None else "bvh_anyhit"
    for x, r in zip(out, ref[:-1]):
        check(bool(torch.equal(x[idx], r)),
              f"{what}: the kernel and bvh_walk_ref differ on "
              f"{int((x[idx] != r).sum())} lanes")
    bad = int((counts[idx] != ref[-1]).any(1).sum())
    check(bad == 0, f"{what}: per-ray counts differ from bvh_walk_ref's on "
          f"{bad} of {idx.shape[0]} lanes")
    return counts, idx.shape[0]


def compare_bvh(bench, big, cam, dev):
    """Kernels 4 and 5 against their twins: the bench scene's 480K level-0
    camera rays and shadow rays, whole; the big-mesh scene's, on SUBSET
    lanes; each kernel's result and per-ray counts against bvh_walk_ref's on
    SUBSET lanes of these and of 480K scattered rays from the level-0 hits
    (bench seed 0, big mesh seed 1); each timed through the wrapper and on
    the device, with its registers and occupancy. Both level-0 routes are
    timed on the same camera rays."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables

    t_init = torch.full((LANES,), BIG, device=dev)
    idx = subset(dev)
    res, errs, occ_bad, walked = {}, [], 0, 0
    for name, pack, seed, cfg_kw in (("bench", bench, 0, HEADLINE),
                                     ("bigmesh", big, 1, BIGMESH)):
        cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev, cfg_kw)
        sph, pln = analytic_tables(pack)
        tabs = bvh_tabs(pack)
        fo = S.shade_setup(pack, cfg, o, d, hit, shade, u_tab)
        so, sd = fo.shadow_o.contiguous(), fo.shadow_d.contiguous()
        tm = fo.shadow_tmax.contiguous()
        shadow = (MESH_SHADOW_BIAS, cfg.shadow_bias, False)
        o2, d2 = scattered(o, d, hit, seed)
        sel = slice(None) if name == "bench" else idx
        t1, k1 = B.bvh_closest(*tabs, sph, pln, o, d, t_init, "front")
        t0, k0 = B.bvh_closest_ref(pack.bvh_faces, sph, pln, o[sel], d[sel],
                                   t_init[sel], 0)
        errs.append(compare_exact(f"bvh_closest ({name})", t1[sel], k1[sel],
                                  t0, k0))
        a1 = B.bvh_anyhit(*tabs, sph, pln, so, sd, tm, *shadow[:2])
        a0 = B.bvh_anyhit_ref(pack.bvh_faces, sph, pln, so[sel], sd[sel],
                              tm[sel], *shadow)
        check(bool(a0.any()), f"bvh_anyhit ({name}): no occluded lane")
        occ_bad += int((a1[sel] != a0).sum())
        counts = {}
        for key, oo, dd, side in (("camera", o, d, 0),
                                  ("scattered", o2, d2, 2)):
            c, n = walk_counts(pack, sph, pln, oo, dd, t_init, idx, side)
            counts[key] = c
            walked += n
        c, n = walk_counts(pack, sph, pln, so, sd, tm, idx, shadow=shadow)
        counts["shadow"] = c
        walked += n
        lanes = LANES if name == "bench" else SUBSET
        tab_bytes = bvh_bytes(pack, sph, pln)
        work = {k: c.double().mean(0).tolist() for k, c in counts.items()}
        closest = dict(
            lanes_compared=lanes,
            **bvh_times(tabs, sph, pln, o, d, t_init, "front"),
            scattered=dict(
                **bvh_times(tabs, sph, pln, o2, d2, t_init, "both"),
                **bvh_bound(tab_bytes, nbytes(o2, d2, t_init) + LANES * 8,
                            closest_ops(pack, o2, d2, t_init, "both"))),
            plain_ms=cuda_ms(lambda: B.bvh_closest_ref(
                pack.bvh_faces, sph, pln, o[sel], d[sel], t_init[sel], 0), 1),
            plain_lanes=lanes, pair_table_bytes=nbytes(tabs[0]),
            tests_per_ray=dict(camera=work["camera"],
                               scattered=work["scattered"]),
            **bvh_bound(tab_bytes, nbytes(o, d, t_init) + LANES * 8,
                        closest_ops(pack, o, d, t_init, "front")))
        anyhit = dict(
            lanes_compared=lanes,
            **bvh_times(tabs, sph, pln, so, sd, tm, shadow=shadow),
            plain_ms=cuda_ms(lambda: B.bvh_anyhit_ref(
                pack.bvh_faces, sph, pln, so[sel], sd[sel], tm[sel],
                *shadow), 1),
            plain_lanes=lanes, pair_table_bytes=nbytes(tabs[0]),
            tests_per_ray=work["shadow"],
            **bvh_bound(tab_bytes, nbytes(so, sd, tm) + LANES,
                        occlusion_ops(pack, so, sd, tm, MESH_SHADOW_BIAS,
                                      cfg.shadow_bias)))
        if name == "bench":
            for k, v in (("closest", closest), ("anyhit", anyhit)):
                kern = f"bvh_{k}_kernel"
                run = ((lambda: B.bvh_closest(*tabs, sph, pln, o, d, t_init,
                                              "front")) if k == "closest"
                       else (lambda: B.bvh_anyhit(*tabs, sph, pln, so, sd, tm,
                                                  *shadow)))
                v.update(ptxas=ptxas_report(kern),
                         occupancy=trace_args(run, kern))
        res[name] = (closest, anyhit)
        if name == "bench":
            # The other level-0 route on the same camera rays (the flat
            # stream kernel), and both routes on the scattered rays
            # compare_stream times (the levels >= 1 kind).
            res["route_bench"] = dict(
                bvh_closest_ms=closest["ms"],
                stream_closest_ms=cuda_ms(lambda: K.stream_closest(
                    pack.stream_rows, sph, pln, o, d, t_init, "front",
                    boxes=flat_boxes(pack)), 5),
                bvh_anyhit_ms=anyhit["ms"],
                stream_anyhit_ms=cuda_ms(lambda: K.stream_anyhit(
                    pack.stream_rows, sph, pln, so, sd, tm, MESH_SHADOW_BIAS,
                    cfg.shadow_bias, boxes=flat_boxes(pack)), 5),
                scattered_bvh_closest_ms=closest["scattered"]["ms"],
                scattered_stream_closest_ms=cuda_ms(lambda: K.stream_closest(
                    pack.stream_rows, sph, pln, o2, d2, t_init, "both",
                    boxes=flat_boxes(pack)), 5))
    check(occ_bad == 0, f"bvh_anyhit: {occ_bad} lanes differ")
    (bc, ba), (gc, ga) = res["bench"], res["bigmesh"]
    out = {
        "bhrt_bvh_closest": dict(
            max_abs_err=max(errs), **bc, shape="480K level-0 camera rays, "
            "bench scene (1408 faces)", bigmesh=gc, walk_lanes=walked),
        "bhrt_bvh_anyhit": dict(
            max_abs_err=float(occ_bad), **ba, shape="480K level-0 shadow "
            "rays, bench scene (1408 faces)", bigmesh=ga, walk_lanes=walked),
    }
    return out, res["route_bench"]


def compare_bvh_calls(pack, dev, calls, what):
    """Kernels 4 and 5 on a frame's level-0 calls (`calls`, the "closest"
    and "anyhit" lists of record_frame_calls): each call's result against
    its brute-force twin on every lane, and its result and per-ray box and
    triangle test counts against bvh_walk_ref's on SUBSET lanes of it; each
    call of the first TIMED_CALLS of each kernel timed through the wrapper
    and on the device. `what` names the frame. Returns per kernel the
    largest error, lanes compared, lanes walked, tests a ray and the calls'
    times."""
    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops.trace import analytic_tables

    check(len(calls["closest"]) > 0 and len(calls["anyhit"]) > 0,
          f"{what}: no BVH call recorded")
    sph, pln = analytic_tables(pack)
    tabs = bvh_tabs(pack)
    errs, lanes, walked, tests, times = [], 0, 0, [], []
    for o, d, ti, side in calls["closest"]:
        t1, k1 = B.bvh_closest(*tabs, sph, pln, o, d, ti, side)
        t0, k0 = B.bvh_closest_ref(pack.bvh_faces, sph, pln, o, d, ti,
                                   B.SIDES[side])
        errs.append(compare_exact(f"bvh_closest ({what})", t1, k1, t0, k0))
        c, n = walk_counts(pack, sph, pln, o, d, ti,
                           subset(dev, o.shape[0]), B.SIDES[side])
        lanes += o.shape[0]
        walked += n
        tests.append(c.double().mean(0).tolist())
        if len(times) < TIMED_CALLS:
            times.append(bvh_times(tabs, sph, pln, o, d, ti, side))
    closest = dict(max_abs_err=max(errs), lanes_compared=lanes,
                   walk_lanes=walked, tests_per_ray=tests, calls=times)
    n_bad, n_occ, lanes, walked, tests, times = 0, 0, 0, 0, [], []
    for o, d, tm, *shadow in calls["anyhit"]:
        a1 = B.bvh_anyhit(*tabs, sph, pln, o, d, tm, *shadow)
        a0 = B.bvh_anyhit_ref(pack.bvh_faces, sph, pln, o, d, tm, *shadow)
        n_bad += int((a1 != a0).sum())
        n_occ += int(a0.sum())
        c, n = walk_counts(pack, sph, pln, o, d, tm, subset(dev, o.shape[0]),
                           shadow=tuple(shadow))
        lanes += o.shape[0]
        walked += n
        tests.append(c.double().mean(0).tolist())
        if len(times) < TIMED_CALLS:
            times.append(bvh_times(tabs, sph, pln, o, d, tm, shadow=shadow))
    check(n_bad == 0, f"bvh_anyhit ({what}): {n_bad} of {lanes} lanes differ "
          "from the twin")
    check(n_occ > 0, f"bvh_anyhit ({what}): no occluded lane")
    anyhit = dict(max_abs_err=float(n_bad), lanes_compared=lanes,
                  occluded=n_occ, walk_lanes=walked, tests_per_ray=tests,
                  calls=times)
    return {"bhrt_bvh_closest": closest, "bhrt_bvh_anyhit": anyhit}


def cull_stats(counts, n_faces: int) -> dict:
    """What the clustered cull did, from a kernel's per-ray counts (box
    tests, face tests, and its warp's face-test slots, which every lane of
    a 32-ray tile holds): means per ray and per warp, against brute force,
    and the share of lanes busy in the warps' face work."""
    c = counts.double()
    box, face, slot = c.sum(0).tolist()
    n = counts.shape[0]
    return dict(box_tests_per_ray=box / n, face_tests_per_ray=face / n,
                brute_force_per_ray=n_faces,
                face_slots_per_warp=float(c[::32, 2].mean()),
                busy_lane_share=face / slot if slot else 0.0)


def compare_hbm(big, cam, dev):
    """Kernels 6 and 7 against their twins on the big-mesh scene: 480K
    scattered secondary rays from the level-0 hits, coherence-sorted as the
    router sorts them; the twins and the flat twins run on SUBSET lanes.
    Runs with the per-ray counts show what the cull does; the cluster sizes
    of CLUSTER_SIZES are held to the flat twins and timed; the closest
    kernel is timed with and without the sort, beside the BVH kernel on the
    same rays."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops import cull as C
    from bhraytracer_tpu_torch.ops import stream_hbm as H
    from bhraytracer_tpu_torch.ops.compact import inverse_permutation
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import (
        MESH_SHADOW_BIAS,
        analytic_tables,
        coherence_order,
    )

    cfg, o, d, hit, _, _ = level0(big, cam, dev, BIGMESH)
    o2, d2 = scattered(o, d, hit, 1)
    sph, pln = analytic_tables(big)
    tabs = C.cluster_tables(big)
    t_init = torch.full((LANES,), BIG, device=dev)
    order = coherence_order(big, o2, d2, t_init)
    os_, ds_ = o2[order].contiguous(), d2[order].contiguous()
    tm = torch.where(torch.arange(LANES, device=dev) % 3 == 0, BIG, 1.0)
    order_s = coherence_order(big, o2, d2, tm)
    so, sd, stm = (x[order_s].contiguous() for x in (o2, d2, tm))
    idx = subset(dev)

    def closest(tb, oo=os_, dd=ds_, counts=None):
        return H.stream_closest_hbm(*tb, sph, pln, oo, dd, t_init, "both",
                                    counts)

    def anyhit(tb, counts=None):
        return H.stream_anyhit_hbm(*tb, sph, pln, so, sd, stm,
                                   MESH_SHADOW_BIAS, cfg.shadow_bias,
                                   counts=counts)

    t1, k1 = closest(tabs)
    t0, k0 = H.stream_closest_hbm_ref(*tabs, sph, pln, os_[idx], ds_[idx],
                                      t_init[idx], 2)
    err = compare_exact("stream_closest_hbm", t1[idx], k1[idx], t0, k0)
    tf, kf = K.stream_closest_ref(big.stream_rows, sph, pln, os_[idx],
                                  ds_[idx], t_init[idx], 2)
    compare_exact("stream_closest_hbm vs the flat twin", t1[idx], k1[idx],
                  tf, kf)
    a1 = anyhit(tabs)
    a0 = H.stream_anyhit_hbm_ref(*tabs, sph, pln, so[idx], sd[idx], stm[idx],
                                 MESH_SHADOW_BIAS, cfg.shadow_bias, False)
    af = K.stream_anyhit_ref(big.stream_rows, sph, pln, so[idx], sd[idx],
                             stm[idx], MESH_SHADOW_BIAS, cfg.shadow_bias,
                             False)
    check(bool(a0.any()), "stream_anyhit_hbm: no occluded lane")
    n_bad = int((a1[idx] != a0).sum())
    check(n_bad == 0, f"stream_anyhit_hbm: {n_bad} lanes differ")
    check(bool((a0 == af).all()), "stream_anyhit_hbm: the flat twin differs")

    counts = [torch.empty((LANES, 3), dtype=torch.int32, device=dev)
              for _ in range(2)]
    tc, kc = closest(tabs, counts=counts[0])
    check(bool(torch.equal(tc, t1) and torch.equal(kc, k1)
               and torch.equal(anyhit(tabs, counts[1]), a1)),
          "stream_hbm: a run with counts gave another result")
    n_faces = big.wtri_v0.shape[0]
    cull = dict(closest=cull_stats(counts[0], n_faces),
                anyhit=cull_stats(counts[1], n_faces))

    sizes = {}
    for c in CLUSTER_SIZES:
        tb = C.cluster_tables(big, c)
        tx, kx = closest(tb)
        compare_exact(f"stream_closest_hbm (cluster {c}) vs the flat twin",
                      tx[idx], kx[idx], tf, kf)
        check(bool((anyhit(tb)[idx] == af).all()),
              f"stream_anyhit_hbm (cluster {c}): the flat twin differs")
        sizes[c] = dict(closest_ms=cuda_ms(lambda: closest(tb), 5),
                        anyhit_ms=cuda_ms(lambda: anyhit(tb), 5))

    tab_bytes = nbytes(*tabs, sph, pln)
    out = {
        "bhrt_stream_closest_hbm": dict(
            max_abs_err=err, lanes_compared=SUBSET,
            ms=cuda_ms(lambda: closest(tabs), 5),
            plain_ms=cuda_ms(lambda: H.stream_closest_hbm_ref(
                *tabs, sph, pln, os_[idx], ds_[idx], t_init[idx], 2), 1),
            plain_lanes=SUBSET,
            shape="480K scattered sorted rays x 111616 faces, side both",
            cull=cull["closest"],
            **op_bound(tab_bytes + nbytes(os_, ds_, t_init) + LANES * 8,
                       closest_ops(big, os_, ds_, t_init, "both"))),
        "bhrt_stream_anyhit_hbm": dict(
            max_abs_err=float(n_bad), lanes_compared=SUBSET,
            ms=cuda_ms(lambda: anyhit(tabs), 5),
            device_ms=device_ms(lambda: anyhit(tabs), 5, ("anyhit_kernel",)),
            plain_ms=cuda_ms(lambda: H.stream_anyhit_hbm_ref(
                *tabs, sph, pln, so[idx], sd[idx], stm[idx],
                MESH_SHADOW_BIAS, cfg.shadow_bias, False), 1),
            plain_lanes=SUBSET,
            shape="480K scattered sorted rays x 111616 faces, t_max 1 or BIG",
            cull=cull["anyhit"],
            **op_bound(tab_bytes + nbytes(so, sd, stm) + LANES,
                       occlusion_ops(big, so, sd, stm, MESH_SHADOW_BIAS,
                                     cfg.shadow_bias))),
    }

    def routed():
        order = coherence_order(big, o2, d2, t_init)
        t, k = closest(tabs, o2[order].contiguous(), d2[order].contiguous())
        inv = inverse_permutation(order)
        return t[inv], k[inv]

    bvh_tabs = (big.bvh_pairs, big.bvh_faces, big.bvh_depth)
    route = dict(
        hbm_closest_ms=out["bhrt_stream_closest_hbm"]["ms"],
        hbm_closest_with_sort_ms=cuda_ms(routed, 5),
        hbm_closest_unsorted_ms=cuda_ms(lambda: closest(tabs, o2, d2), 5),
        bvh_closest_ms=cuda_ms(lambda: B.bvh_closest(
            *bvh_tabs, sph, pln, o2, d2, t_init, "both"), 5),
        bvh_closest_sorted_ms=cuda_ms(lambda: B.bvh_closest(
            *bvh_tabs, sph, pln, os_, ds_, t_init, "both"), 5),
        cluster_sizes=sizes, cull=cull)
    return out, route


def compare_analytic(tiny, cam, dev, pmap):
    """Kernels 8 and 9 against their twins on the mesh-free tiny scene: its
    480K level-0 camera rays and 480K scattered rays from their hits, for
    every side; the level-0 shadow rays and the scattered rays (t_max 1 or
    BIG), in both plane forms, and the shadow calls of a photon frame
    gathering from `pmap`; kernel 9 timed on the level-0 shadow rays and
    over the frame's calls, through the wrapper and on the device."""
    import torch

    from bhraytracer_tpu_torch.ops import analytic as A
    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import analytic_tables

    cfg, o, d, hit, shade, u_tab = level0(tiny, cam, dev)
    o2, d2 = scattered(o, d, hit, 2)
    sph, pln = analytic_tables(tiny)
    n = PHOTON_BATCH_LANES  # a photon build round's lanes
    ob, db = o2[:n].contiguous(), d2[:n].contiguous()
    errs = []
    for oo, dd in ((o, d), (o2, d2), (ob, db)):
        for side in ("front", "back", "both"):
            t1, k1 = A.analytic_closest(sph, pln, oo, dd, side)
            t0, k0 = A.analytic_closest_ref(sph, pln, oo, dd, A.SIDES[side])
            errs.append(compare_exact(f"analytic_closest ({side})", t1, k1,
                                      t0, k0))
    fo = S.shade_setup(tiny, cfg, o, d, hit, shade, u_tab)
    so, sd, tm = (x.contiguous() for x in (fo.shadow_o, fo.shadow_d,
                                          fo.shadow_tmax))
    tm2 = torch.where(torch.arange(LANES, device=dev) % 3 == 0, BIG, 1.0)
    n_bad = 0
    for oo, dd, tt in ((so, sd, tm), (o2, d2, tm2)):
        for bug in (False, True):
            a1 = A.analytic_anyhit(sph, pln, oo, dd, tt, cfg.shadow_bias, bug)
            a0 = A.analytic_anyhit_ref(sph, pln, oo, dd, tt, cfg.shadow_bias,
                                       bug)
            check(bool(a0.any()), "analytic_anyhit: no occluded lane")
            n_bad += int((a1 != a0).sum())
    calls = record_analytic_shadows(tiny, cam, pmap)
    check(len(calls) > 0, "analytic_anyhit: no shadow call in a photon frame")
    for oo, dd, tt, bias, bug in calls:
        n_bad += int((A.analytic_anyhit(sph, pln, oo, dd, tt, bias, bug)
                      != A.analytic_anyhit_ref(sph, pln, oo, dd, tt, bias,
                                               bug)).sum())
    check(n_bad == 0, f"analytic_anyhit: {n_bad} lanes differ")
    return {
        "bhrt_analytic_closest": dict(
            max_abs_err=max(errs), lanes_compared=6 * LANES + 3 * n,
            ms=cuda_ms(lambda: A.analytic_closest(sph, pln, o2, d2, "both"), 5),
            times_480k=analytic_times(sph, pln, o2, d2),
            times_32768=analytic_times(sph, pln, ob, db),
            plain_ms=cuda_ms(lambda: A.analytic_closest_ref(sph, pln, o2, d2,
                                                            2), 2),
            shape="480K scattered rays x 2 spheres + 1 plane, side both",
            **bound(nbytes(sph, pln, o2, d2) + LANES * 8,
                    analytic_ops(tiny, LANES))),
        "bhrt_analytic_anyhit": dict(
            max_abs_err=float(n_bad),
            lanes_compared=4 * LANES + sum(c[0].shape[0] for c in calls),
            ms=cuda_ms(lambda: A.analytic_anyhit(sph, pln, so, sd, tm,
                                                 cfg.shadow_bias), 5),
            times=analytic_shadow_times(sph, pln, (so, sd, tm),
                                        cfg.shadow_bias, calls),
            plain_ms=cuda_ms(lambda: A.analytic_anyhit_ref(
                sph, pln, so, sd, tm, cfg.shadow_bias, False), 2),
            shape="480K level-0 shadow rays x 2 spheres + 1 plane",
            **bound(nbytes(sph, pln, so, sd, tm) + LANES,
                    analytic_ops(tiny, LANES))),
    }


def record_trace_calls(run, clear_on=None):
    """The trace calls that `run()` makes, as the render makes them: the
    flat closest-hit calls (kernel 1), (o, d, t_init, side) of each (side
    "both" for the refraction chain's trips, "front" for the levels >= 1),
    the flat shadow calls (kernel 2, the levels >= 1), (o, d, t_max, t_min,
    ana_bias, plane_world_bug) of each, and the BVH calls (kernels 4 and 5,
    level 0) in the same two forms under "closest" and "anyhit"; all
    cloned. With clear_on (module, function name), a call of that function
    forgets the calls recorded before it."""
    from bhraytracer_tpu_torch.ops import trace as T

    calls, shadows = [], []
    bvh = dict(closest=[], anyhit=[])
    saved = (T.stream_closest, T.stream_anyhit, T.bvh_closest, T.bvh_anyhit)
    if clear_on is not None:
        mod, fname = clear_on
        marked = getattr(mod, fname)

        def clearing(*args, **kw):
            for lst in (calls, shadows, bvh["closest"], bvh["anyhit"]):
                lst.clear()
            return marked(*args, **kw)

        setattr(mod, fname, clearing)

    # Each wrapper takes its n_tabs tables, then sph, pln, o, d and four
    # more arguments positionally (trace.py's calls).
    def closest_rec(fn, out, n_tabs):
        def call(*args, **kw):
            o, d, t_init, side = args[n_tabs + 2:]
            out.append((o.clone(), d.clone(), t_init.clone(), side))
            return fn(*args, **kw)
        return call

    def anyhit_rec(fn, out, n_tabs):
        def call(*args, ana_bias=0.0, plane_world_bug=False, **kw):
            o, d, t_max, t_min = args[n_tabs + 2:]
            out.append((o.clone(), d.clone(), t_max.clone(), t_min,
                        ana_bias, plane_world_bug))
            return fn(*args, ana_bias=ana_bias,
                      plane_world_bug=plane_world_bug, **kw)
        return call

    T.stream_closest = closest_rec(saved[0], calls, 1)
    T.stream_anyhit = anyhit_rec(saved[1], shadows, 1)
    T.bvh_closest = closest_rec(saved[2], bvh["closest"], 3)
    T.bvh_anyhit = anyhit_rec(saved[3], bvh["anyhit"], 3)
    try:
        run()
    finally:
        (T.stream_closest, T.stream_anyhit, T.bvh_closest,
         T.bvh_anyhit) = saved
        if clear_on is not None:
            setattr(mod, fname, marked)
    return calls, shadows, bvh


def record_frame_calls(pack, cam, cfg_kw=HEADLINE):
    """record_trace_calls of one frame at 800x600 (seed 1, as the main
    path's timed frame) with config `cfg_kw`."""
    import bhraytracer_tpu_torch as B

    def run():
        cam.width, cam.height = 800, 600
        B.render_image(pack, cam, render_config(cfg_kw), seed=1)

    return record_trace_calls(run)


def frame_call_checks(per_kernel, pack, dev, rec, what):
    """Kernels 1 and 2 (compare_frame_calls) and 4 and 5
    (compare_bvh_calls) on every call of the frame `what` recorded by
    record_trace_calls (`rec`): each kernel's entry in per_kernel gains the
    lanes compared and, under "<what>_calls", the frame's results."""
    calls, shadows, bvh_calls = rec
    flat, n_flat, n_shadow = compare_frame_calls(pack, dev, calls, shadows,
                                                 what)
    res = {"bhrt_stream_closest": (n_flat, dict(chain=flat["chain"],
                                                levels=flat["levels"])),
           "bhrt_stream_anyhit": (n_shadow, flat["shadow"])}
    for k, v in compare_bvh_calls(pack, dev, bvh_calls, what).items():
        res[k] = (v["lanes_compared"], v)
        kb = per_kernel[k]
        kb.update(max_abs_err=max(kb["max_abs_err"], v["max_abs_err"]),
                  walk_lanes=kb["walk_lanes"] + v["walk_lanes"])
    for k, (lanes, v) in res.items():
        per_kernel[k]["lanes_compared"] += lanes
        per_kernel[k][f"{what}_calls"] = v


def print_frame_calls(per_kernel, what, note):
    """The results of frame_call_checks on the frame `what`."""
    print(f"flat kernels on a {what} frame's calls (closest key for key, "
          f"any-hit bit for bit; {note}):",
          json.dumps({"closest": per_kernel["bhrt_stream_closest"][
              f"{what}_calls"], "anyhit": per_kernel["bhrt_stream_anyhit"][
              f"{what}_calls"]}))
    print(f"BVH kernels on a {what} frame's level-0 calls (every lane "
          "against the brute-force twin; results and counts against "
          "bvh_walk_ref on subsets):",
          json.dumps({k: per_kernel[k][f"{what}_calls"] for k in BVH}))


def exact_lanes(t1, k1, t0, k0) -> int:
    """Lanes where a kernel's (t, key) is not the twin's, bit for bit."""
    return int(((t1 != t0) | (k1 != k0)).sum())


def compare_frame_calls(pack, dev, calls, shadows, what):
    """Kernel 1 against its twin, key for key, on every closest call of a
    frame (`calls`: the chain trips and the levels), and kernel 2 bit for
    bit on every lane of the frame's shadow calls (`shadows`), with per-ray
    cull counts; each timed beside the BVH kernel on the same rays. `what`
    names the frame. Returns the results by kind and the lanes compared of
    each kernel."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops.trace import analytic_tables

    sph, pln = analytic_tables(pack)
    rows, boxes = pack.stream_rows, flat_boxes(pack)
    bvh = (pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth)
    bvh_tab = bvh_bytes(pack, sph, pln)

    def bvh_bounds(ray_bytes, n_calls, ops):
        # Kernel 4's or 5's bound on the same calls: each call reads the
        # tables once.
        return dict(bvh_bound_ms=bound(bvh_tab[0] * n_calls + ray_bytes,
                                       ops)["bound_ms"],
                    bvh_node_rows_bound_ms=bound(
                        bvh_tab[1] * n_calls + ray_bytes, ops)["bound_ms"])

    res, bad, lanes = {}, 0, 0
    for kind, sel in (("chain", lambda c: c[3] == "both"),
                      ("levels", lambda c: c[3] != "both")):
        part = [c for c in calls if sel(c)]
        counts = []
        for o, d, ti, side in part:
            cnt = torch.empty((o.shape[0], 3), dtype=torch.int32, device=dev)
            t1, k1 = K.stream_closest(rows, sph, pln, o, d, ti, side,
                                      boxes=boxes, counts=cnt)
            t0, k0 = K.stream_closest_ref(rows, sph, pln, o, d, ti,
                                          K.SIDES[side])
            bad += exact_lanes(t1, k1, t0, k0)
            lanes += o.shape[0]
            counts.append(cnt)

        def run_flat():
            for o, d, ti, side in part:
                K.stream_closest(rows, sph, pln, o, d, ti, side, boxes=boxes)

        def run_bvh():
            for o, d, ti, side in part:
                B.bvh_closest(*bvh, sph, pln, o, d, ti, side)

        work = [closest_ops(pack, o, d, ti, side) for o, d, ti, side in part]
        res[kind] = dict(
            calls=len(part), lanes=sum(c[0].shape[0] for c in part),
            wrapper_ms=cuda_ms(run_flat, 3),
            device_ms=device_ms(run_flat, 3, ("closest_kernel",)),
            bvh_device_ms=device_ms(run_bvh, 3, ("bvh_closest_kernel",)),
            **bvh_bounds(sum(nbytes(o, d, ti) + o.shape[0] * 8
                             for o, d, ti, _ in part), len(part),
                         sum(w["ops"] for w in work)),
            cull=cull_stats(torch.cat(counts), pack.wtri_v0.shape[0]),
            **bound(sum(nbytes(rows, *boxes, sph, pln, o, d, ti) + o.shape[0]
                        * 8 for o, d, ti, _ in part),
                    sum(w["ops"] for w in work)))
    check(bad == 0, f"stream_closest: {bad} of {lanes} lanes of the {what} "
          "frame's calls differ from the twin")
    check(res["chain"]["calls"] > 0,
          f"stream_closest: no chain trip recorded ({what})")

    # The frame's shadow calls (kernel 2), against the twin and the BVH
    # any-hit kernel on the same rays.
    check(len(shadows) > 0, f"stream_anyhit: no shadow call recorded ({what})")
    counts, n_bad, n_occ, n_lanes = [], 0, 0, 0
    for o, d, tm, t_min, bias, bug in shadows:
        cnt = torch.empty((o.shape[0], 3), dtype=torch.int32, device=dev)
        a1 = K.stream_anyhit(rows, sph, pln, o, d, tm, t_min, bias, bug,
                             boxes=boxes, counts=cnt)
        a0 = K.stream_anyhit_ref(rows, sph, pln, o, d, tm, t_min, bias, bug)
        n_bad += int((a1 != a0).sum())
        n_occ += int(a0.sum())
        n_lanes += o.shape[0]
        counts.append(cnt)
    check(n_bad == 0, f"stream_anyhit: {n_bad} of {n_lanes} lanes of the "
          f"{what} frame's shadow calls differ from the twin")
    check(n_occ > 0,
          f"stream_anyhit: no occluded lane in the {what} frame's calls")

    def run_shadow():
        for o, d, tm, t_min, bias, bug in shadows:
            K.stream_anyhit(rows, sph, pln, o, d, tm, t_min, bias, bug,
                            boxes=boxes)

    def run_bvh_shadow():
        for o, d, tm, t_min, bias, bug in shadows:
            B.bvh_anyhit(*bvh, sph, pln, o, d, tm, t_min, bias, bug)

    res["shadow"] = dict(
        calls=len(shadows), lanes=n_lanes, occluded=n_occ,
        wrapper_ms=cuda_ms(run_shadow, 3),
        device_ms=device_ms(run_shadow, 3, ("cull_anyhit_kernel",)),
        bvh_device_ms=device_ms(run_bvh_shadow, 3, ("bvh_anyhit_kernel",)),
        **bvh_bounds(sum(nbytes(o, d, tm) + o.shape[0]
                         for o, d, tm, *_ in shadows), len(shadows),
                     sum(occlusion_ops(pack, o, d, tm, t_min, bias)["ops"]
                         for o, d, tm, t_min, bias, _ in shadows)),
        cull=cull_stats(torch.cat(counts), pack.wtri_v0.shape[0]),
        **bound(sum(nbytes(rows, *boxes, sph, pln, o, d, tm) + o.shape[0]
                    for o, d, tm, *_ in shadows),
                sum(occlusion_ops(pack, o, d, tm, t_min, bias)["ops"]
                    for o, d, tm, t_min, bias, _ in shadows)))

    return res, lanes, n_lanes


def compare_flat(pack, cam, dev, calls, shadows, grid, grid_cam):
    """Kernels 1 and 2 on a bench frame's calls (compare_frame_calls), and
    kernel 1 against its twin, key for key, on 480K rays from the level-0
    hits toward the synthetic 8192-face height field `grid` (`aimed`), with
    per-ray cull counts, timed beside the BVH kernel on the same rays."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import analytic_tables, trace_route

    res, lanes, n_lanes = compare_frame_calls(pack, dev, calls, shadows,
                                              "bench")
    # The synthetic 8192-face mesh: the route's largest.

    check(trace_route(grid, True) == "stream"
          and grid.wtri_v0.shape[0] == K.STREAM_MAX_FACES,
          "grid: not an 8192-face mesh of the flat route")
    _, o, d, hit, _, _ = level0(grid, grid_cam, dev)
    o2, d2 = aimed(grid, o, d, hit, 4)
    t_init = torch.full((LANES,), BIG, device=dev)
    gs, gp = analytic_tables(grid)
    grows, gboxes = grid.stream_rows, flat_boxes(grid)
    counts = torch.empty((LANES, 3), dtype=torch.int32, device=dev)

    def gflat(counts=None):
        return K.stream_closest(grows, gs, gp, o2, d2, t_init, "both",
                                boxes=gboxes, counts=counts)

    t1, k1 = gflat(counts)
    t0, k0 = K.stream_closest_ref(grows, gs, gp, o2, d2, t_init, 2)
    compare_exact("stream_closest (8192 faces)", t1, k1, t0, k0)
    check(int((k0 >= 0).sum()) > LANES // 10, "grid: too few mesh hits")
    res["grid8192"] = dict(
        lanes=LANES, ms=cuda_ms(gflat, 5),
        bvh_ms=cuda_ms(lambda: B.bvh_closest(
            grid.bvh_pairs, grid.bvh_faces, grid.bvh_depth, gs, gp, o2, d2,
            t_init, "both"), 5),
        plain_ms=cuda_ms(lambda: K.stream_closest_ref(
            grows, gs, gp, o2, d2, t_init, 2), 1),
        mesh_hits=int((k0 >= 0).sum()),
        cull=cull_stats(counts, grid.wtri_v0.shape[0]),
        **op_bound(nbytes(grows, *gboxes, gs, gp, o2, d2, t_init) + LANES * 8,
                   closest_ops(grid, o2, d2, t_init, "both")))
    return res, lanes + LANES, n_lanes


def compare_limits(dev):
    """Kernels 1, 2 and 4-9 against their twins on tables of 40 spheres
    and 40 planes, past the 32 rows a kernel stages (the kernels read them
    in place): 480K level-0 camera rays and scattered rays from their hits
    (closest hits, each side) and shadow rays with t_max 1 or BIG (both
    plane forms), over the scene with the teapot (kernels 1, 2, 4-7) and
    without (8, 9). Returns the lanes compared."""
    import torch

    from bhraytracer_tpu_torch import scenes
    from bhraytracer_tpu_torch.ops import analytic as A
    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import cull as C
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops import stream_hbm as H
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables
    from bhraytracer_tpu_torch.scene.compile import compile_scene

    name = "spheres40_planes40"
    mesh = compile_scene(scenes.crowd_scene_desc(
        name, base=scenes.bench_scene_desc()), device=dev)
    free, cam = scenes.crowd_scene(name, dev)
    t_init = torch.full((LANES,), BIG, device=dev)
    tm = torch.where(torch.arange(LANES, device=dev) % 3 == 0, BIG, 1.0)
    bad, lanes, past = {}, 0, {0: 0, 1: 0}
    for p in (mesh, free):
        check((p.n_sph, p.n_pln) == (40, 40), "limit scene: not 40 + 40")
        _, o, d, hit, _, _ = level0(p, cam, dev)
        o2, d2 = scattered(o, d, hit, 5)
        sph, pln = analytic_tables(p)
        for oo, dd in ((o, d), (o2, d2)):
            for side in ("front", "both") if p is mesh else ("front", "back",
                                                           "both"):
                s = K.SIDES[side]
                if p is mesh:
                    t0, k0 = K.stream_closest_ref(p.stream_rows, sph, pln, oo,
                                                  dd, t_init, s)
                    tb, kb = B.bvh_closest_ref(p.bvh_faces, sph, pln, oo, dd,
                                               t_init, s)
                    runs = {
                        "bhrt_stream_closest": (K.stream_closest(
                            p.stream_rows, sph, pln, oo, dd, t_init, side,
                            boxes=flat_boxes(p)), (t0, k0)),
                        "bhrt_stream_closest_hbm": (H.stream_closest_hbm(
                            *C.cluster_tables(p), sph, pln, oo, dd, t_init,
                            side), (t0, k0)),
                        "bhrt_bvh_closest": (B.bvh_closest(
                            p.bvh_pairs, p.bvh_faces, p.bvh_depth, sph, pln,
                            oo, dd, t_init, side), (tb, kb))}
                else:
                    t0, k0 = A.analytic_closest_ref(sph, pln, oo, dd, s)
                    runs = {"bhrt_analytic_closest": (A.analytic_closest(
                        sph, pln, oo, dd, side), (t0, k0))}
                for name, ((t1, k1), (tr, kr)) in runs.items():
                    bad[name] = bad.get(name, 0) + exact_lanes(t1, k1, tr, kr)
                    lanes += LANES
                code = -(k0 >> 1) - 2
                for kind in (0, 1):  # rows past the 32 a kernel stages
                    past[kind] += int(((k0 <= -4) & (((code >> 1) & 1) == kind)
                                       & ((code >> 2) >= 32)).sum())
            for bug in (False, True):
                if p is mesh:
                    a0 = K.stream_anyhit_ref(p.stream_rows, sph, pln, oo, dd,
                                             tm, MESH_SHADOW_BIAS, 1e-5, bug)
                    ab = B.bvh_anyhit_ref(p.bvh_faces, sph, pln, oo, dd, tm,
                                          MESH_SHADOW_BIAS, 1e-5, bug)
                    runs = {
                        "bhrt_stream_anyhit": (K.stream_anyhit(
                            p.stream_rows, sph, pln, oo, dd, tm,
                            MESH_SHADOW_BIAS, 1e-5, bug,
                            boxes=flat_boxes(p)), a0),
                        "bhrt_stream_anyhit_hbm": (H.stream_anyhit_hbm(
                            *C.cluster_tables(p), sph, pln, oo, dd, tm,
                            MESH_SHADOW_BIAS, 1e-5, bug), a0),
                        "bhrt_bvh_anyhit": (B.bvh_anyhit(
                            p.bvh_pairs, p.bvh_faces, p.bvh_depth, sph, pln,
                            oo, dd, tm, MESH_SHADOW_BIAS, 1e-5, bug), ab)}
                else:
                    a0 = A.analytic_anyhit_ref(sph, pln, oo, dd, tm, 1e-5, bug)
                    runs = {"bhrt_analytic_anyhit": (A.analytic_anyhit(
                        sph, pln, oo, dd, tm, 1e-5, bug), a0)}
                check(bool(a0.any()), "limit scene: no occluded lane")
                for name, (a1, ar) in runs.items():
                    bad[name] = bad.get(name, 0) + int((a1 != ar).sum())
                    lanes += LANES
    check(all(v == 0 for v in bad.values()),
          f"40 spheres and 40 planes: lanes differing by kernel {bad}")
    check(past[0] > 0 and past[1] > 0,
          f"40 spheres and 40 planes: no hit past row 32 ({past})")
    return dict(lanes_compared=lanes, kernels=sorted(bad),
                hits_past_row_32=past)


def limit_renders_vs_cpu(dev):
    """The scenes beyond the fused shade kernel's tables (LIMIT_SCENES),
    and the 9-light scene with a photon map (one map, built on the card,
    for both), rendered at 64x48 on the card and on the CPU with
    small_render_vs_cpu's bounds; and the 204,800-face height field above
    the grouped kernels' limit: every trace through the BVH kernels, the
    card's closest hits of 480K scattered rays against the BVH twin on
    SUBSET lanes, and a 64x48 render on the card with its launches."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch import scenes
    from bhraytracer_tpu_torch.models.photonmap import build_photon_map
    from bhraytracer_tpu_torch.ops import bvh as BV
    from bhraytracer_tpu_torch.ops import kernels
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.shade import shade_setup_supported
    from bhraytracer_tpu_torch.ops.trace import (
        analytic_tables,
        trace_closest,
        trace_route,
    )

    res = {}
    names = list(scenes.LIMIT_SCENES) + ["lights9_photon"]
    for name in names:
        photon = name.endswith("_photon")
        cfg = B.RenderConfig(**SMALL, chunk_rays=64 * 48, **(
            dict(use_photon_map=True, photon_count=1 << 14) if photon else {}))
        out, pmap = [], None
        for device in (dev, "cpu"):
            pack, cam = scenes.crowd_scene(name.replace("_photon", ""), device)
            check(not shade_setup_supported(pack, cfg, None),
                  f"{name}: within the fused shade kernel's tables")
            cam.width, cam.height = 64, 48
            if photon:
                pmap = (build_photon_map(pack, cfg, seed=0, batch=1 << 16)
                        if pmap is None else pmap.to(device))
            img, st = B.render_image(pack, cam, cfg, seed=0,
                                     return_stats=True, photon_map=pmap)
            out.append((img.cpu(), st))
        (g, sg), (c, sc) = out
        check(bool(torch.isfinite(g).all()), f"{name}: GPU image not finite")
        within = float(((g - c).abs().amax(-1) <= 1e-4).float().mean())
        mean_abs = float((g - c).abs().mean())
        res[name] = dict(size="64x48", within_1e4=within, mean_abs=mean_abs,
                         segs_gpu=sg.segments, segs_cpu=sc.segments)
        check(within >= 0.99 and mean_abs < 1e-3,
              f"{name}: GPU vs CPU render {within:.4f} within 1e-4, "
              f"mean abs {mean_abs:.2e}")
        check(sg.segments == sc.segments,
              f"{name}: segments {sg.segments} (GPU) vs {sc.segments} (CPU)")

    grid, cam = scenes.grid_scene(device=dev)
    n_faces = grid.wtri_v0.shape[0]
    check(n_faces == 204800 and trace_route(grid, True)
          == trace_route(grid, False) == "bvh", "grid: not on the BVH route")
    _, o, d, hit, _, _ = level0(grid, cam, dev)
    o2, d2 = scattered(o, d, hit, 6)
    idx = subset(dev)
    h = trace_closest(grid, o2, d2, "both")  # reorder=True: levels >= 1
    sph, pln = analytic_tables(grid)
    t0, k0 = BV.bvh_closest_ref(grid.bvh_faces, sph, pln, o2[idx], d2[idx],
                                torch.full((SUBSET,), BIG, device=dev), 2)
    face = torch.where(k0 >= 0, k0 >> 1, -1)
    check(bool(torch.equal(h.t[idx], t0) and torch.equal(h.face[idx], face)),
          "grid: the BVH route's closest hits differ from the twin")
    check(int((face >= 0).sum()) > 100, "grid: too few mesh hits")
    cam.width, cam.height = 64, 48
    kernels.LAUNCHES.clear()
    img, st = B.render_image(grid, cam, B.RenderConfig(**SMALL,
                                                       chunk_rays=64 * 48),
                             seed=0, return_stats=True)
    launches = dict(kernels.LAUNCHES)
    check(bool(torch.isfinite(img).all()) and st.segments > 0,
          "grid: render not finite")
    check(launches.get("bhrt_bvh_closest", 0) > 0
          and not any(launches.get(k, 0) for k in FLAT + HBM),
          f"grid: launches other than the BVH route's {launches}")
    res["grid204800"] = dict(faces=n_faces, lanes_compared=SUBSET,
                             mesh_hits=int((face >= 0).sum()),
                             render="64x48", segments=st.segments,
                             launches=launches)
    return res


def analytic_times(sph, pln, o, d) -> dict:
    """Kernel 8 on rays o, d (side both): through its wrapper (CUDA events
    around back-to-back calls, which the host's per-call time bounds at
    small batches) and on the device (the profiler's kernel time)."""
    from bhraytracer_tpu_torch.ops import analytic as A

    def run():
        return A.analytic_closest(sph, pln, o, d, "both")

    n = o.shape[0]
    return dict(lanes=n, wrapper_ms=cuda_ms(run, 50),
                device_ms=device_ms(run, 20, ("analytic_closest_kernel",)),
                **bound(nbytes(sph, pln, o, d) + n * 8, n * (
                    sph.shape[0] * SPHERE_OPS + pln.shape[0] * PLANE_OPS)))


def record_analytic_shadows(pack, cam, pmap):
    """The shadow calls (kernel 9) of one photon frame at 800x600 with the
    `_photon_leg` config, gathering from `pmap` as render_image does: (o,
    d, t_max, ana_bias, plane_world_bug) of each, cloned."""
    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.ops import trace as T

    calls = []
    anyhit = T.analytic_anyhit

    def record(sph, pln, o, d, t_max, ana_bias=0.0, plane_world_bug=False):
        calls.append((o.clone(), d.clone(), t_max.clone(), ana_bias,
                      plane_world_bug))
        return anyhit(sph, pln, o, d, t_max, ana_bias, plane_world_bug)

    T.analytic_anyhit = record
    try:
        cam.width, cam.height = 800, 600
        B.render_image(pack, cam, B.RenderConfig(**PHOTON), seed=1,
                       photon_map=pmap)
    finally:
        T.analytic_anyhit = anyhit
    return calls


def analytic_shadow_times(sph, pln, shadow, bias, calls) -> dict:
    """Kernel 9 on the 480K level-0 shadow rays `shadow` (o, d, t_max) and
    over a photon frame's shadow calls (record_analytic_shadows): through
    its wrapper and on the device."""
    from bhraytracer_tpu_torch.ops import analytic as A

    def run():
        return A.analytic_anyhit(sph, pln, *shadow, bias)

    def run_calls():
        for o, d, tm, b, bug in calls:
            A.analytic_anyhit(sph, pln, o, d, tm, b, bug)

    def ops(n):
        return n * (sph.shape[0] * SPHERE_OPS + pln.shape[0] * PLANE_OPS)

    name = ("analytic_anyhit",)
    n = shadow[0].shape[0]
    return dict(level0=dict(lanes=n, ms=cuda_ms(run, 20),
                            device_ms=device_ms(run, 20, name),
                            **bound(nbytes(sph, pln, *shadow) + n, ops(n))),
                frame_calls=dict(calls=len(calls),
                                 lanes=sum(c[0].shape[0] for c in calls),
                                 wrapper_ms=cuda_ms(run_calls, 5),
                                 device_ms=device_ms(run_calls, 5, name),
                                 **bound(sum(nbytes(sph, pln, *c[:3])
                                             + c[0].shape[0] for c in calls),
                                         sum(ops(c[0].shape[0])
                                             for c in calls))))


def kernel9_times(dev, card, repeats: int) -> dict:
    """Kernel 9 settled against its bound: on the tiny scene's 480K
    level-0 shadow rays and over a photon frame's shadow calls
    (record_analytic_shadows, the map built with PHOTON at seed 1), the
    kernel held bit for bit to its twin on each, then its device time
    (the profiler's, over 20 calls and over 5 passes of the calls) taken
    `repeats` times: every value, the median, the bound and the share of
    the bound. Reads only APIs older checkouts have, so a copy of this
    script in one times that checkout's kernel."""
    import statistics

    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.models.photonmap import build_photon_map
    from bhraytracer_tpu_torch.ops import analytic as A
    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops.trace import analytic_tables
    from bhraytracer_tpu_torch.scenes import tiny_scene

    tiny, cam = tiny_scene(dev)
    cfg, o, d, hit, shade, u_tab = level0(tiny, cam, dev)
    fo = S.shade_setup(tiny, cfg, o, d, hit, shade, u_tab)
    shadow = tuple(x.contiguous() for x in (fo.shadow_o, fo.shadow_d,
                                            fo.shadow_tmax))
    sph, pln = analytic_tables(tiny)
    pmap = build_photon_map(tiny, B.RenderConfig(**PHOTON), seed=1)
    calls = record_analytic_shadows(tiny, cam, pmap)
    bias = cfg.shadow_bias
    for oo, dd, tt, b, bug in [shadow + (bias, False)] + calls:
        check(torch.equal(A.analytic_anyhit(sph, pln, oo, dd, tt, b, bug),
                          A.analytic_anyhit_ref(sph, pln, oo, dd, tt, b,
                                                bug)),
              "kernel 9 differs from its twin")
    base = analytic_shadow_times(sph, pln, shadow, bias, calls)
    name = ("analytic_anyhit",)

    def run():
        A.analytic_anyhit(sph, pln, *shadow, bias)

    def run_calls():
        for oo, dd, tt, b, bug in calls:
            A.analytic_anyhit(sph, pln, oo, dd, tt, b, bug)

    out = {"card": card}
    for part, fn, reps in (("level0", run, 20), ("frame_calls", run_calls,
                                                 5)):
        ms = [device_ms(fn, reps, name) for _ in range(repeats)]
        med = statistics.median(ms)
        out[part] = dict({k: base[part][k] for k in (
            "lanes", "bound_ms", "bound_by")},
            calls=len(calls) if part == "frame_calls" else 1,
            device_ms=ms, median_ms=med,
            bound_share=base[part]["bound_ms"] / med)
    return out


def save_inputs(dev, path):
    """Write the inputs of kernels 1-5 and 7-9 at their main paths' shapes
    (see the module doc) to `path`."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch import scenes
    from bhraytracer_tpu_torch.models.photonmap import build_photon_map
    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import analytic_tables, coherence_order

    def shadow_rays(p, cfg, o, d, hit, shade, u_tab):
        fo = S.shade_setup(p, cfg, o, d, hit, shade, u_tab)
        return tuple(x.contiguous() for x in (fo.shadow_o, fo.shadow_d,
                                              fo.shadow_tmax))

    pack, cam = scenes.bench_scene(dev)
    cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev)
    bench = dict(zip(("o", "d"), scattered(o, d, hit, 0)))
    level = dict(o=o, d=d, hit=tuple(hit), shade=shade, u_tab=u_tab,
                 shadow=shadow_rays(pack, cfg, o, d, hit, shade, u_tab))
    big, big_cam = scenes.bigmesh_scene(dev)
    cfg_g, o, d, hit, shade, u_tab = level0(big, big_cam, dev, BIGMESH)
    o2, d2 = scattered(o, d, hit, 1)
    big_bvh = dict(o=o, d=d, o2=o2, d2=d2, shadow_bias=cfg_g.shadow_bias,
                   shadow=shadow_rays(big, cfg_g, o, d, hit, shade, u_tab))
    tm = torch.where(torch.arange(LANES, device=dev) % 3 == 0, BIG, 1.0)
    order = coherence_order(big, o2, d2, tm)
    grid, gcam = scenes.grid_scene(64, dev)
    _, o, d, hit, _, _ = level0(grid, gcam, dev)
    grid_in = dict(zip(("o", "d"), aimed(grid, o, d, hit, 4)))
    tiny, tcam = scenes.tiny_scene(dev)
    cfg_t, o, d, hit, shade, u_tab = level0(tiny, tcam, dev)
    o2t, d2t = scattered(o, d, hit, 2)
    tiny_shadow = shadow_rays(tiny, cfg_t, o, d, hit, shade, u_tab)
    pmap = build_photon_map(tiny, B.RenderConfig(**PHOTON), seed=1)
    photon_shadows = record_analytic_shadows(tiny, tcam, pmap)
    calls, shadows, _ = record_frame_calls(pack, cam)
    data = dict(
        t_init=torch.full((LANES,), BIG, device=dev),
        bench=dict(rows=pack.stream_rows, boxes=flat_boxes(pack),
                   tables=analytic_tables(pack), **bench),
        level0=level, calls=calls, shadow_calls=shadows,
        bigmesh_shadow=tuple(x[order].contiguous() for x in (o2, d2, tm)),
        bigmesh_bvh=big_bvh,
        grid=dict(rows=grid.stream_rows, boxes=flat_boxes(grid),
                  tables=analytic_tables(grid), **grid_in),
        tiny=dict(tables=analytic_tables(tiny), o=o2t, d=d2t,
                  shadow=tiny_shadow, shadow_bias=cfg_t.shadow_bias,
                  photon_shadow_calls=photon_shadows))
    torch.save(data, path)
    print(json.dumps({"saved": path, "calls": len(calls),
                      "shadow_calls": len(shadows),
                      "photon_shadow_calls": len(photon_shadows)}))


def time_inputs(dev, card, path):
    """Time kernels 1, 2, 3, 7 and 8 of this checkout on the inputs
    save_inputs wrote: kernel 1 on the scattered bench rays, on the bench
    frame's chain trips and levels and on the 8192-face mesh (the cluster
    boxes passed where the kernel takes them); kernel 2 on the 480K
    level-0 bench shadow rays and the frame's shadow calls (the boxes
    likewise); kernel 3 on the level-0 bench lanes through shade_setup,
    with its registers, stack and occupancy and the launches of one shade
    setup and one fused shade step; kernel 7 on the big-mesh scene's 480K
    sorted scattered rays, with its cull counts; kernel 8 at 480K and at
    32,768 lanes; kernel 9 on the tiny scene's 480K level-0 shadow rays and
    a photon frame's shadow calls; kernels 4 and 5 on the node table the
    checkout's wrapper reads (bvh_tabs), with their registers and
    occupancy: kernel 4 on the 480K level-0 and scattered bench rays and
    big-mesh rays and on the bench frame's chain trips and levels, kernel
    5 on the level-0 shadow rays of both scenes and the bench frame's
    shadow calls."""
    import inspect

    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch import scenes
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops import bvh as BV
    from bhraytracer_tpu_torch.ops import cull as C
    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops import stream_hbm as H
    from bhraytracer_tpu_torch.ops.trace import (
        MESH_SHADOW_BIAS,
        Hit,
        analytic_tables,
    )

    data = torch.load(path, map_location=dev)
    takes_boxes = "boxes" in inspect.signature(K.stream_closest).parameters
    k2_boxes = "boxes" in inspect.signature(K.stream_anyhit).parameters
    t_init = data["t_init"]
    out = {"tree": REPO, "card": card, "kernel1_culls": takes_boxes,
           "kernel2_culls": k2_boxes}

    def flat(part, o, d, ti, side):
        kw = dict(boxes=part["boxes"]) if takes_boxes else {}
        return K.stream_closest(part["rows"], *part["tables"], o, d, ti, side,
                                **kw)

    for name in ("bench", "grid"):
        part = data[name]

        def run(part=part):
            return flat(part, part["o"], part["d"], t_init, "both")

        out[f"flat_{name}"] = dict(
            ms=cuda_ms(run, 5), device_ms=device_ms(run, 5, ("closest_kernel",)))
    for kind in ("chain", "levels"):
        calls = [c for c in data["calls"] if (c[3] == "both") == (kind == "chain")]

        def run_calls(calls=calls):
            for o, d, ti, side in calls:
                flat(data["bench"], o, d, ti, side)

        out[f"flat_{kind}"] = dict(
            calls=len(calls), wrapper_ms=cuda_ms(run_calls, 3),
            device_ms=device_ms(run_calls, 3, ("closest_kernel",)))

    part = data["bench"]
    cfg = render_config(HEADLINE)

    def shadow(o, d, tm, t_min=MESH_SHADOW_BIAS, bias=cfg.shadow_bias,
               bug=False):
        kw = dict(boxes=part["boxes"]) if k2_boxes else {}
        return K.stream_anyhit(part["rows"], *part["tables"], o, d, tm, t_min,
                               bias, bug, **kw)

    so, sd, stm = data["level0"]["shadow"]
    out["shadow_level0"] = dict(
        ms=cuda_ms(lambda: shadow(so, sd, stm), 5),
        device_ms=device_ms(lambda: shadow(so, sd, stm), 5,
                            ("anyhit_kernel",)))

    def run_shadows():
        for o, d, tm, t_min, bias, bug in data["shadow_calls"]:
            shadow(o, d, tm, t_min, bias, bug)

    out["shadow_calls"] = dict(
        calls=len(data["shadow_calls"]), wrapper_ms=cuda_ms(run_shadows, 3),
        device_ms=device_ms(run_shadows, 3, ("anyhit_kernel",)))

    pack, _ = scenes.bench_scene(dev)
    lv = data["level0"]
    hit = Hit(*lv["hit"])

    def shade():
        return S.shade_setup(pack, cfg, lv["o"], lv["d"], hit, lv["shade"],
                             lv["u_tab"])

    out["shade"] = dict(
        ms=cuda_ms(shade, 5), device_ms=device_ms(shade, 5, ("shade_kernel",)),
        launches_shade_setup=launch_count(shade),
        launches_fused_step=launch_count(lambda: PT._shade_fused(
            pack, cfg, lv["o"], lv["d"], hit, lv["shade"], lv["u_tab"],
            False)),
        ptxas=ptxas_report("shade_kernel"),
        occupancy=trace_args(shade, "shade_kernel"))

    big, _ = scenes.bigmesh_scene(dev)
    bo, bd, btm = data["bigmesh_shadow"]
    tabs, (bs, bp) = C.cluster_tables(big), analytic_tables(big)

    def hbm(counts=None):
        return H.stream_anyhit_hbm(*tabs, bs, bp, bo, bd, btm,
                                   MESH_SHADOW_BIAS,
                                   B.RenderConfig(**BIGMESH).shadow_bias,
                                   counts=counts)

    counts = torch.empty((LANES, 3), dtype=torch.int32, device=dev)
    hbm(counts)
    out["hbm_anyhit"] = dict(
        ms=cuda_ms(hbm, 5), device_ms=device_ms(hbm, 5, ("anyhit_kernel",)),
        cull=cull_stats(counts, big.wtri_v0.shape[0]))

    tiny = data["tiny"]
    out["analytic_480k"] = analytic_times(*tiny["tables"], tiny["o"],
                                          tiny["d"])
    n = PHOTON_BATCH_LANES
    out["analytic_32768"] = analytic_times(
        *tiny["tables"], tiny["o"][:n].contiguous(), tiny["d"][:n].contiguous())
    out["analytic_anyhit"] = analytic_shadow_times(
        *tiny["tables"], tiny["shadow"], tiny["shadow_bias"],
        tiny["photon_shadow_calls"])

    # Kernels 4 and 5 on the node table this checkout's wrapper reads.
    sph, pln = analytic_tables(pack)
    tabs = bvh_tabs(pack)
    gb = data["bigmesh_bvh"]
    gtabs, (gs, gp) = bvh_tabs(big), analytic_tables(big)
    out["bvh_table"] = dict(rows=list(tabs[0].shape),
                            bytes=tabs[0].numel() * 4)
    out["bvh_closest"] = dict(
        camera=bvh_times(tabs, sph, pln, lv["o"], lv["d"], t_init, "front"),
        scattered=bvh_times(tabs, sph, pln, part["o"], part["d"], t_init,
                            "both"),
        bigmesh_camera=bvh_times(gtabs, gs, gp, gb["o"], gb["d"], t_init,
                                 "front"),
        bigmesh_scattered=bvh_times(gtabs, gs, gp, gb["o2"], gb["d2"],
                                    t_init, "both"))
    for kind in ("chain", "levels"):
        calls = [c for c in data["calls"]
                 if (c[3] == "both") == (kind == "chain")]

        def run_bvh(calls=calls):
            for o, d, ti, side in calls:
                BV.bvh_closest(*tabs, sph, pln, o, d, ti, side)

        out["bvh_closest"][f"frame_{kind}"] = dict(
            calls=len(calls), wrapper_ms=cuda_ms(run_bvh, 3),
            device_ms=device_ms(run_bvh, 3, ("bvh_closest_kernel",)))
    shadow = (MESH_SHADOW_BIAS, cfg.shadow_bias, False)

    def run_bvh_shadows():
        for o, d, tm, t_min, bias, bug in data["shadow_calls"]:
            BV.bvh_anyhit(*tabs, sph, pln, o, d, tm, t_min, bias, bug)

    out["bvh_anyhit"] = dict(
        level0=bvh_times(tabs, sph, pln, so, sd, stm, shadow=shadow),
        bigmesh_level0=bvh_times(gtabs, gs, gp, *gb["shadow"], shadow=(
            MESH_SHADOW_BIAS, gb["shadow_bias"], False)),
        frame_calls=dict(
            calls=len(data["shadow_calls"]),
            wrapper_ms=cuda_ms(run_bvh_shadows, 3),
            device_ms=device_ms(run_bvh_shadows, 3, ("bvh_anyhit_kernel",))))
    for kern, run in (
            ("bvh_closest_kernel", lambda: BV.bvh_closest(
                *tabs, sph, pln, lv["o"], lv["d"], t_init, "front")),
            ("bvh_anyhit_kernel", lambda: BV.bvh_anyhit(
                *tabs, sph, pln, so, sd, stm, *shadow))):
        out[kern] = dict(ptxas=ptxas_report(kern),
                         occupancy=trace_args(run, kern))
    print(json.dumps({"timing": out}))


def grid_pairs(pmap, qp) -> int:
    """Photon pair tests the queries need under the grid index: the photons
    the buckets of each query's 27 neighbouring cells hold (the work of the
    XLA fold, bhraytracer_tpu/models/photonmap.py:311-355), counted on the
    host from bucket_start. Queries off the scene (misses) need none."""
    import torch

    from bhraytracer_tpu_torch.models.photonmap import _hash_cells

    pos = qp.cpu()
    pos = pos[torch.isfinite(pos).all(1) & (pos.abs() < 1e6).all(1)]
    start = pmap.bucket_start.cpu().long()
    base = torch.floor(pos / pmap.radius).to(torch.int64)
    total = 0
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                b = _hash_cells(base + torch.tensor([ox, oy, oz]),
                                pmap.n_buckets)
                total += int((start[b + 1] - start[b]).sum())
    return total


def photon_stats(counts, pairs: int, n_photons: int) -> dict:
    """What the tile cull did, from a sweep's per-lane counts (box tests,
    pair tests, and its warp's pair-test slots, which every lane of a
    32-lane tile holds): means per lane, against the grid's pairs and brute
    force, and the share of lanes busy in the warps' pair work."""
    c = counts.double()
    box, pair, slot = c.sum(0).tolist()
    n = counts.shape[0]
    return dict(box_tests_per_lane=box / n, pair_tests_per_lane=pair / n,
                max_pair_slots_per_warp=int(counts[:, 2].max()),
                grid_pairs_per_lane=pairs / n, brute_force_per_lane=n_photons,
                pair_tests=int(pair), grid_pairs=pairs,
                pair_tests_over_grid=pair / max(pairs, 1),
                pair_slots_per_warp=float(c[:, 2].mean()),
                busy_lane_share=pair / slot if slot else 0.0)


def skewed_map(qp, dev, n: int, radius: float):
    """A synthetic caustic map of n photons over the query points qp (seeded
    on the card): half at query points jittered by the radius, half in a
    focal cluster (sigma radius / 4) around one of them."""
    import torch

    from bhraytracer_tpu_torch.models.photonmap import build_grid_index

    gen = torch.Generator(device=dev).manual_seed(5)
    ok = torch.isfinite(qp).all(1) & (qp.abs() < 1e3).all(1)
    pts = qp[ok]
    pick = torch.randint(pts.shape[0], (n,), generator=gen, device=dev)
    pos = pts[pick] + radius * torch.randn((n, 3), generator=gen, device=dev)
    focus = pts[pts.shape[0] // 2]
    pos[n // 2:] = focus + radius / 4 * torch.randn(
        (n - n // 2, 3), generator=gen, device=dev)
    dirn = torch.randn((n, 3), generator=gen, device=dev)
    dirn = dirn / dirn.norm(dim=1, keepdim=True)
    power = torch.rand((n, 3), generator=gen, device=dev) / n
    return build_grid_index(pos, dirn, power, radius)


def spatial_order(tiles, pos):
    """The lanes in the Morton order of their positions on the map's grid
    (the tile table's key), misses last: how the gather would sort its
    queries, timed and held in compare_photon. The port does not sort."""
    import torch

    from bhraytracer_tpu_torch.ops.photon import spatial_keys

    key = spatial_keys(pos, tiles.supers[:, 0:3].amin(0),
                       tiles.supers[:, 3:6].amax(0))
    key = torch.where(torch.isfinite(pos).all(1), key,
                      torch.iinfo(torch.int32).max)
    return torch.argsort(key, stable=True)


def compare_photon(tiny, cam, dev, pmap):
    """Kernel 10 against its twin on the photon main path's map, with two
    query sets: the level-0 hit points and normals of the 480K camera rays,
    and the hit points of 480K scattered rays from them (the GI levels'
    kind), each also in a spatial (Morton) order of its lanes. The full
    sweep runs on every lane; the hist and final sweeps, with the brackets
    and thresholds the gather would give them, on SUBSET lanes, and with
    the gather's active mask on the SUBSET lanes and on every level-0 lane
    over k, as the main path runs them. Counts and bins must be equal; the
    float sums (summed in another order) within rtol 2e-5 and atol 1e-6 for
    the powers, 1e-5 for the direction sums, whose terms cancel. Runs with
    the per-lane counts show what the cull does (and must keep exactly the
    tiles tile_cull_ref keeps); tile sizes of TILE_SIZES are held to the
    twin and timed; a synthetic skewed map of 1 << 20 photons is held to
    the twin on 4096 lanes."""
    import numpy as np
    import torch

    from bhraytracer_tpu_torch.models import photonmap as PM
    from bhraytracer_tpu_torch.ops import photon as P
    from bhraytracer_tpu_torch.ops.trace import resolve_hit, trace_closest

    cfg, o, d, hit, _, _ = level0(tiny, cam, dev, PHOTON)
    surf = resolve_hit(tiny, o, d, hit)
    qp, qn = surf.p.contiguous(), surf.n.contiguous()
    o2, d2 = scattered(o, d, hit, 3)
    surf2 = resolve_hit(tiny, o2, d2, trace_closest(tiny, o2, d2, "front"))
    sp, sn = surf2.p.contiguous(), surf2.n.contiguous()
    r2 = pmap.radius * pmap.radius
    r2f, inv_w0 = float(np.float32(r2)), float(np.float32(16 / r2))
    zero = torch.zeros(LANES, device=dev)
    full = torch.full((LANES,), r2f, device=dev)
    tiles = pmap.tiles
    k = cfg.photon_gather_max
    idx = subset(dev)

    def close(what, a, b, atol):
        err = float((a - b).abs().max())
        ok = bool(torch.isclose(a, b, rtol=2e-5, atol=atol).all())
        check(ok, f"photon_sweep {what}: max abs err {err}")
        return err

    compared = [0]

    def held(what, got, want):
        """Kernel outputs against the twin's: counts and bins equal, sums
        close. Returns the largest sum error."""
        errs = []
        compared[0] += next(x for x in want if x is not None).shape[0]
        for name, a, b in zip(("irr", "ds", "cnt", "hist"), got, want):
            check((a is None) == (b is None), f"{what}: {name} written by one")
            if a is None:
                continue
            if a.dtype == torch.int32:
                check(bool(torch.equal(a, b)), f"photon_sweep {what}: {name} "
                      f"differs on {int((a != b).reshape(a.shape[0], -1).any(1).sum())} lanes")
            else:
                errs.append(close(f"{what} {name}", a, b,
                                  1e-6 if name == "irr" else 1e-5))
        return max(errs, default=0.0)

    def held_masked(what, mode, tb, p, n, a, b, need):
        """The sweep with the gather's active mask: zeros off the mask, and
        on the mask's lanes the twin's result on those lanes alone."""
        check(int(need.sum()) > 0, f"photon_sweep {what}: no lane over k")
        got = P.sweep(mode, tb, p, n, a, b, r2f, inv_w0, active=need)
        for x in got:
            if x is not None:
                check(bool((x[~need] == 0).all()), f"photon_sweep {what}: "
                      "a masked lane is not zero")
        sel = need.nonzero()[:, 0]
        want = P.sweep_ref(P.MODES[mode], tb.rows, p[sel], n[sel], a[sel],
                           b[sel], r2f, inv_w0)
        return held(what, [None if x is None else x[sel] for x in got], want)

    def brackets(p, n, cnt, hist, sel):
        """The gather's hist bracket (lo, hi) and final threshold t on the
        lanes sel, from a full sweep's cnt and hist (one hist pass)."""
        below, lo, hi = PM.pick_bin(hist[sel], torch.zeros_like(cnt[sel]),
                                    zero[sel], full[sel], k)
        h = P.sweep("hist", tiles, p[sel].contiguous(), n[sel].contiguous(),
                    lo, hi, r2f, inv_w0)[3]
        _, tlo, thi = PM.pick_bin(h, below, lo, hi, k)
        return lo, hi, torch.where(cnt[sel] > k, thi, r2f)

    errs, perms, stats, refs = [], {}, {}, {}
    for name, p, n in (("level0", qp, qn), ("scattered", sp, sn)):
        ref = refs[name] = P.sweep_ref(0, tiles.rows, p, n, zero, full, r2f,
                                       inv_w0)
        check(int(ref[2].sum()) > 0, f"photon_sweep {name}: no photon in range")
        errs.append(held(f"full ({name})", P.sweep(
            "full", tiles, p, n, zero, full, r2f, inv_w0), ref))
        perm = perms[name] = spatial_order(tiles, p)
        errs.append(held(f"full ({name}, sorted lanes)", P.sweep(
            "full", tiles, p[perm], n[perm], zero, full, r2f, inv_w0),
            [x[perm] for x in ref]))
        cnt, hist = ref[2], ref[3]
        lo, hi, t = brackets(p, n, cnt, hist, idx)
        ps, ns = p[idx].contiguous(), n[idx].contiguous()
        need = cnt[idx] > k
        for mode, a, b in (("hist", lo, hi), ("final", t, full[idx])):
            want = P.sweep_ref(P.MODES[mode], tiles.rows, ps, ns, a, b, r2f,
                               inv_w0)
            check(mode == "final" or int(want[3].sum()) > 0,
                  f"photon_sweep {mode} ({name}): empty bins")
            errs.append(held(f"{mode} ({name})", P.sweep(
                mode, tiles, ps, ns, a, b, r2f, inv_w0), want))
            if need.any():
                errs.append(held_masked(f"{mode} ({name}, masked)", mode,
                                        tiles, ps, ns, a, b, need))
        # The cull's counts: each lane tests exactly the tiles the twin of
        # the cull keeps, and the run with counts gives the same result.
        counts = torch.empty((LANES, 3), dtype=torch.int32, device=dev)
        out = P.sweep("full", tiles, p, n, zero, full, r2f, inv_w0,
                      counts=counts)
        check(bool(torch.equal(out[2], cnt) and torch.equal(out[3], hist)),
              f"photon_sweep {name}: a run with counts gave another result")
        lanes, _ = P.tile_cull_ref(0, tiles, p[idx], zero[idx], full[idx], r2f)
        kept = torch.bincount(lanes, minlength=SUBSET) * tiles.tile
        check(bool(torch.equal(counts[idx, 1].long(), kept)),
              f"photon_sweep {name}: pair tests differ from tile_cull_ref's")
        pairs = grid_pairs(pmap, p)
        stats[name] = photon_stats(counts, pairs, pmap.rows.shape[0])
        stats[name]["lanes_over_k"] = int((cnt > k).sum())

    # The main path's shape: the gather's masked hist and final sweeps on
    # every level-0 lane over k, with its brackets (one hist pass).
    cnt, hist = refs["level0"][2], refs["level0"][3]
    need = cnt > k
    below, lo, hi = PM.pick_bin(hist, torch.zeros_like(cnt), zero, full, k)
    errs.append(held_masked("hist (level0, every lane over k)", "hist", tiles,
                            qp, qn, lo, hi, need))
    h = P.sweep("hist", tiles, qp, qn, lo, hi, r2f, inv_w0, active=need)[3]
    t = torch.where(need, PM.pick_bin(h, below, lo, hi, k)[2], r2f)
    errs.append(held_masked("final (level0, every lane over k)", "final",
                            tiles, qp, qn, t, full, need))

    # Tile sizes: the same sweeps from tables of other tiles, held and
    # timed (and the gather's masked hist and final sweeps).
    sizes = {}
    for size in TILE_SIZES:
        tb = P.tile_table(pmap.rows, size)
        got = P.sweep("full", tb, qp, qn, zero, full, r2f, inv_w0)
        errs.append(held(f"full (tile {size})", got, refs["level0"]))
        sizes[size] = dict(
            full_ms=cuda_ms(lambda: P.sweep("full", tb, qp, qn, zero, full,
                                            r2f, inv_w0), 5),
            hist_main_ms=cuda_ms(lambda: P.sweep(
                "hist", tb, qp, qn, lo, hi, r2f, inv_w0, active=need), 5),
            final_main_ms=cuda_ms(lambda: P.sweep(
                "final", tb, qp, qn, t, full, r2f, inv_w0, active=need), 5),
            scattered_full_ms=cuda_ms(lambda: P.sweep(
                "full", tb, sp, sn, zero, full, r2f, inv_w0), 5))

    # The synthetic skewed map: no size refusal, and held to the twin.
    big = skewed_map(qp, dev, 1 << 20, pmap.radius)
    sel = idx[::4]
    bp, bn = qp[sel].contiguous(), qn[sel].contiguous()
    z, f = zero[sel], full[sel]
    ref = P.sweep_ref(0, big.tiles.rows, bp, bn, z, f, r2f, inv_w0)
    check(int(ref[2].max()) > 10000, "skewed map: no dense lane")
    errs.append(held("full (1 << 20 photons)", P.sweep(
        "full", big.tiles, bp, bn, z, f, r2f, inv_w0), ref))
    _, blo, bhi = PM.pick_bin(ref[3], torch.zeros_like(ref[2]), z, f, k)
    bt = torch.where(ref[2] > k, bhi, r2f)
    for mode, a, b in (("hist", blo, bhi), ("final", bt, f)):
        errs.append(held(f"{mode} (1 << 20 photons)", P.sweep(
            mode, big.tiles, bp, bn, a, b, r2f, inv_w0),
            P.sweep_ref(P.MODES[mode], big.tiles.rows, bp, bn, a, b, r2f,
                        inv_w0)))
        errs.append(held_masked(f"{mode} (1 << 20 photons, masked)", mode,
                                big.tiles, bp, bn, a, b, ref[2] > k))
    skewed = dict(photons=big.rows.shape[0], lanes=int(sel.numel()),
                  largest_count=int(ref[2].max()), cell_cap=big.cell_cap,
                  tiles=big.tile_boxes.shape[0],
                  ms=cuda_ms(lambda: P.sweep("full", big.tiles, bp, bn, z, f,
                                             r2f, inv_w0), 3))

    # Times. ms / hist_ms / final_ms: every lane over the whole radius, as
    # earlier kernels were timed; *_main_ms: the gather's brackets and mask.
    def gather(p, n):
        return PM.gather_irradiance(pmap, p, n, k=k)

    def sort(p, n):  # what sorting its queries would cost the gather
        perm = spatial_order(tiles, p)
        return p[perm], n[perm]

    qs = tuple(x[perms["level0"]] for x in (qp, qn))
    ss = tuple(x[perms["scattered"]] for x in (sp, sn))
    dense = cnt > DENSE
    times = dict(
        dense_lanes=int(dense.sum()),
        dense_full_ms=cuda_ms(lambda: P.sweep("full", tiles, qp, qn, zero, full,
                                              r2f, inv_w0, active=dense), 5),
        hist_main_ms=cuda_ms(lambda: P.sweep("hist", tiles, qp, qn, lo, hi,
                                             r2f, inv_w0, active=need), 5),
        hist_unmasked_ms=cuda_ms(lambda: P.sweep("hist", tiles, qp, qn, lo, hi,
                                                 r2f, inv_w0), 5),
        final_main_ms=cuda_ms(lambda: P.sweep("final", tiles, qp, qn, t, full,
                                              r2f, inv_w0, active=need), 5),
        pick_bin_ms=cuda_ms(lambda: PM.pick_bin(hist, below, lo, hi, k), 5),
        sort_ms=cuda_ms(lambda: sort(qp, qn), 5),
        full_sorted_ms=cuda_ms(lambda: P.sweep(
            "full", tiles, *qs, zero, full, r2f, inv_w0), 5),
        scattered_full_ms=cuda_ms(lambda: P.sweep(
            "full", tiles, sp, sn, zero, full, r2f, inv_w0), 5),
        scattered_full_sorted_ms=cuda_ms(lambda: P.sweep(
            "full", tiles, *ss, zero, full, r2f, inv_w0), 5),
        gather_ms=cuda_ms(lambda: gather(qp, qn), 5),
        scattered_gather_ms=cuda_ms(lambda: gather(sp, sn), 5),
        tile_sizes=sizes, skewed_map=skewed)
    out_bytes = LANES * (24 + 4 + 64)
    pairs = stats["level0"]["pair_tests"]
    return {"bhrt_photon_sweep": dict(
        max_abs_err=max(errs), lanes_compared=compared[0],
        ms=cuda_ms(lambda: P.sweep("full", tiles, qp, qn, zero, full, r2f,
                                   inv_w0), 5),
        hist_ms=cuda_ms(lambda: P.sweep("hist", tiles, qp, qn, zero, full,
                                        r2f, inv_w0), 5),
        final_ms=cuda_ms(lambda: P.sweep("final", tiles, qp, qn, full, full,
                                         r2f, inv_w0), 5),
        plain_ms=cuda_ms(lambda: P.sweep_ref(0, tiles.rows, qp, qn, zero, full,
                                             r2f, inv_w0), 1),
        plain_lanes=LANES,
        shape=f"480K level-0 hit points x {pmap.rows.shape[0]} photons, full",
        photons=pmap.rows.shape[0], tile=tiles.tile,
        lanes_over_k=stats["level0"]["lanes_over_k"],
        **bound(nbytes(*tiles, qp, qn, zero, full) + out_bytes,
                PAIR_OPS * stats["level0"]["grid_pairs"]),
        grid_pair_tests=stats["level0"]["grid_pairs"], pair_tests=pairs,
        cull=stats, **times)}


def render_main_path(pack, cam, dev, cfg_kw, name):
    """One main path at 800x600: warm, then timed with the launch counters
    from 0 just before it and read just after, and the device memory's
    peak over the timed call."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.ops import kernels

    cfg = render_config(cfg_kw)
    cam.width, cam.height = 800, 600
    B.render_image(pack, cam, cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    img, st = B.render_image(pack, cam, cfg, seed=1, return_stats=True)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    img = img.cpu()
    t_image = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_chunks = -(-800 * 600 // cfg.chunk_rays)
    check(tuple(img.shape) == (600, 800, 3), f"{name}: image shape "
          f"{tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{name}: image not finite")
    check(float(img.std()) > 1e-3, f"{name}: image is constant")
    check(st.drop_refr == st.drop_tir == st.drop_gi == 0,
          f"{name}: dropped lanes {st}")
    return dict(segments=st.segments, segs_per_s=st.segments / t_render,
                ms_per_chunk=t_render / n_chunks * 1e3,
                image_wall_s=t_image, drop_refr=st.drop_refr,
                drop_tir=st.drop_tir, drop_gi=st.drop_gi,
                peak_memory_gib=peak / 2 ** 30,
                image_mean=float(img.mean())), launches


class TimedBuilds:
    """Within the block, the build_photon_map that render_image calls also
    records each build: (host seconds, ending in a synchronise; the map)."""

    def __enter__(self):
        import torch

        from bhraytracer_tpu_torch.models import pathtracer as PT

        self.builds, build = [], PT.build_photon_map

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pmap = build(*args, **kw)
            torch.cuda.synchronize()
            self.builds.append((time.perf_counter() - t0, pmap))
            return pmap

        self.undo = lambda: setattr(PT, "build_photon_map", build)
        PT.build_photon_map = timed
        return self.builds

    def __exit__(self, *exc):
        self.undo()


def render_photon_path(pack, cam, dev, pmap):
    """The photon main path at 800x600: warm, gathering from the map built
    for the kernel check (seed 1), then timed as a user calls it, with the
    launch counters from 0 just before it and read just after:
    render_image with seed 1 builds its own map (the same one; the build's
    time is read inside the call) and renders gathering from it."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.ops import kernels

    cfg = B.RenderConfig(**PHOTON)
    cam.width, cam.height = 800, 600
    B.render_image(pack, cam, cfg, seed=0, photon_map=pmap)
    torch.cuda.synchronize()
    with TimedBuilds() as builds:
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        img, st = B.render_image(pack, cam, cfg, seed=1, return_stats=True)
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
        img = img.cpu()
        t_image = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    check(len(builds) == 1, f"photon: {len(builds)} map builds in one call")
    t_build, built = builds[0]
    check(bool(torch.equal(built.rows, pmap.rows)),
          "photon: render_image built another map than build_photon_map")
    t_render = t_call - t_build
    check(tuple(img.shape) == (600, 800, 3), "photon: image shape")
    check(bool(torch.isfinite(img).all()), "photon: image not finite")
    check(float(img.std()) > 1e-3, "photon: image is constant")
    check(st.drop_refr == st.drop_tir == st.drop_gi == 0,
          f"photon: dropped lanes {st}")
    n_ph = int(pmap.pos.shape[0])
    check(n_ph == cfg.photon_count or n_ph > 1000,
          f"photon: {n_ph} photons deposited")
    return dict(segments=st.segments, segs_per_s=st.segments / t_render,
                ms_per_chunk=t_render * 1e3, build_s=t_build,
                image_wall_s=t_image, photons=n_ph,
                round_limit_reached=n_ph < cfg.photon_count,
                cell_cap=pmap.cell_cap, drop_refr=st.drop_refr,
                drop_tir=st.drop_tir, drop_gi=st.drop_gi,
                image_mean=float(img.mean())), launches


def small_render_vs_cpu(dev):
    """Renders on the card (kernels) and on the CPU (twins): 64x48 of the
    small scenes and of the textured scene (32 filter taps), 32x24 of the
    big-mesh scene and of the textured scene with a photon map; the test
    suite's tolerances (tests/test_torch_render.py) and equal segment
    counts."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.models.photonmap import build_photon_map
    from bhraytracer_tpu_torch.scenes import (
        bench_scene,
        bigmesh_scene,
        textured_scene,
        tiny_scene,
    )

    res = {}
    for name, fn, (w, h), cfg_kw in (
            ("tiny", tiny_scene, (64, 48), {}),
            ("tiny_photon", tiny_scene, (64, 48),
             dict(use_photon_map=True, photon_count=1 << 14)),
            ("bench", bench_scene, (64, 48), {}),
            ("bigmesh", bigmesh_scene, (32, 24), BIGMESH),
            ("textured", textured_scene, (64, 48), {}),
            ("textured_photon", textured_scene, (32, 24),
             dict(use_photon_map=True, photon_count=1 << 14))):
        cfg = B.RenderConfig(**{**dict(spp=1, gi_bounces=1, extra_refr_levels=1,
                                       tir_bounces=4), **cfg_kw,
                                "chunk_rays": w * h})
        out, pmap = [], None
        for device in (dev, "cpu"):
            pack, cam = fn(device)
            cam.width, cam.height = w, h
            if cfg.use_photon_map:  # one map, built on the card, for both
                pmap = (build_photon_map(pack, cfg, seed=0, batch=1 << 16)
                        if pmap is None else pmap.to(device))
            img, st = B.render_image(pack, cam, cfg, seed=0, return_stats=True,
                                     photon_map=pmap)
            out.append((img.cpu(), st))
        (g, sg), (c, sc) = out
        check(bool(torch.isfinite(g).all()), f"{name}: GPU image not finite")
        within = float(((g - c).abs().amax(-1) <= 1e-4).float().mean())
        mean_abs = float((g - c).abs().mean())
        res[name] = dict(size=f"{w}x{h}", within_1e4=within,
                         mean_abs=mean_abs, segs_gpu=sg.segments,
                         segs_cpu=sc.segments)
        check(within >= 0.99 and mean_abs < 1e-3,
              f"{name}: GPU vs CPU render {within:.4f} within 1e-4, "
              f"mean abs {mean_abs:.2e}")
        check(sg.segments == sc.segments,
              f"{name}: segments {sg.segments} (GPU) vs {sc.segments} (CPU)")
    return res


@contextlib.contextmanager
def finish_marks():
    """Within the block, render_image's adaptive selection and denoise
    stamp the host clock (each stamp after a synchronise): "select" where
    the base pass has ended (its accumulation copied to the host),
    "adaptive" where the selection has ended, "denoise" and "denoised"
    around the denoiser; and "escalations" lists each re-render of a chunk
    that dropped lanes as (pass, escalation level)."""
    import torch

    from bhraytracer_tpu_torch.models import pathtracer as PT

    marks, select, denoise = {"escalations": []}, PT._adaptive_select, \
        PT.denoise
    escalated = PT._escalated

    def stamp(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    def timed_select(*args, **kw):
        stamp("select")
        out = select(*args, **kw)
        stamp("adaptive")
        return out

    def timed_denoise(*args, **kw):
        stamp("denoise")
        out = denoise(*args, **kw)
        stamp("denoised")
        return out

    def counted(cfg, esc):
        marks["escalations"].append(
            ("adaptive" if "adaptive" in marks else "base", esc))
        return escalated(cfg, esc)

    PT._adaptive_select, PT.denoise = timed_select, timed_denoise
    PT._escalated = counted
    try:
        yield marks
    finally:
        PT._adaptive_select, PT.denoise = select, denoise
        PT._escalated = escalated


def denoiser_bound(model, height: int, width: int) -> dict:
    """The denoiser's operations at (height, width), 2 a multiply-add of
    each 3x3 convolution at its level's size, and its bound at FP32_PEAK
    beside the bytes of the input and output at HBM_RATE."""
    h, w = -(-height // 4) * 4, -(-width // 4) * 4
    n_enc = len(model.features) - 1
    scale = [2 ** i for i in range(n_enc)]
    # convs 0 .. 2*n_enc-1 at the encoder levels, the bottleneck at the
    # lowest, the decoder convs back up, the output conv at full size.
    levels = ([s for s in scale for _ in (0, 1)] + [2 ** n_enc]
              + scale[::-1] + [1])
    ops = sum(2 * 9 * c.in_channels * c.out_channels * (h // f) * (w // f)
              for c, f in zip(model.convs, levels))
    return dict(gflop=ops / 1e9,
                **bound(h * w * 4 * (3 + model.aux_channels + 3), ops))


def finish_main_path(pack, cam, dev):
    """The finished render at 800x600 (FINISH: the bench scene, HEADLINE,
    4 adaptive samples on 15% of the pixels, return_aux, the shipped
    denoiser): once to warm, recording the trace calls of its adaptive
    pass (record_trace_calls, cleared at the selection); then timed with
    the launch counters from 0 just before it and read just after, the
    base pass, the selection, the adaptive pass and the denoise read from
    finish_marks, and the device memory's peak over it; then the denoise
    alone by CUDA events. Returns (results, launches, trace calls)."""
    import numpy as np
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops import kernels

    cfg = render_config(FINISH)
    cam.width, cam.height = 800, 600
    rec = record_trace_calls(
        lambda: B.render_image(pack, cam, cfg, seed=1, return_aux=True),
        clear_on=(PT, "_adaptive_select"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with finish_marks() as marks:
        kernels.LAUNCHES.clear()
        t0 = time.perf_counter()
        img, aux = B.render_image(pack, cam, cfg, seed=1, return_aux=True)
        torch.cuda.synchronize()
        t_call = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    img = img.cpu()
    sc, drops = aux["sample_count"], aux["dropped_lanes"]
    k_sel = int(800 * 600 * cfg.adaptive_fraction)
    check(tuple(img.shape) == (600, 800, 3), "finish: image shape")
    check(bool(torch.isfinite(img).all()), "finish: image not finite")
    check(float(img.std()) > 1e-3, "finish: image is constant")
    check(not any(drops.values()), f"finish: dropped lanes {drops}")
    check(int((sc == 1 + cfg.adaptive_spp).sum()) == k_sel
          and int((sc == 1).sum()) == 800 * 600 - k_sel,
          f"finish: sample counts {np.unique(sc, return_counts=True)}")
    hit = aux["zbuffer"] < 1e30
    check(0 < hit.mean() < 1 and np.isfinite(aux["zbuffer"][hit]).all(),
          "finish: z-buffer")
    check(bool(np.abs(aux["normal"][hit]).sum(-1).min() > 0.5),
          "finish: first-hit normals")
    model = B.load_pretrained(device=dev)
    den_in = (torch.rand((600, 800, 3), device=dev),
              torch.rand((600, 800, 6), device=dev))
    res = dict(
        size="800x600", base_ms=(marks["select"] - t0) * 1e3,
        select_ms=(marks["adaptive"] - marks["select"]) * 1e3,
        adaptive_ms=(marks["denoise"] - marks["adaptive"]) * 1e3,
        denoise_ms=(marks["denoised"] - marks["denoise"]) * 1e3,
        call_s=t_call, escalations=marks["escalations"],
        adaptive_pixels=k_sel,
        adaptive_chunk=min(cfg.chunk_rays, -(-k_sel // 1024) * 1024),
        segments=aux["traced_segments"], drops=drops,
        peak_memory_gib=peak / 2 ** 30, image_mean=float(img.mean()),
        denoise_events_ms=cuda_ms(lambda: B.denoise(model, *den_in), 5),
        denoiser=denoiser_bound(model, 600, 800))
    return res, launches, rec


def finish_vs_cpu(dev):
    """The finished render on the card against the CPU at FINISH_SIZE
    (FINISH_SMALL: 2 adaptive samples on 15% of the pixels): the bench
    scene, and the tiny scene with a photon map built on the card and
    carried to the CPU. Sample counts and z-buffer hits equal, z within
    1e-4 (relative and absolute), radiance and the denoised image (the
    same render with the shipped denoiser, TF32 off) within 1e-4 on >= 99%
    of pixels."""
    import dataclasses

    import numpy as np
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.models.photonmap import build_photon_map
    from bhraytracer_tpu_torch.scenes import bench_scene, tiny_scene

    w, h = FINISH_SIZE
    res = {}
    for name, fn, cfg_kw in (
            ("bench", bench_scene, FINISH_SMALL),
            ("photon", tiny_scene, dict(FINISH_SMALL, use_photon_map=True,
                                        photon_count=1 << 14))):
        cfg = B.RenderConfig(**cfg_kw, chunk_rays=w * h)
        out, pmap = [], None
        for device in (dev, "cpu"):
            pack, cam = fn(device)
            cam.width, cam.height = w, h
            if cfg.use_photon_map:  # one map, built on the card, for both
                pmap = (build_photon_map(pack, cfg, seed=0, batch=1 << 16)
                        if pmap is None else pmap.to(device))
            img, aux = B.render_image(pack, cam, cfg, seed=0, photon_map=pmap,
                                      return_aux=True)
            den = B.render_image(pack, cam, dataclasses.replace(
                cfg, use_denoiser=True), seed=0, photon_map=pmap)
            out.append((img.cpu(), aux, den.cpu()))
        (g, ga, gd), (c, ca, cd) = out
        check(bool(torch.isfinite(g).all() and torch.isfinite(gd).all()),
              f"finish {name}: card image not finite")
        check(bool((ga["sample_count"] == ca["sample_count"]).all()),
              f"finish {name}: sample counts differ")
        hg, hc = ga["zbuffer"] < 1e30, ca["zbuffer"] < 1e30
        check(bool((hg == hc).all()), f"finish {name}: z-buffer hits differ")
        dz = np.abs(ga["zbuffer"][hg] - ca["zbuffer"][hg])
        check(bool((dz <= 1e-4 * (1 + np.abs(ca["zbuffer"][hg]))).all()),
              f"finish {name}: z-buffer {dz.max():.3g} off")
        within = float(((g - c).abs().amax(-1) <= 1e-4).float().mean())
        dwithin = float(((gd - cd).abs().amax(-1) <= 1e-4).float().mean())
        res[name] = dict(
            size=f"{w}x{h}", adaptive_pixels=int((ga["sample_count"] > 1)
                                                 .sum()),
            z_max_abs_err=float(dz.max()), radiance_within_1e4=within,
            radiance_max_abs_err=float((g - c).abs().max()),
            denoised_within_1e4=dwithin,
            denoised_max_abs_err=float((gd - cd).abs().max()),
            segs_gpu=ga["traced_segments"], segs_cpu=ca["traced_segments"])
        check(within >= 0.99, f"finish {name}: card vs CPU radiance "
              f"{within:.4f} within 1e-4")
        check(dwithin >= 0.99, f"finish {name}: card vs CPU denoised "
              f"{dwithin:.4f} within 1e-4")
    return res


def cli_render(card):
    """`python -m bhraytracer_tpu_torch render` of data/textured.xml at
    800x600 (1 sample, 2 adaptive samples, the z-buffer, a checkpoint) as
    a child process, twice: each exits 0 and writes both PNGs, and the
    second, resuming the finished checkpoint, writes the same bytes."""
    import shutil

    out = os.path.join(REPO, "build", "cli_smoke")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    png, zpng = os.path.join(out, "out.png"), os.path.join(out, "z.png")
    cmd = [sys.executable, "-m", "bhraytracer_tpu_torch", "render",
           "bhraytracer_tpu_torch/data/textured.xml", "--resource-root",
           "assets", "--width", "800", "--height", "600", "--spp", "1",
           "--adaptive", "2", "--zbuffer", zpng, "--checkpoint",
           os.path.join(out, "ck"), "-o", png]
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"cli run {i}: exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        for f in (png, zpng):
            check(os.path.getsize(f) > 0, f"cli run {i}: {f} not written")
        with open(png, "rb") as f, open(zpng, "rb") as g:
            runs.append(dict(wall_s=wall, png=f.read(), z=g.read(),
                             stdout=r.stdout.strip().splitlines()))
            os.remove(png)
            os.remove(zpng)
    check(runs[0]["png"] == runs[1]["png"] and runs[0]["z"] == runs[1]["z"],
          "cli: the resumed render wrote other bytes")
    return dict(cmd=" ".join(cmd[1:]), card=card,
                **{f"run{i}": dict(wall_s=r["wall_s"], stdout=r["stdout"])
                   for i, r in enumerate(runs)},
                png_bytes=len(runs[0]["png"]))


def finish_phase(dev, card, per_kernel):
    """The finished render's three checks (finish_main_path and its trace
    calls, kernels 1, 2, 4 and 5 on every call of its adaptive pass;
    finish_vs_cpu; cli_render). Returns (results, launches)."""
    from bhraytracer_tpu_torch.scenes import bench_scene

    pack, cam = bench_scene(dev)
    res, launches, rec = finish_main_path(pack, cam, dev)
    print(f"main path finish 800x600 ({card}): base pass "
          f"{res['base_ms']:.1f} ms, selection {res['select_ms']:.1f} ms, "
          f"adaptive pass ({res['adaptive_pixels']} pixels x 4 samples, "
          f"{res['adaptive_chunk']}-lane chunks) {res['adaptive_ms']:.1f} "
          f"ms, denoise {res['denoise_ms']:.1f} ms (alone "
          f"{res['denoise_events_ms']:.2f} ms, bound "
          f"{res['denoiser']['bound_ms']:.3f} ms by "
          f"{res['denoiser']['bound_by']}, "
          f"{res['denoiser']['gflop']:.1f} GFLOP), call {res['call_s']:.3f} "
          f"s, escalations {res['escalations']}, drops {res['drops']}, "
          "peak device memory "
          f"{res['peak_memory_gib']:.2f} GiB")
    print("launches finish:", json.dumps(launches))
    for k in FLAT + BVH + ("bhrt_shade_setup",):
        check(launches.get(k, 0) > 0, f"{k} not launched by the finished "
              "render")
    for k in HBM + ANALYTIC + ("bhrt_photon_sweep",):
        check(launches.get(k, 0) == 0, f"{k} launched by the finished render")
    frame_call_checks(per_kernel, pack, dev, rec, "adaptive")
    del rec
    print_frame_calls(per_kernel, "adaptive", "the finished render's "
                      "adaptive pass, 4 samples of 72,704 lanes")
    res["vs_cpu"] = finish_vs_cpu(dev)
    print(f"finished render, card vs CPU {FINISH_SIZE[0]}x{FINISH_SIZE[1]}:",
          json.dumps(res["vs_cpu"]))
    res["cli"] = cli_render(card)
    print("command line, textured.xml 800x600, twice on one checkpoint:",
          json.dumps(res["cli"]))
    return res, launches


def frame_inputs(name, dev):
    """(pack, camera at 800x600, config, render_image keywords) of a main
    path; the photon path's keywords carry a map built for it (seed 1, as
    render_image builds it)."""
    from bhraytracer_tpu_torch import scenes

    scene, cfg_kw = PATHS[name]
    pack, cam = getattr(scenes, scene)(dev)
    cam.width, cam.height = 800, 600
    cfg = render_config(cfg_kw)
    kw = {}
    if name == "photon":
        from bhraytracer_tpu_torch.models.photonmap import build_photon_map

        kw = dict(photon_map=build_photon_map(pack, cfg, seed=1))
    return pack, cam, cfg, kw


def profile_counts(fn, top: int = 6):
    """(fn(), {launches, syncs, device_busy_ms, top_kernels}) of one call
    under torch.profiler: cudaLaunchKernel / cuLaunchKernel events,
    synchronisations (less the one that ends the call), the device time of
    the events that ran on the card (write_profile's count), and the `top`
    kernels by device time as [name, calls, ms]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    col = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total")
           else "self_cuda_time_total")
    kern = sorted((e for e in ka if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -getattr(e, col))
    return out, dict(
        launches=sum(e.count for e in ka if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel")),
        syncs=sum(e.count for e in ka if "Synchronize" in e.key) - 1,
        device_busy_ms=sum(getattr(e, col) for e in kern) / 1e3,
        top_kernels=[[e.key[:120], e.count, getattr(e, col) / 1e3]
                     for e in kern[:top]])


def mean_radiance_grads(pack, cam, cfg_kw, width, height, seed, wrt=None,
                        pmap=None):
    """(radiance, stats, {key: gradient of the mean radiance}, {forward_ms,
    backward_ms}) of one _render_chunk over the image's lanes, for the
    trainable_params named in wrt (all, with geometry and textures, by
    default)."""
    import torch

    from bhraytracer_tpu_torch.models.pathtracer import _pixels, _render_chunk
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.parallel.sharding import (
        _apply_params,
        trainable_params,
    )

    dev = pack.device
    n = width * height
    cfg = render_config(dict(cfg_kw, chunk_rays=n))
    cam_p = from_scene_camera(cam, dev)
    params = trainable_params(pack, cam_p, include_geometry=True,
                              include_textures=True)
    wrt = list(params) if wrt is None else list(wrt)
    leaves = {k: v.detach().requires_grad_(k in wrt)
              for k, v in params.items()}
    pk, cm = _apply_params(pack, cam_p, leaves)
    px, py = _pixels(width, height, n, 0, dev)
    t0 = clock(dev)
    rad, _, st = _render_chunk(pk, cfg, cm, width, height, px, py,
                               rng.prng_key(seed, dev), pmap)
    t1 = clock(dev)
    gs = torch.autograd.grad(rad.mean(), [leaves[k] for k in wrt],
                             allow_unused=True)
    t2 = clock(dev)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g).cpu()
             for k, g in zip(wrt, gs)}
    return (rad.detach().cpu(), [int(x) for x in st], grads,
            dict(forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3))


def compare_radiance(what, r_gpu, r_cpu) -> dict:
    """The card's radiance against the CPU's as small_render_vs_cpu holds
    images: at least 99% of lanes within 1e-4, mean abs below 1e-3."""
    err = (r_gpu - r_cpu).abs()
    within = float((err.amax(-1) <= 1e-4).float().mean())
    mean_abs = float(err.mean())
    check(within >= 0.99 and mean_abs < 1e-3,
          f"{what}: card vs CPU radiance {within:.4f} within 1e-4, mean abs "
          f"{mean_abs:.2e}")
    return dict(radiance_max_abs_err=float(err.max()),
                radiance_within_1e4=within, radiance_mean_abs=mean_abs)


def compare_grads(what, g_gpu, g_cpu) -> dict:
    """Each parameter's largest difference over its largest CPU gradient;
    fails beyond GRAD_RTOL * max|g_cpu| + GRAD_ATOL or on a non-finite
    card gradient."""
    import torch

    out = {}
    for k, c in g_cpu.items():
        g = g_gpu[k]
        check(bool(torch.isfinite(g).all()), f"{what}: {k} gradient not "
              "finite on the card")
        err = float((g - c).abs().max()) if c.numel() else 0.0
        top = float(c.abs().max()) if c.numel() else 0.0
        check(err <= GRAD_RTOL * top + GRAD_ATOL,
              f"{what}: {k} gradient off by {err:.3g} (max {top:.3g})")
        out[k] = dict(max_abs=top, err=err, err_over_max=err / max(top, 1e-30))
    return out


def gradients_vs_cpu(dev, pmap):
    """Gradients of the mean radiance on the card (kernels) against the CPU
    (twins): (a) every trainable parameter of tests/test_gradients.py's and
    tests/test_gradients_mesh.py's setups at 24x18, built through the port
    (scenes.gradient_scene, gradient_mesh_scene); (b) mtl_diffuse and
    light_intensity on tiny_scene at 128x96 gathering from the photon map
    built for the photon path (seed 1, as PHOTON), carried to the CPU, with
    the launches of kernels 8, 9 and 10 in the card's run."""
    import torch

    from bhraytracer_tpu_torch import scenes
    from bhraytracer_tpu_torch.ops import kernels

    res = {}
    for name, fn in (("fd_sphere", scenes.gradient_scene),
                     ("fd_mesh", scenes.gradient_mesh_scene)):
        out = []
        for device in (dev, "cpu"):
            pack, cam = fn(device)
            out.append(mean_radiance_grads(pack, cam, INVERSE, cam.width,
                                           cam.height, 7))
        (rg, sg, gg, _), (rc, sc, gc, _) = out
        check(sg == sc, f"{name}: stats {sg} (GPU) vs {sc} (CPU)")
        res[name] = dict(size="24x18", **compare_radiance(name, rg, rc),
                         grads=compare_grads(name, gg, gc))
    wrt = ("mtl_diffuse", "light_intensity")
    cfg_kw = dict(INVERSE, use_photon_map=True,
                  photon_count=PHOTON["photon_count"])
    out = []
    for device in (dev, "cpu"):
        pack, cam = scenes.tiny_scene(device)
        kernels.LAUNCHES.clear()
        out.append(mean_radiance_grads(pack, cam, cfg_kw, 128, 96, 0, wrt,
                                       pmap.to(device)))
        if device == dev:
            torch.cuda.synchronize()
            launched = dict(kernels.LAUNCHES)
    (rg, sg, gg, _), (rc, sc, gc, _) = out
    for k in ANALYTIC + ("bhrt_photon_sweep",):
        check(launched.get(k, 0) > 0, f"{k} not launched by the photon "
              "gradient run")
    check(sg == sc, f"photon gradients: stats {sg} (GPU) vs {sc} (CPU)")
    res["photon"] = dict(size="128x96", photons=int(pmap.pos.shape[0]),
                         launches=launched,
                         **compare_radiance("photon", rg, rc),
                         grads=compare_grads("photon", gg, gc))
    return res


def textured_gradient(dev, taps: int = 32):
    """The gradient of the mean radiance of the textured scene at
    INVERSE_SIZE^2 in one _render_chunk, INVERSE's config with `taps`
    filter taps, over every trainable parameter with geometry and textures
    (the atlas a float32 copy): timed forward and backward after one warm
    pass under the profiler (profile_counts of forward and backward
    together), with the device memory's peak; every gradient finite, and
    the texture tables' and the atlas's nonzero."""
    import torch

    from bhraytracer_tpu_torch.scenes import textured_scene

    pack, cam = textured_scene(dev)
    cfg_kw = dict(INVERSE, texture_sample_count=taps)
    w = h = INVERSE_SIZE
    _, prof = profile_counts(
        lambda: mean_radiance_grads(pack, cam, cfg_kw, w, h, 0), top=8)
    torch.cuda.reset_peak_memory_stats()
    _, st, grads, times = mean_radiance_grads(pack, cam, cfg_kw, w, h, 0)
    peak = torch.cuda.max_memory_allocated()
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"textured gradient: {k} not "
              "finite")
    for k in ("tex_c1", "tex_c2", "atlas"):
        check(float(grads[k].abs().max()) > 0,
              f"textured gradient: {k} gradient is 0")
    return dict(size=f"{w}x{h}", taps=taps, **times, profiled=prof,
                peak_memory_gib=peak / 2 ** 30, segments=st[3],
                drops=st[:3], grad_max_abs={k: float(g.abs().max())
                                            for k, g in grads.items()})


def inverse_main_path(dev):
    """The inverse-rendering path at INVERSE_SIZE^2 on the bench scene:
    the target from the true tables; mtl_diffuse perturbed (seed 0,
    +-0.35, clipped to [0.02, 0.98]); one value_and_grad over
    trainable_params(include_geometry=True) under the profiler (the host's
    launches and syncs), then the same timed, forward and backward, with
    the launch counters from 0 just before it and read just after, and the
    device memory's peak over it; then INVERSE_STEPS Adam steps on
    mtl_diffuse, each timed. Returns the results, the launches and (pack,
    the trace calls of one more forward, record_trace_calls)."""
    import numpy as np
    import torch

    from bhraytracer_tpu_torch.models.pathtracer import _render_chunk
    from bhraytracer_tpu_torch.ops import kernels
    from bhraytracer_tpu_torch.parallel.sharding import (
        _apply_params,
        loss_and_grads,
    )

    inv = inverse_inputs(dev)
    pack, cfg, cam_p, w, h, px, py, key, target, params = (
        inv[k] for k in ("pack", "cfg", "cam", "w", "h", "px", "py", "key",
                         "target", "params"))
    n = w * h
    true_d = pack.mtl_diffuse.cpu().numpy()
    d0 = params["mtl_diffuse"].cpu().numpy()

    def forward():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        pk, cm = _apply_params(pack, cam_p, leaves)
        rad, _, stats = _render_chunk(pk, cfg, cm, w, h, px, py, key)
        return leaves, torch.mean((rad - target) ** 2), stats

    def backward(leaves, loss):
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        return {k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(leaves.items(), gs)}

    # Warm (the first call of a process loads the CUDA kernels it uses),
    # counting the host's launches and syncs and the top device kernels.
    (leaves, loss, _), fwd_prof = profile_counts(forward)
    _, bwd_prof = profile_counts(lambda: backward(leaves, loss))
    del leaves, loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    leaves, loss, stats = forward()
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches_fwd = dict(kernels.LAUNCHES)
    grads = backward(leaves, loss)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0 - t_fwd
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    loss0 = float(loss.detach())
    del leaves, loss
    for k, v in grads.items():
        check(bool(torch.isfinite(v).all()), f"inverse: {k} gradient not "
              "finite")
    for k in ("mtl_diffuse", "verts"):
        check(float(grads[k].abs().max()) > 0, f"inverse: {k} gradient is 0")
    drops = [int(stats.drop_refr), int(stats.drop_tir), int(stats.drop_gi)]
    check(drops == [0, 0, 0], f"inverse: dropped lanes {drops}")
    check(launches == launches_fwd, "inverse: the backward launched a kernel")
    check(launches.get("bhrt_bvh_closest", 0) == 1
          and launches.get("bhrt_bvh_anyhit", 0) == 1,
          "inverse: BVH launches other than level 0's one pair")
    check(launches.get("bhrt_stream_anyhit", 0) == 1
          and launches.get("bhrt_stream_closest", 0) >= 1,
          "inverse: flat kernels other than level 1's shadow trace and the "
          "closest traces of level 1 and the chains")
    for k in ("bhrt_shade_setup", "bhrt_photon_sweep") + HBM + ANALYTIC:
        check(launches.get(k, 0) == 0, f"inverse: {k} launched")

    diffuse = params["mtl_diffuse"].clone().requires_grad_()
    opt = torch.optim.Adam([diffuse], lr=INVERSE_LR)
    losses, step_s = [], []
    for _ in range(INVERSE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lv, gr = loss_and_grads(dict(params, mtl_diffuse=diffuse), pack, cfg,
                                cam_p, w, h, px, py, target, key,
                                wrt=("mtl_diffuse",))
        opt.zero_grad()
        diffuse.grad = gr["mtl_diffuse"]
        opt.step()
        with torch.no_grad():
            diffuse.clamp_(0.0, 1.0)
        losses.append(float(lv))
        step_s.append(time.perf_counter() - t0)
    err0 = float(np.abs(d0 - true_d).mean())
    err1 = float(np.abs(diffuse.detach().cpu().numpy() - true_d).mean())
    check(losses[-1] < losses[0], f"inverse: loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g} over {INVERSE_STEPS} Adam steps")
    check(err1 < err0, f"inverse: diffuse L1 error {err0:.4f} -> {err1:.4f}")
    # The trace calls of the timed forward (the same function on the same
    # inputs), recorded last so that their copies weigh on no time or peak.
    rec = record_trace_calls(forward)
    res = dict(size=f"{w}x{h}", lanes=n, segments=int(stats.segments),
               target_ms=inv["target_ms"], forward_ms=t_fwd * 1e3,
               backward_ms=t_bwd * 1e3, value_and_grad_loss=loss0,
               forward_profiled=fwd_prof, backward_profiled=bwd_prof,
               peak_memory_gib=peak / 2 ** 30, drops=drops,
               adam_losses=losses, adam_step_s=step_s,
               diffuse_l1_err=[err0, err1],
               grad_max_abs={k: float(v.abs().max())
                             for k, v in grads.items()})
    return res, launches, (pack, rec)


def inverse_alone(dev, card):
    """--inverse: the inverse path with the checks of its trace calls, the
    textured gradient and the card-vs-CPU gradients alone (the photon map
    built as the default run builds it)."""
    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.models.photonmap import build_photon_map
    from bhraytracer_tpu_torch.scenes import tiny_scene

    res, launches, (pack, rec) = inverse_main_path(dev)
    print(json.dumps({"inverse": res, "launches": launches, "card": card}))
    per_kernel = {k: dict(max_abs_err=0.0, lanes_compared=0, walk_lanes=0)
                  for k in FLAT + BVH}
    frame_call_checks(per_kernel, pack, dev, rec, "inverse")
    del rec
    print_frame_calls(per_kernel, "inverse",
                      f"{INVERSE_SIZE}x{INVERSE_SIZE} INVERSE forward")
    print(json.dumps({"textured_gradient": textured_gradient(dev),
                      "card": card}))
    pmap = build_photon_map(tiny_scene(dev)[0], B.RenderConfig(**PHOTON),
                            seed=1)
    print(json.dumps({"gradients_vs_cpu": gradients_vs_cpu(dev, pmap),
                      "card": card}))


TEXTURE_RANGE = "bhrt_texture"


@contextlib.contextmanager
def texture_ranges():
    """Within the block, each call of the port's texture lookups
    (ops/texturing.py: texmap_sample, which every textured colour,
    background and environment sample goes through, and environment_uvw)
    runs in a torch.profiler range named TEXTURE_RANGE, whose row in the
    profile's tables carries the device time of the kernels launched in
    it. The hit's texture coordinates (ops/trace.py:resolve_hit) are not
    counted. A checkout without these functions is left as it is."""
    from torch.profiler import record_function

    from bhraytracer_tpu_torch.ops import texturing as TX

    saved = {k: getattr(TX, k) for k in ("texmap_sample", "environment_uvw")
             if hasattr(TX, k)}

    def ranged(fn):
        def call(*args, **kw):
            with record_function(TEXTURE_RANGE):
                return fn(*args, **kw)
        return call

    for k, fn in saved.items():
        setattr(TX, k, ranged(fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(TX, k, fn)


def write_profile(prof, name, card, **extra):
    """Write a torch.profiler run's tables under chiprun_out/ and print its
    launches, syncs, device busy time, the port's kernels and the texture
    lookups' ranges (texture_ranges: the device time of their kernels and
    its share of the busy time, their host time, and their span on the
    device's timeline)."""
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    col = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total")
           else "self_cuda_time_total")
    total = ("device_time_total" if hasattr(ka[0], "device_time_total")
             else "cuda_time_total")
    # Device time: the events that ran on the card (the operator rows above
    # them carry the same time again), as the table's total.
    kern = [e for e in ka if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(getattr(e, col) for e in kern)
    ours = {}
    for e in kern:  # "void (anonymous namespace)::closest_kernel<2>(..."
        fn = e.key.split("::", 1)[-1].split("(")[0]
        if fn.split("<")[0] in PORT_KERNEL_FUNCTIONS:
            ours[fn] = [e.count, getattr(e, col) / 1e3]
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel"))
    syncs = sum(e.count for e in ka if "Synchronize" in e.key)
    # A range has two rows: the host's, whose device total is the time of
    # the kernels launched in it, and the device timeline's, whose time is
    # the span from its first kernel to its last, idle gaps included.
    tex = [e for e in ka if e.key == TEXTURE_RANGE
           and e.device_type == DeviceType.CPU]
    span = [e for e in ka if e.key == TEXTURE_RANGE
            and e.device_type == DeviceType.CUDA]
    tex_ms = sum(getattr(e, total) for e in tex) / 1e3
    texture = dict(calls=sum(e.count for e in tex), device_ms=tex_ms,
                   device_share=tex_ms / max(dev_us / 1e3, 1e-9),
                   host_ms=sum(e.cpu_time_total for e in tex) / 1e3,
                   device_span_ms=sum(getattr(e, col) for e in span) / 1e3)
    table = ka.table(sort_by=col, row_limit=60)
    host = ka.table(sort_by="self_cpu_time_total", row_limit=40)
    with open(os.path.join(REPO, "chiprun_out", f"profile_{name}.txt"),
              "w") as f:
        f.write(f"{card}\n{table}\n{host}\n")
    print(json.dumps({"profile": name, "card": card, **extra,
                      "device_busy_ms": dev_us / 1e3,
                      "kernel_launches": launches, "syncs": syncs,
                      "port_kernels_calls_ms": ours,
                      "texture_ranges": texture}))
    print(ka.table(sort_by=col, row_limit=15))


def profile_frames(dev, card, names):
    """torch.profiler over one warm frame of each named main path:
    launches, device busy time, the kernels by device time and the host
    operators by CPU time (tables under chiprun_out/), and the device time
    of the texture lookups (texture_ranges). For the photon path also one
    emission round of its map's build (build_photon_map runs such rounds
    until the photons are collected or its round limit is reached), at
    build_photon_map's default batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bhraytracer_tpu_torch as B

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name in names:
        pack, cam, cfg, kw = frame_inputs(name, dev)
        B.render_image(pack, cam, cfg, seed=0, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        B.render_image(pack, cam, cfg, seed=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=acts) as prof, texture_ranges():
            t0 = time.perf_counter()
            B.render_image(pack, cam, cfg, seed=1, **kw)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        write_profile(prof, name, card, wall_s=wall,
                      profiled_wall_s=wall_prof)
        if name == "photon":
            from bhraytracer_tpu_torch.models import photonmap as PM
            from bhraytracer_tpu_torch.ops import rng

            key = rng.prng_key(1, dev)

            def round_(r):
                v = PM.trace_photon_batch(pack, cfg, rng.fold_in(key, r),
                                          PM.PHOTON_BATCH, True)[3]
                return int(v.sum())  # the build's one sync a round

            round_(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            round_(1)
            wall = time.perf_counter() - t0
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                round_(1)
                wall_prof = time.perf_counter() - t0
            write_profile(prof, "photon_build_round", card, wall_s=wall,
                          profiled_wall_s=wall_prof, batch=PM.PHOTON_BATCH)


def time_frames(dev, card, n: int, names):
    """N timed frames of each named main path, after a warm one. A photon
    frame is render_image building its own map, as a user calls it."""
    import torch

    import bhraytracer_tpu_torch as B

    for name in names:
        pack, cam, cfg, kw = frame_inputs(name, dev)
        B.render_image(pack, cam, cfg, seed=0, **kw)
        kw.pop("photon_map", None)
        for seed in range(1, n + 1):
            torch.cuda.synchronize()
            with (TimedBuilds() if name == "photon"
                  else contextlib.nullcontext([])) as builds:
                t0 = time.perf_counter()
                _, st = B.render_image(pack, cam, cfg, seed=seed,
                                       return_stats=True, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(json.dumps({"frame": name, "seed": seed, "card": card,
                              "wall_s": wall,
                              "build_s": builds[0][0] if builds else None,
                              "segments": st.segments}))


# ---------------------------------------------------------------------------
# the distributed phase: data parallelism over torch.distributed
# ---------------------------------------------------------------------------


def free_address() -> str:
    """127.0.0.1:<a free port>, a group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def clock(dev) -> float:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


@contextlib.contextmanager
def recorded_shade_calls(calls):
    """Within the block, each `ops/shade.shade_lanes` call appends its
    arguments (tensors cloned) to `calls`."""
    import torch

    from bhraytracer_tpu_torch.ops import shade as S

    real = S.shade_lanes

    def rec(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return real(*args)

    S.shade_lanes = rec
    try:
        yield calls
    finally:
        S.shade_lanes = real


@contextlib.contextmanager
def exchange_stats(dev):
    """Within the block, each count exchange of a sharded step's lane
    frame (parallel/sharding.py:_count_exchange, one all-gather of a few
    int64) is counted and timed by the host clock, with a synchronise
    before and after it; yields the dict it fills: calls, ms (each)."""
    from bhraytracer_tpu_torch.parallel import sharding as SH

    real = SH._count_exchange
    stats = dict(calls=0, ms=[])

    def timed(*args):
        t0 = clock(dev)
        out = real(*args)
        clock(dev)
        stats["calls"] += 1
        stats["ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    SH._count_exchange = timed
    try:
        yield stats
    finally:
        SH._count_exchange = real


def zero_length_calls(dev) -> dict:
    """A rank of a sharded step can hold no lanes at a level: kernels 1-5
    and 8-9 through their routes (the tiny scene's analytic route; the
    bench scene's BVH route and, with reorder, its flat stream route) and
    the shade setup on zero-length batches on the card, each returning
    empty results without a launch."""
    import torch

    from bhraytracer_tpu_torch.ops import kernels
    from bhraytracer_tpu_torch.ops.shade import shade_setup
    from bhraytracer_tpu_torch.ops.trace import (
        trace_closest,
        trace_route,
        trace_shadow,
    )
    from bhraytracer_tpu_torch.scenes import bench_scene, tiny_scene

    cfg = render_config(INVERSE)
    o = torch.zeros((0, 3), device=dev)
    routes = []
    kernels.LAUNCHES.clear()
    for pack in (tiny_scene(dev)[0], bench_scene(dev)[0]):
        for reorder in (False, True):
            hit = trace_closest(pack, o, o, "both", reorder=reorder)
            occ = trace_shadow(pack, o, o, torch.zeros(0, device=dev),
                               cfg.shadow_bias, reorder=reorder)
            check(hit.t.shape == occ.shape == (0,), "zero-length trace")
            routes.append(trace_route(pack, reorder))
            if routes[-1] != "analytic":
                fo = shade_setup(pack, cfg, o, o, hit, hit.hit,
                                 torch.zeros((0, 13), device=dev))
                check(fo.p.shape == (0, 3), "zero-length shade setup")
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(not launched, f"zero-length batches launched {launched}")
    return dict(routes=sorted(set(routes)), launches=launched)


def dryrun_multichip(mesh, dev) -> dict:
    """__graft_entry__.dryrun_multichip's counterpart (__graft_entry__.py:
    96-154): one sharded forward and one train_step_sharded on tiny_scene,
    DRYRUN_LANES lanes a rank spread over the image, a zero target; the
    radiance and the loss finite."""
    import numpy as np
    import torch

    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.parallel import (
        render_radiance_sharded,
        train_step_sharded,
    )
    from bhraytracer_tpu_torch.parallel.sharding import trainable_params
    from bhraytracer_tpu_torch.scenes import tiny_scene

    pack, cam = tiny_scene(dev)
    cfg = render_config(DRYRUN)
    cam_p = from_scene_camera(cam, dev)
    w, h = cam.width, cam.height
    n = DRYRUN_LANES * mesh.size()
    idx = torch.from_numpy(np.linspace(0, w * h - 1, n).astype(np.int64)).to(
        dev)
    key = rng.prng_key(0, dev)
    rad = render_radiance_sharded(pack, cfg, cam_p, w, h, idx % w, idx // w,
                                  key, mesh)
    new, _, loss = train_step_sharded(
        trainable_params(pack, cam_p), None, pack, cfg, cam_p, w, h, idx % w,
        idx // w, torch.zeros((n, 3), device=dev), key, mesh)
    check(tuple(rad.shape) == (n, 3) and bool(torch.isfinite(rad).all()),
          "dryrun: sharded radiance")
    check(bool(torch.isfinite(loss)), "dryrun: non-finite loss")
    check(all(bool(torch.isfinite(v).all()) for v in new.values()),
          "dryrun: non-finite parameters")
    return dict(lanes=n, loss=float(loss))


def collective_times(mesh, dev, shard_shape, reduce_numel: int) -> dict:
    """Wall ms (host clock, each call ending in a synchronise; mean of
    COLLECTIVE_REPS after one warm call) of one all_gather_into_tensor of
    float32 shards of `shard_shape` and of one all_reduce of
    `reduce_numel` float32, the shapes of render_radiance_sharded's
    gather and train_step_sharded's reduce; with their bytes (the gathered
    tensor, the reduced buffer)."""
    import torch
    import torch.distributed as dist

    group = mesh.get_group("dp")
    x = torch.rand(shard_shape, device=dev)
    out = x.new_empty((mesh.size() * shard_shape[0], *shard_shape[1:]))
    buf = torch.rand(reduce_numel, device=dev)

    def wall_ms(fn):
        fn()
        t0 = clock(dev)
        for _ in range(COLLECTIVE_REPS):
            fn()
            clock(dev)
        return (time.perf_counter() - t0) / COLLECTIVE_REPS * 1e3

    return dict(
        all_gather_ms=wall_ms(
            lambda: dist.all_gather_into_tensor(out, x, group=group)),
        all_gather_bytes=out.numel() * 4,
        all_reduce_ms=wall_ms(lambda: dist.all_reduce(buf, group=group)),
        all_reduce_bytes=buf.numel() * 4)


def inverse_inputs(dev):
    """The inverse path's inputs: the bench scene, its camera, INVERSE at
    INVERSE_SIZE^2 in one chunk, the lanes and key 0, the target from the
    true tables (finite, no lane dropped; its render's ms), and
    trainable_params with geometry, mtl_diffuse perturbed (seed 0,
    +-0.35, clipped to [0.02, 0.98])."""
    import numpy as np
    import torch

    from bhraytracer_tpu_torch.models.pathtracer import _pixels, _render_chunk
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.parallel.sharding import trainable_params
    from bhraytracer_tpu_torch.scenes import bench_scene

    w = h = INVERSE_SIZE
    pack, cam = bench_scene(dev)
    cfg = render_config(dict(INVERSE, chunk_rays=w * h))
    cam_p = from_scene_camera(cam, dev)
    px, py = _pixels(w, h, w * h, 0, dev)
    key = rng.prng_key(0, dev)
    t0 = clock(dev)
    with torch.no_grad():
        target, _, st = _render_chunk(pack, cfg, cam_p, w, h, px, py, key)
    target_ms = (clock(dev) - t0) * 1e3
    check(bool(torch.isfinite(target).all()), "inverse: target not finite")
    check(int(st.drop_refr) == int(st.drop_tir) == int(st.drop_gi) == 0,
          f"inverse: target dropped lanes {[int(x) for x in st]}")
    true_d = pack.mtl_diffuse.cpu().numpy()
    d0 = np.clip(true_d + np.random.default_rng(0).uniform(
        -0.35, 0.35, true_d.shape), 0.02, 0.98).astype(np.float32)
    params = dict(trainable_params(pack, cam_p, include_geometry=True),
                  mtl_diffuse=torch.from_numpy(d0).to(dev))
    return dict(pack=pack, cfg=cfg, cam=cam_p, w=w, h=h, px=px, py=py,
                key=key, target=target, params=params, target_ms=target_ms)


def frame_lanes(dev, seed: int = 1):
    """The 800x600 frame's 480,000 lanes and render_image_distributed's key
    of its one chunk's first sample at `seed` (HEADLINE: one chunk)."""
    import torch

    from bhraytracer_tpu_torch.ops import rng

    w, h = 800, 600
    idx = torch.arange(w * h, device=dev)
    return idx % w, idx // w, rng.fold_in(rng.fold_in(
        rng.prng_key(seed, dev), 0), 0)


def dist_small_render(mesh, dev):
    """render_image_distributed of the bench scene at FINISH_SIZE with
    SMALL, one chunk, seed 0: (image on the host, ChunkStats as a list)."""
    from bhraytracer_tpu_torch.parallel import render_image_distributed
    from bhraytracer_tpu_torch.scenes import bench_scene

    w, h = FINISH_SIZE
    pack, cam = bench_scene(dev)
    cam.width, cam.height = w, h
    img, st = render_image_distributed(
        pack, cam, render_config(dict(SMALL, chunk_rays=w * h)), mesh, seed=0,
        return_stats=True)
    return img.cpu(), list(st)


def dist_rank(args) -> int:
    """--dist-rank RANK WORLD ADDRESS DEVICE OUT: one rank of the
    distributed phase's world-2 runs, a child process of it. On a card
    (gloo, the two ranks sharing it): the 800x600 HEADLINE frame through
    render_image_distributed (warm, then timed) with the peak memory, the
    gathered radiance of that frame's lanes (render_radiance_sharded), the
    reduced gradients of a sharded INVERSE step at INVERSE_SIZE^2 on the
    parent's target and parameters (OUT/inputs.pt) with its count
    exchanges (exchange_stats), the step's wall, the collectives' times;
    on either device the FINISH_SIZE render and the dryrun. Writes
    OUT/rank<RANK>.pt."""
    import torch

    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.parallel import (
        init_multihost,
        make_mesh,
        render_image_distributed,
        render_radiance_sharded,
        shutdown,
        train_step_sharded,
    )
    from bhraytracer_tpu_torch.parallel.sharding import loss_and_grads_sharded
    from bhraytracer_tpu_torch.scenes import bench_scene

    rank, world, addr, device, out = (int(args[0]), int(args[1]), args[2],
                                      args[3], args[4])
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    check(init_multihost(addr, world, rank, device=dev, backend="gloo"),
          "init_multihost: no group")
    res = {}
    try:
        mesh = make_mesh(device=dev)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            pack, cam = bench_scene(dev)
            cam.width, cam.height = 800, 600
            cfg = render_config(HEADLINE)
            render_image_distributed(pack, cam, cfg, mesh, seed=0)
            torch.cuda.reset_peak_memory_stats()
            t0 = clock(dev)
            img, st = render_image_distributed(pack, cam, cfg, mesh, seed=1,
                                               return_stats=True)
            res["frame_wall_s"] = clock(dev) - t0
            res["frame_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            check(bool(torch.isfinite(img).all()), "world 2: frame")
            res["frame_stats"] = list(st)
            px, py, key = frame_lanes(dev)
            res["rad"] = render_radiance_sharded(
                pack, cfg, from_scene_camera(cam, dev), cam.width, cam.height,
                px, py, key, mesh).cpu()

            inv = inverse_inputs(dev)
            sent = torch.load(os.path.join(out, "inputs.pt"),
                              weights_only=True)
            inv["target"] = sent["target"].to(dev)
            inv["params"]["mtl_diffuse"] = sent["mtl_diffuse"].to(dev)
            step_args = [inv[k] for k in ("params", "pack", "cfg", "cam", "w",
                                          "h", "px", "py", "target", "key")]
            torch.cuda.reset_peak_memory_stats()
            with exchange_stats(dev) as ex:
                loss, grads = loss_and_grads_sharded(*step_args, mesh)
            res["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            res["exchanges"] = ex
            res["loss"] = float(loss)
            res["grads"] = {k: g.cpu() for k, g in grads.items()}
            t0 = clock(dev)
            train_step_sharded(*step_args[:1], None, *step_args[1:], mesh,
                               lr=INVERSE_LR)
            res["step_wall_s"] = clock(dev) - t0
            res["collectives"] = collective_times(
                mesh, dev, (px.shape[0] // world, 3),
                1 + sum(v.numel() for v in inv["params"].values()))
        res["small"] = dist_small_render(mesh, dev)
        res["dryrun"] = dryrun_multichip(mesh, dev)
    finally:
        shutdown()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    return 0


def shard_references(dev, rad_pack):
    """What one process gets on each half of the world-2 frame, written
    here apart from parallel/sharding.py: the 800x600 frame's radiance,
    _render_chunk of each half keyed fold_in(key, r * half)."""
    import torch

    from bhraytracer_tpu_torch.models.pathtracer import _render_chunk
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera

    pack, cam = rad_pack
    cfg = render_config(HEADLINE)
    px, py, key = frame_lanes(dev)
    half = px.shape[0] // DIST_WORLD
    cam_p = from_scene_camera(cam, dev)
    w, h = 800, 600
    return torch.cat([_render_chunk(
        pack, cfg, cam_p, w, h, px[r * half:(r + 1) * half],
        py[r * half:(r + 1) * half], rng.fold_in(key, r * half))[0]
        for r in range(DIST_WORLD)]).cpu()


def run_world(world: int, device: str, out: str) -> list:
    """The world of `world` child ranks (dist_rank) on `device`, started
    together at one rendezvous: their results, rank by rank, and each
    rank's wall. Any rank's failure fails the run; every child is stopped
    before this returns."""
    import torch

    addr = free_address()
    t0 = time.perf_counter()
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
         str(world), addr, device, out], cwd=REPO, stdout=log)
        for r, log in enumerate(logs)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    check(codes == [0] * world, f"world {world} on {device}: exit codes "
          f"{codes}")
    return [dict(torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False), process_wall_s=wall)
            for r in range(world)]


def distributed_world1(dev, per_kernel, out):
    """World 1 over NCCL in this process (init_multihost with a local
    coordinator, make_mesh): the bench scene at 800x600 with HEADLINE
    through render_image_distributed (warm, then timed with the launch
    counters from 0 just before it and read just after, and the device
    memory's peak) against render_image's wall on the same frame; the
    trace calls of one more distributed frame (kernels 1, 2, 4 and 5
    against their twins on every call, frame_call_checks) and its shade
    setups (kernel 3 on every call, shade_call_check); one
    train_step_sharded on the inverse path's inputs against train_step's
    wall, with its launches and peak, and its loss and gradients
    (loss_and_grads_sharded) against train_step's (loss_and_grads) on the
    same inputs: the loss within 1e-6 of itself, the gradients within
    GRAD_RTOL / GRAD_ATOL; its count exchanges, counted and timed; the
    collectives' times; the dryrun; zero-length batches through every
    route (zero_length_calls). Writes the inverse inputs for the
    world-2 ranks to out/inputs.pt. Returns (results, launches by path,
    the frame's pack and camera, train_step's loss and gradients on the
    host)."""
    import torch
    import torch.distributed as dist

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.ops import kernels
    from bhraytracer_tpu_torch.parallel import (
        init_multihost,
        make_mesh,
        render_image_distributed,
        shutdown,
        train_step_sharded,
    )
    from bhraytracer_tpu_torch.parallel.sharding import (
        loss_and_grads,
        loss_and_grads_sharded,
        train_step,
    )
    from bhraytracer_tpu_torch.scenes import bench_scene

    check(init_multihost(free_address(), 1, 0), "init_multihost: no group")
    res, launches = {}, {}
    try:
        mesh = make_mesh()
        check(mesh.size() == 1 and dist.get_backend() == "nccl",
              f"world 1: {mesh.size()} ranks on {dist.get_backend()}")
        pack, cam = bench_scene(dev)
        cam.width, cam.height = 800, 600
        cfg = render_config(HEADLINE)
        B.render_image(pack, cam, cfg, seed=0)
        t0 = clock(dev)
        B.render_image(pack, cam, cfg, seed=1)
        res["render_image_wall_s"] = clock(dev) - t0
        render_image_distributed(pack, cam, cfg, mesh, seed=0)
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        t0 = clock(dev)
        img, st = render_image_distributed(pack, cam, cfg, mesh, seed=1,
                                           return_stats=True)
        res["frame_wall_s"] = clock(dev) - t0
        launches["distributed"] = dict(kernels.LAUNCHES)
        res["frame_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        img = img.cpu()
        check(tuple(img.shape) == (600, 800, 3), "world 1: image shape")
        check(bool(torch.isfinite(img).all()) and float(img.std()) > 1e-3,
              "world 1: image not finite or constant")
        check(st.drop_refr == st.drop_tir == st.drop_gi == 0,
              f"world 1: dropped lanes {st}")
        res.update(segments=st.segments,
                   segs_per_s=st.segments / res["frame_wall_s"])
        ld = launches["distributed"]
        for k in FLAT + BVH + ("bhrt_shade_setup",):
            check(ld.get(k, 0) > 0, f"{k} not launched by the distributed "
                  "frame")
        for k in HBM + ANALYTIC + ("bhrt_photon_sweep",):
            check(ld.get(k, 0) == 0, f"{k} launched by the distributed frame")

        shades = []
        with recorded_shade_calls(shades):
            rec = record_trace_calls(lambda: render_image_distributed(
                pack, cam, cfg, mesh, seed=1))
        frame_call_checks(per_kernel, pack, dev, rec, "distributed")
        del rec
        errs = [shade_call_check(a, f"distributed shade call {i}")[1]
                for i, a in enumerate(shades)]
        k3 = per_kernel["bhrt_shade_setup"]
        k3.update(max_abs_err=max(k3["max_abs_err"], *errs),
                  lanes_compared=k3["lanes_compared"]
                  + sum(a[0].shape[0] for a in shades))
        res["shade_calls"] = dict(calls=len(shades), max_abs_err=max(errs))
        del shades

        inv = inverse_inputs(dev)
        torch.save(dict(target=inv["target"].cpu(),
                        mtl_diffuse=inv["params"]["mtl_diffuse"].cpu()),
                   os.path.join(out, "inputs.pt"))
        args = [inv[k] for k in ("params", "pack", "cfg", "cam", "w", "h",
                                 "px", "py", "target", "key")]
        train_step(*args[:1], None, *args[1:], lr=INVERSE_LR)
        t0 = clock(dev)
        train_step(*args[:1], None, *args[1:], lr=INVERSE_LR)
        res["train_step_wall_s"] = clock(dev) - t0
        train_step_sharded(*args[:1], None, *args[1:], mesh, lr=INVERSE_LR)
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()
        t0 = clock(dev)
        new, _, loss = train_step_sharded(*args[:1], None, *args[1:], mesh,
                                          lr=INVERSE_LR)
        res["step_wall_s"] = clock(dev) - t0
        launches["distributed_step"] = dict(kernels.LAUNCHES)
        res["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        check(bool(torch.isfinite(loss)), "world 1: step loss not finite")
        check(all(bool(torch.isfinite(v).all()) for v in new.values()),
              "world 1: step parameters not finite")
        res["step_loss"] = float(loss)
        ls = launches["distributed_step"]
        for k in FLAT + BVH:
            check(ls.get(k, 0) > 0, f"{k} not launched by the sharded step")
        one_loss, one_grads = loss_and_grads(*args)
        with exchange_stats(dev) as ex:
            w1_loss, w1_grads = loss_and_grads_sharded(*args, mesh)
        res["exchanges"] = ex
        one = (float(one_loss), {k: g.cpu() for k, g in one_grads.items()})
        check(abs(float(w1_loss) - one[0]) <= 1e-6 * abs(one[0]),
              f"world 1: step loss {float(w1_loss)} against train_step's "
              f"{one[0]}")
        res["step_vs_train_step"] = dict(
            loss=float(w1_loss), train_step_loss=one[0],
            grads=compare_grads("world 1 step gradients against train_step",
                                {k: g.cpu() for k, g in w1_grads.items()},
                                one[1]))
        res["collectives"] = collective_times(
            mesh, dev, (800 * 600, 3),
            1 + sum(v.numel() for v in inv["params"].values()))
        res["dryrun"] = dryrun_multichip(mesh, dev)
        res["zero_length"] = zero_length_calls(dev)
    finally:
        shutdown()
    return res, launches, (pack, cam), one


def distributed_phase(dev, card, per_kernel):
    """The distributed phase: world 1 (distributed_world1); world 2 on the
    card (two child processes over gloo) and, at the same time, world 2
    over gloo on the CPU (two more); the card's gathered radiance equal to
    one process's render of each half with the same folded keys, its
    reduced loss and gradients those of one process's train_step (the loss
    within 1e-5 of itself, the gradients within GRAD_RTOL / GRAD_ATOL),
    its FINISH_SIZE image against the CPU's (99% of pixels within 1e-4,
    stats equal). Returns (results, launches)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    out = os.path.join(REPO, "build", "dist_smoke")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    res, launches, frame, one = distributed_world1(dev, per_kernel, out)
    w1 = res
    ex1 = w1["exchanges"]
    print(f"distributed world 1 (NCCL) 800x600 ({card}): frame "
          f"{w1['frame_wall_s']:.3f} s against render_image's "
          f"{w1['render_image_wall_s']:.3f} s, {w1['segs_per_s']:.0f} segs/s, "
          f"peak {w1['frame_peak_gib']:.2f} GiB; step "
          f"{INVERSE_SIZE}x{INVERSE_SIZE} {w1['step_wall_s']:.3f} s against "
          f"train_step's {w1['train_step_wall_s']:.3f} s, peak "
          f"{w1['step_peak_gib']:.2f} GiB, {ex1['calls']} count exchanges "
          f"(ms {json.dumps(ex1['ms'])}), against train_step: "
          f"{json.dumps(w1['step_vs_train_step'])}; collectives "
          f"{json.dumps(w1['collectives'])}")
    print("launches distributed:", json.dumps(launches))
    print_frame_calls(per_kernel, "distributed", "world 1's 800x600 "
                      "HEADLINE frame through render_image_distributed")
    torch.cuda.empty_cache()

    cpu_out = os.path.join(out, "cpu")
    os.makedirs(cpu_out)
    with ThreadPoolExecutor(2) as pool:
        cpu_world = pool.submit(run_world, DIST_WORLD, "cpu", cpu_out)
        card_world = pool.submit(run_world, DIST_WORLD, "cuda:0", out)
        ranks, cpu_ranks = card_world.result(), cpu_world.result()

    r0 = ranks[0]
    for r in ranks[1:]:
        check(torch.equal(r["rad"], r0["rad"]) and r["loss"] == r0["loss"]
              and all(torch.equal(r["grads"][k], g)
                      for k, g in r0["grads"].items()),
              "world 2: the ranks hold different results")
    ref_rad = shard_references(dev, frame)
    err = float((r0["rad"] - ref_rad).abs().max())
    check(torch.equal(r0["rad"], ref_rad), "world 2: gathered radiance "
          f"differs from the halves' by up to {err:.3g}")
    grads = compare_grads("world 2 gradients against train_step",
                          r0["grads"], one[1])
    check(abs(r0["loss"] - one[0]) <= 1e-5 * abs(one[0]),
          f"world 2: loss {r0['loss']} against train_step's {one[0]}")

    (g_img, g_st), (c_img, c_st) = r0["small"], cpu_ranks[0]["small"]
    within = float(((g_img - c_img).abs().amax(-1) <= 1e-4).float().mean())
    check(bool(torch.isfinite(g_img).all()), "world 2 small: not finite")
    check(within >= 0.99, f"world 2 card vs CPU: {within:.4f} of pixels "
          "within 1e-4")
    check(g_st == c_st, f"world 2 card vs CPU: stats {g_st} against {c_st}")
    res["world2"] = dict(
        ranks=[{k: r[k] for k in ("frame_wall_s", "frame_peak_gib",
                                  "step_wall_s", "step_peak_gib",
                                  "process_wall_s", "collectives", "dryrun",
                                  "frame_stats", "exchanges")}
               for r in ranks],
        radiance_max_abs_err=err, loss=r0["loss"],
        train_step_loss=one[0], grads=grads,
        vs_cpu=dict(size=f"{FINISH_SIZE[0]}x{FINISH_SIZE[1]}",
                    within_1e4=within,
                    max_abs_err=float((g_img - c_img).abs().max()),
                    stats_gpu=g_st, stats_cpu=c_st,
                    cpu_process_wall_s=cpu_ranks[0]["process_wall_s"],
                    cpu_dryrun=cpu_ranks[0]["dryrun"]))
    for i, r in enumerate(res["world2"]["ranks"]):
        print(f"distributed world 2 (gloo, two ranks sharing the card: a "
              f"correctness run, not scaling) rank {i} ({card}): frame "
              f"{r['frame_wall_s']:.3f} s, step {r['step_wall_s']:.3f} s, "
              f"peak {max(r['frame_peak_gib'], r['step_peak_gib']):.2f} GiB, "
              f"process {r['process_wall_s']:.1f} s; "
              f"{r['exchanges']['calls']} count exchanges (ms "
              f"{json.dumps(r['exchanges']['ms'])}); collectives "
              f"{json.dumps(r['collectives'])}")
    print(f"distributed world 2 checks ({card}):", json.dumps(
        {k: v for k, v in res["world2"].items() if k != "ranks"}))
    return res, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import bhraytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if "--dist-rank" in args:
        i = args.index("--dist-rank")
        return dist_rank(args[i + 1:i + 6])
    from bhraytracer_tpu_torch.native import get_lib
    from bhraytracer_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    kernels.lib()
    check(get_lib() is not None, "native host helper did not build")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({os.path.relpath(kernels.library_path(), REPO)}, nvcc report "
          "beside it in .log)")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--profile" in args:
        profile_frames(dev, card, args[args.index("--profile") + 1:]
                       or list(PATHS))
        return 0
    if "--frames" in args:
        i = args.index("--frames")
        time_frames(dev, card, int(args[i + 1]), args[i + 2:] or list(PATHS))
        return 0
    if "--save-inputs" in args:
        save_inputs(dev, args[args.index("--save-inputs") + 1])
        return 0
    if "--timing" in args:
        time_inputs(dev, card, args[args.index("--timing") + 1])
        return 0
    if "--kernel9" in args:
        print(json.dumps({"kernel9": kernel9_times(
            dev, card, int(args[args.index("--kernel9") + 1]))}))
        return 0
    if "--inverse" in args:
        inverse_alone(dev, card)
        return 0
    if "--finish" in args:
        per_kernel = {k: dict(max_abs_err=0.0, lanes_compared=0,
                              walk_lanes=0) for k in FLAT + BVH}
        res, launches = finish_phase(dev, card, per_kernel)
        print(json.dumps({"finish": res, "launches": launches,
                          "calls": {k: per_kernel[k] for k in per_kernel},
                          "card": card}))
        return 0
    if "--distributed" in args:
        per_kernel = {k: dict(max_abs_err=0.0, lanes_compared=0,
                              walk_lanes=0) for k in FLAT + BVH + (
                                  "bhrt_shade_setup",)}
        res, launches = distributed_phase(dev, card, per_kernel)
        print(json.dumps({"distributed": res, "launches": launches,
                          "calls": {k: per_kernel[k] for k in per_kernel},
                          "card": card}, default=str))
        return 0
    if "--textured-gradient" in args:
        print(json.dumps({"textured_gradient": textured_gradient(dev),
                          "card": card}))
        return 0

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.models.photonmap import build_photon_map
    from bhraytracer_tpu_torch.scenes import (
        bench_scene,
        bigmesh_scene,
        grid_scene,
        textured_scene,
        tiny_scene,
    )

    pack, cam = bench_scene()
    tiny, _ = tiny_scene()
    big, big_cam = bigmesh_scene()

    per_kernel = compare_stream(pack, tiny, cam, dev)
    per_kernel.update(compare_shade(pack, cam, dev))
    bvh, route_bench = compare_bvh(pack, big, cam, dev)
    per_kernel.update(bvh)
    hbm, route_big = compare_hbm(big, big_cam, dev)
    per_kernel.update(hbm)
    pmap = build_photon_map(tiny, B.RenderConfig(**PHOTON), seed=1)
    per_kernel.update(compare_analytic(tiny, cam, dev, pmap))
    per_kernel.update(compare_photon(tiny, cam, dev, pmap))
    grid, grid_cam = grid_scene(64, dev)
    calls, shadows, _ = record_frame_calls(pack, cam)
    flat, n_flat, n_shadow = compare_flat(pack, cam, dev, calls, shadows,
                                          grid, grid_cam)
    k2 = per_kernel["bhrt_stream_anyhit"]
    k2.update(lanes_compared=k2["lanes_compared"] + n_shadow,
              frame_calls=flat.pop("shadow"))
    k1 = per_kernel["bhrt_stream_closest"]
    k1.update(lanes_compared=k1["lanes_compared"] + n_flat, **flat)
    # Kernels 1, 2, 4 and 5 on every call of a textured32 frame: the
    # textured scene has two mesh instances, each with its own transform.
    tex_pack, tex_cam = textured_scene()
    frame_call_checks(per_kernel, tex_pack, dev,
                      record_frame_calls(tex_pack, tex_cam, TEXTURED32),
                      "textured32")
    limits = compare_limits(dev)
    torch.cuda.synchronize()
    for k, v in per_kernel.items():
        print(f"{KERNELS[k]['name']}: kernel {v['ms']:.3f} ms, plain "
              f"{v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}), max abs err {v['max_abs_err']:.3g} on "
              f"{v['lanes_compared']} lanes ({v['shape']})")
    print("level-0 routes, bench scene 480K camera rays:",
          json.dumps(route_bench))
    print("routes on 480K incoherent rays, big-mesh scene:",
          json.dumps(route_big))
    print("clustered cull on the same rays, sorted (brute force 111616 face "
          "tests a ray):", json.dumps(route_big["cull"]))
    ps = per_kernel["bhrt_photon_sweep"]
    print(f"photon sweep tile cull ({ps['photons']} photons, tiles of "
          f"{ps['tile']}; level-0 and scattered 480K lanes):",
          json.dumps(ps["cull"]))
    print("photon sweep times (ms):", json.dumps(
        {k: v for k, v in ps.items() if k.endswith("_ms") or k in (
            "dense_lanes", "tile_sizes", "skewed_map")}))
    print("flat closest kernel, cull on 480K scattered bench rays (brute "
          "force 1408 face tests a ray):", json.dumps(k1["cull"]))
    print("flat closest kernel on a bench frame's calls and an 8192-face "
          "mesh:", json.dumps(flat))
    print("flat any-hit kernel, cull on 480K level-0 bench shadow rays:",
          json.dumps(k2["cull"]), "and on a bench frame's shadow calls:",
          json.dumps(k2["frame_calls"]))
    print_frame_calls(per_kernel, "textured32",
                      "6016 faces in two instances")
    print("grouped any-hit kernel (7), cull on 480K sorted scattered "
          "big-mesh rays:", json.dumps(route_big["cull"]["anyhit"]))
    k3 = per_kernel["bhrt_shade_setup"]
    print("shade kernel:", json.dumps({k: k3[k] for k in (
        "device_ms", "ptxas", "occupancy", "launches_shade_setup",
        "launches_fused_step")}))
    ka = per_kernel["bhrt_analytic_closest"]
    print("analytic closest kernel (wrapper and device):", json.dumps(
        {k: ka[k] for k in ("times_480k", "times_32768")}))
    print("analytic any-hit kernel (wrapper and device):",
          json.dumps(per_kernel["bhrt_analytic_anyhit"]["times"]))
    for k in BVH:
        v = per_kernel[k]
        print(f"{KERNELS[k]['name']} (wrapper and device; tests a ray; "
              f"results and counts equal bvh_walk_ref's on {v['walk_lanes']} "
              "lanes):", json.dumps({x: v[x] for x in (
                  "ms", "device_ms", "scattered", "bigmesh", "tests_per_ray",
                  "bound_ms", "node_rows_bound_ms", "pair_table_bytes",
                  "ptxas", "occupancy") if x in v}))
    print("kernels on 40 spheres and 40 planes:", json.dumps(limits))

    small = small_render_vs_cpu(dev)
    print("GPU vs CPU renders:", json.dumps(small))
    beyond = limit_renders_vs_cpu(dev)
    print("scenes beyond the first slices' limits, GPU vs CPU renders and the "
          "204,800-face mesh:", json.dumps(beyond))

    paths, launches = {}, {}
    for name, p, c, cfg_kw in (("bench", pack, cam, HEADLINE),
                               ("bigmesh", big, big_cam, BIGMESH)):
        paths[name], launches[name] = render_main_path(p, c, dev, cfg_kw, name)
        print(f"main path {name} 800x600 ({card}): "
              f"{paths[name]['segs_per_s']:.0f} segs/s, "
              f"{paths[name]['ms_per_chunk']:.1f} ms/chunk, image wall "
              f"{paths[name]['image_wall_s']:.3f} s, drops refr/tir/gi "
              f"{paths[name]['drop_refr']}/{paths[name]['drop_tir']}/"
              f"{paths[name]['drop_gi']}, segments {paths[name]['segments']}, "
              f"peak device memory {paths[name]['peak_memory_gib']:.2f} GiB")
        print(f"launches {name}:", json.dumps(launches[name]))
    lb, lg = launches["bench"], launches["bigmesh"]
    for k in FLAT + BVH + ("bhrt_shade_setup",):
        check(lb.get(k, 0) > 0, f"{k} not launched by the bench render")
    for k in HBM:
        check(lb.get(k, 0) == 0, f"{k} launched by the bench render")
    for k in BVH + HBM + ("bhrt_shade_setup",):
        check(lg.get(k, 0) > 0, f"{k} not launched by the big-mesh render")
    for k in FLAT:
        check(lg.get(k, 0) == 0, f"{k} launched by the big-mesh render")
    for k in ANALYTIC:
        check(lb.get(k, 0) == lg.get(k, 0) == 0,
              f"{k} launched by a mesh render")
    # Level 0 (one closest and one shadow trace per pass over the levels)
    # is the BVH kernels' only caller on the bench scene.
    levels = render_config(HEADLINE).max_levels
    check(lb["bhrt_bvh_closest"] == lb["bhrt_bvh_anyhit"]
          == lb["bhrt_shade_setup"] // levels,
          "bench render: BVH launches other than level 0's")
    # Every other level's shadow trace is kernel 2's.
    check(lb["bhrt_stream_anyhit"]
          == lb["bhrt_shade_setup"] - lb["bhrt_bvh_anyhit"],
          "bench render: flat any-hit launches other than levels >= 1's")

    tiny_pack, tiny_cam = tiny_scene()
    paths["photon"], launches["photon"] = render_photon_path(
        tiny_pack, tiny_cam, dev, pmap)
    ph = paths["photon"]
    print(f"main path photon 800x600 ({card}): map of {ph['photons']} "
          f"photons (round limit "
          f"{'reached' if ph['round_limit_reached'] else 'not reached'}, "
          f"largest bucket {ph['cell_cap']}) built in {ph['build_s']:.3f} s "
          f"inside render_image; then {ph['segs_per_s']:.0f} segs/s, "
          f"{ph['ms_per_chunk']:.1f} ms/chunk, "
          f"image wall {ph['image_wall_s']:.3f} s with the build, drops "
          f"refr/tir/gi {ph['drop_refr']}/{ph['drop_tir']}/{ph['drop_gi']}, "
          f"segments {ph['segments']}")
    print("launches photon:", json.dumps(launches["photon"]))
    lp = launches["photon"]
    for k in ANALYTIC + ("bhrt_photon_sweep",):
        check(lp.get(k, 0) > 0, f"{k} not launched by the photon render")
    for k in FLAT + BVH + HBM + ("bhrt_shade_setup",):
        check(lp.get(k, 0) == 0, f"{k} launched by the photon render")
    # Four sweeps (full, two refinements, final) per level.
    check(lp["bhrt_photon_sweep"] == 4 * B.RenderConfig(**PHOTON).max_levels,
          "photon render: sweeps other than four per level")

    # The textured scene through load_scene: level 0 on the BVH kernels,
    # the chain and the levels >= 1 on the flat stream kernels, shading
    # unfused (the fused kernel gates itself off on texture maps).
    for name, cfg_kw in (("textured", TEXTURED), ("textured32", TEXTURED32)):
        paths[name], launches[name] = render_main_path(
            tex_pack, tex_cam, dev, cfg_kw, name)
        pt = paths[name]
        print(f"main path {name} 800x600 ({card}): "
              f"{pt['segs_per_s']:.0f} segs/s, {pt['ms_per_chunk']:.1f} "
              f"ms/chunk, image wall {pt['image_wall_s']:.3f} s, drops "
              f"refr/tir/gi {pt['drop_refr']}/{pt['drop_tir']}/"
              f"{pt['drop_gi']}, segments {pt['segments']}, peak device "
              f"memory {pt['peak_memory_gib']:.2f} GiB")
        print(f"launches {name}:", json.dumps(launches[name]))
        lt, cfg = launches[name], render_config(cfg_kw)
        for k in FLAT[:1] + BVH:
            check(lt.get(k, 0) > 0, f"{k} not launched by the {name} render")
        for k in HBM + ANALYTIC + ("bhrt_shade_setup", "bhrt_photon_sweep"):
            check(lt.get(k, 0) == 0, f"{k} launched by the {name} render")
        # Level 0 is the BVH kernels' only caller, once a sample; every
        # other level's shadow trace is kernel 2's.
        check(lt["bhrt_bvh_closest"] == lt["bhrt_bvh_anyhit"] == cfg.spp,
              f"{name} render: BVH launches other than level 0's")
        check(lt.get("bhrt_stream_anyhit", 0)
              == cfg.spp * (cfg.max_levels - 1),
              f"{name} render: flat any-hit launches other than levels "
              ">= 1's")
    check(launches["textured32"].get("bhrt_stream_anyhit", 0) > 0,
          "bhrt_stream_anyhit not launched by the textured32 render")

    # Inverse rendering at 1024x1024 on the bench scene: level 0 on the BVH
    # kernels, level 1 and the chains on the flat kernels, shading unfused.
    paths["inverse"], launches["inverse"], (inv_pack, rec) = \
        inverse_main_path(dev)
    pi = paths["inverse"]
    fp, bp = pi["forward_profiled"], pi["backward_profiled"]
    print(f"main path inverse {pi['size']} ({card}): forward "
          f"{pi['forward_ms']:.1f} ms ({fp['launches']} launches, "
          f"{fp['syncs']} syncs, device busy {fp['device_busy_ms']:.1f} ms), "
          f"backward {pi['backward_ms']:.1f} ms ({bp['launches']} launches, "
          f"{bp['syncs']} syncs, device busy {bp['device_busy_ms']:.1f} ms), "
          f"peak device memory {pi['peak_memory_gib']:.2f} GiB, "
          f"Adam steps {json.dumps(pi['adam_step_s'])} s, loss "
          f"{pi['adam_losses'][0]:.6g} -> {pi['adam_losses'][-1]:.6g}, "
          f"diffuse L1 error {pi['diffuse_l1_err'][0]:.4f} -> "
          f"{pi['diffuse_l1_err'][1]:.4f}, drops {pi['drops']}")
    print("launches inverse:", json.dumps(launches["inverse"]))
    # Kernels 1, 2, 4 and 5 on every call of the inverse forward.
    frame_call_checks(per_kernel, inv_pack, dev, rec, "inverse")
    del rec
    print_frame_calls(per_kernel, "inverse",
                      f"{INVERSE_SIZE}x{INVERSE_SIZE} INVERSE forward")
    tgrad = textured_gradient(dev)
    print(f"textured gradient {tgrad['size']} ({card}):", json.dumps(tgrad))
    grads = gradients_vs_cpu(dev, pmap)
    print(f"gradients on the card vs the CPU (|g_gpu - g_cpu| <= {GRAD_RTOL} "
          f"max|g_cpu| + {GRAD_ATOL}):", json.dumps(grads))

    # The finished render: adaptive pass, aux outputs, denoiser, and the
    # command line.
    paths["finish"], launches["finish"] = finish_phase(dev, card, per_kernel)

    # Data parallelism: world 1 over NCCL, world 2 on the card and the CPU.
    paths["distributed"], dist_launches = distributed_phase(dev, card,
                                                            per_kernel)
    launches.update(dist_launches)

    tiny_cam.width, tiny_cam.height = 800, 600
    timg = B.render_image(tiny_pack, tiny_cam, render_config(HEADLINE))
    check(bool(torch.isfinite(timg).all()), "tiny_scene image not finite")
    print(json.dumps({"main_path": paths, "gradients_vs_cpu": grads,
                      "textured_gradient": tgrad, "card": card}))
    print(json.dumps({"kernels": [
        dict(**KERNELS[k], route="cuda",
             launches=sum(lx.get(k, 0) for lx in launches.values()),
             launches_by_path={p: lx.get(k, 0) for p, lx in launches.items()},
             library_ms=None, **v)
        for k, v in per_kernel.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
