#!/usr/bin/env python3
"""Smoke test of bhraytracer_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc and g++. It builds the CUDA kernels (one nvcc
per source, in parallel) and the host helper from the checkout's sources;
holds each of the seven kernels against its plain PyTorch twin on the card
at the main paths' shapes (480,000 lanes); times both level-0 routes (BVH
and stream) on the same rays; renders the two main paths through
`render_image`, each once to warm and once timed with the kernels' launch
counters set to 0 just before it: the bench scene (1,408 faces) at 800x600
with bench.py's headline config, and the big-mesh scene (111,616 faces)
with bench.py's `_bigmesh_leg` config; checks the images, a 64x48 render of
the small scenes and a 32x24 render of the big-mesh scene against the CPU
twins; and prints the card, the numbers and one JSON line per result. The
last line is the device line. Any failed check raises and the script exits
non-zero; so does a run without a CUDA card or outside a checkout.

    python3 chip_smoke.py --profile [bench] [bigmesh]

builds the kernels and profiles one warm frame of each named main path
(both by default) with torch.profiler instead (launches, device busy time,
kernels by device time, host operators by CPU time), writing the tables
under chiprun_out/.

    python3 chip_smoke.py --frames N [bench] [bigmesh]

builds the kernels and times N frames of each named main path after one
warm frame (host clock around each frame, ending in a synchronise), one
JSON line per frame. These two modes read only `<name>_scene` and
`render_image`, so a copy of this script placed in an older checkout
times or profiles that checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LANES = 480000
SUBSET = 16384  # lanes the brute-force twins check on the big-mesh scene
# Headline config of bench.py:167-176, less fused_levels (a TPU knob) and
# texture_sample_count (the scenes have no textures).
HEADLINE = dict(spp=1, gi_bounces=3, extra_refr_levels=2, tir_bounces=16,
                chunk_rays=480000, refr_capacity=0.08)
# bench.py:473-475 (_bigmesh_leg), less the same two knobs.
BIGMESH = dict(spp=1, gi_bounces=1, extra_refr_levels=1, tir_bounces=8,
               chunk_rays=480000)

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
}
# The __global__ functions of csrc/, as the profiler names them.
PORT_KERNEL_FUNCTIONS = ("closest_kernel", "anyhit_kernel", "shade_kernel",
                         "bvh_closest_kernel", "bvh_anyhit_kernel",
                         "hbm_closest_kernel", "hbm_anyhit_kernel")
FLAT = ("bhrt_stream_closest", "bhrt_stream_anyhit")
BVH = ("bhrt_bvh_closest", "bhrt_bvh_anyhit")
HBM = ("bhrt_stream_closest_hbm", "bhrt_stream_anyhit_hbm")

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

    cfg = PT.RenderConfig(**cfg_kw)
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
        pack.bvh_nodes, pack.bvh_faces, pack.bvh_depth, sph, pln, o, d,
        t_init, side, counts))


def occlusion_ops(pack, o, d, t_max, t_min, ana_bias) -> dict:
    """Operations the occlusion of these rays needs, as closest_ops counts
    them (kernel 5's traversal, which stops at the first occluder)."""
    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops.trace import analytic_tables

    sph, pln = analytic_tables(pack)
    return _traversal_ops(pack, o, lambda counts: B.bvh_anyhit(
        pack.bvh_nodes, pack.bvh_faces, pack.bvh_depth, sph, pln, o, d,
        t_max, t_min, ana_bias, counts=counts))


def op_bound(n_bytes: float, work: dict) -> dict:
    """bound() of closest_ops / occlusion_ops work, with its counts."""
    return dict(**bound(n_bytes, work["ops"]), box_tests=work["box_tests"],
                tri_tests=work["tri_tests"])


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
    """Kernels 1 and 2 against their twins at 480,000 lanes."""
    import torch

    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables

    cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev)
    t_init = torch.full((LANES,), BIG, device=dev)
    o2, d2 = scattered(o, d, hit, 0)
    out = {}
    errs = []
    for p, oo, dd, side in ((pack, o, d, "front"), (pack, o2, d2, "both"),
                            (tiny, o, d, "front")):
        sph, pln = analytic_tables(p)
        t1, k1 = K.stream_closest(p.stream_rows, sph, pln, oo, dd, t_init, side)
        t0, k0 = K.stream_closest_ref(p.stream_rows, sph, pln, oo, dd, t_init,
                                      K.SIDES[side])
        errs.append(compare_exact("stream_closest", t1, k1, t0, k0))
    sph, pln = analytic_tables(pack)
    rows = pack.stream_rows
    out["bhrt_stream_closest"] = dict(
        max_abs_err=max(errs), lanes_compared=3 * LANES,
        ms=cuda_ms(lambda: K.stream_closest(rows, sph, pln, o2, d2, t_init,
                                            "both"), 5),
        plain_ms=cuda_ms(lambda: K.stream_closest_ref(rows, sph, pln, o2, d2,
                                                      t_init, 2), 2),
        shape="480K scattered rays x 1408 faces, side both",
        **op_bound(nbytes(rows, sph, pln, o2, d2, t_init) + LANES * 8,
                   closest_ops(pack, o2, d2, t_init, "both")))

    fo = S.shade_setup(pack, cfg, o, d, hit, shade, u_tab)
    so, sd = fo.shadow_o.contiguous(), fo.shadow_d.contiguous()
    tm = fo.shadow_tmax.contiguous()
    n_bad = 0
    for p in (pack, tiny):
        sph, pln = analytic_tables(p)
        a1 = K.stream_anyhit(p.stream_rows, sph, pln, so, sd, tm,
                             MESH_SHADOW_BIAS, cfg.shadow_bias, False)
        a0 = K.stream_anyhit_ref(p.stream_rows, sph, pln, so, sd, tm,
                                 MESH_SHADOW_BIAS, cfg.shadow_bias, False)
        check(bool(a0.any()), "stream_anyhit: no occluded lane to compare")
        n_bad += int((a1 != a0).sum())
    check(n_bad == 0, f"stream_anyhit: {n_bad} lanes differ")
    sph, pln = analytic_tables(pack)
    out["bhrt_stream_anyhit"] = dict(
        max_abs_err=float(n_bad), lanes_compared=2 * LANES,
        ms=cuda_ms(lambda: K.stream_anyhit(rows, sph, pln, so, sd, tm,
                                           MESH_SHADOW_BIAS,
                                           cfg.shadow_bias), 5),
        plain_ms=cuda_ms(lambda: K.stream_anyhit_ref(
            rows, sph, pln, so, sd, tm, MESH_SHADOW_BIAS, cfg.shadow_bias,
            False), 2),
        shape="480K level-0 shadow rays x 1408 faces",
        **op_bound(nbytes(rows, sph, pln, so, sd, tm) + LANES,
                   occlusion_ops(pack, so, sd, tm, MESH_SHADOW_BIAS,
                                 cfg.shadow_bias)))
    return out


def compare_shade(pack, cam, dev):
    """Kernel 3 against its twin at 480,000 lanes."""
    import torch

    from bhraytracer_tpu_torch.ops import shade as S

    cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev)
    inst, mtl, light = S.shade_tables(pack)
    args = (*S.shade_inputs(o, d, hit, shade, u_tab), pack.resolve_rows, inst,
            pack.n_sph, pack.n_pln, pack.n_msh, mtl, light, cfg.bias)
    k = S.shade_planes(*args)
    r = S.shade_setup_ref(*args)
    check(bool(shade.sum() > LANES // 4), "shade_setup: too few shaded lanes")
    # Discrete outputs (mtl, gate, rr0) on every lane; float outputs on the
    # shaded lanes (miss lanes carry junk every consumer masks).
    for row, name in ((7, "mtl"), (15, "gate"), (16, "rr0")):
        bad = int((k[row] != r[row]).sum())
        check(bad == 0, f"shade_setup: {name} differs on {bad} lanes")
    fk, fr = k[:, shade], r[:, shade]
    close = torch.isclose(fk, fr, rtol=1e-5, atol=1e-5)
    bad = int((~close.all(0)).sum())
    check(bad == 0, f"shade_setup: {bad} shaded lanes beyond 1e-5")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return {"bhrt_shade_setup": dict(
        max_abs_err=float((fk - fr).abs().max()), lanes_compared=LANES,
        ms=cuda_ms(lambda: S.shade_planes(*args), 5),
        plain_ms=cuda_ms(lambda: S.shade_setup_ref(*args), 2),
        shape="480K level-0 lanes",
        **bound(nbytes(*tensors, k), elementwise_ops(
            lambda: S.shade_setup_ref(*args)))),
    }


def subset(dev):
    """The fixed lanes the brute-force twins check on the big-mesh scene:
    SUBSET lanes spread evenly over the 480,000, in whole 128-lane blocks."""
    import torch

    from bhraytracer_tpu_torch.ops.stream_hbm import RAY_BLOCK

    nb = SUBSET // RAY_BLOCK
    blocks = torch.arange(nb, device=dev) * (LANES // RAY_BLOCK // nb)
    return (blocks[:, None] * RAY_BLOCK
            + torch.arange(RAY_BLOCK, device=dev)).reshape(-1)


def compare_bvh(bench, big, cam, dev):
    """Kernels 4 and 5 against their twins: the bench scene's 480K level-0
    camera rays and shadow rays, whole; the big-mesh scene's, on SUBSET
    lanes. Both level-0 routes are timed on the same camera rays."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables

    t_init = torch.full((LANES,), BIG, device=dev)
    idx = subset(dev)
    res, errs, occ_bad = {}, [], 0
    for name, pack in (("bench", bench), ("bigmesh", big)):
        cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev)
        sph, pln = analytic_tables(pack)
        tabs = (pack.bvh_nodes, pack.bvh_faces, pack.bvh_depth)
        fo = S.shade_setup(pack, cfg, o, d, hit, shade, u_tab)
        so, sd = fo.shadow_o.contiguous(), fo.shadow_d.contiguous()
        tm = fo.shadow_tmax.contiguous()
        sel = slice(None) if name == "bench" else idx
        t1, k1 = B.bvh_closest(*tabs, sph, pln, o, d, t_init, "front")
        t0, k0 = B.bvh_closest_ref(pack.bvh_faces, sph, pln, o[sel], d[sel],
                                   t_init[sel], 0)
        errs.append(compare_exact(f"bvh_closest ({name})", t1[sel], k1[sel],
                                  t0, k0))
        a1 = B.bvh_anyhit(*tabs, sph, pln, so, sd, tm, MESH_SHADOW_BIAS,
                          cfg.shadow_bias)
        a0 = B.bvh_anyhit_ref(pack.bvh_faces, sph, pln, so[sel], sd[sel],
                              tm[sel], MESH_SHADOW_BIAS, cfg.shadow_bias,
                              False)
        check(bool(a0.any()), f"bvh_anyhit ({name}): no occluded lane")
        occ_bad += int((a1[sel] != a0).sum())
        lanes = LANES if name == "bench" else SUBSET
        tab_bytes = nbytes(pack.bvh_nodes, pack.bvh_faces, sph, pln)
        closest = dict(
            lanes_compared=lanes,
            ms=cuda_ms(lambda: B.bvh_closest(*tabs, sph, pln, o, d, t_init,
                                             "front"), 5),
            plain_ms=cuda_ms(lambda: B.bvh_closest_ref(
                pack.bvh_faces, sph, pln, o[sel], d[sel], t_init[sel], 0), 1),
            plain_lanes=lanes,
            **op_bound(tab_bytes + nbytes(o, d, t_init) + LANES * 8,
                       closest_ops(pack, o, d, t_init, "front")))
        anyhit = dict(
            lanes_compared=lanes,
            ms=cuda_ms(lambda: B.bvh_anyhit(*tabs, sph, pln, so, sd, tm,
                                            MESH_SHADOW_BIAS,
                                            cfg.shadow_bias), 5),
            plain_ms=cuda_ms(lambda: B.bvh_anyhit_ref(
                pack.bvh_faces, sph, pln, so[sel], sd[sel], tm[sel],
                MESH_SHADOW_BIAS, cfg.shadow_bias, False), 1),
            plain_lanes=lanes,
            **op_bound(tab_bytes + nbytes(so, sd, tm) + LANES,
                       occlusion_ops(pack, so, sd, tm, MESH_SHADOW_BIAS,
                                     cfg.shadow_bias)))
        res[name] = (closest, anyhit)
        if name == "bench":
            # The other level-0 route on the same camera rays (the flat
            # stream kernel), and both routes on the scattered rays
            # compare_stream times (the levels >= 1 kind).
            o2, d2 = scattered(o, d, hit, 0)
            res["route_bench"] = dict(
                bvh_closest_ms=closest["ms"],
                stream_closest_ms=cuda_ms(lambda: K.stream_closest(
                    pack.stream_rows, sph, pln, o, d, t_init, "front"), 5),
                bvh_anyhit_ms=anyhit["ms"],
                stream_anyhit_ms=cuda_ms(lambda: K.stream_anyhit(
                    pack.stream_rows, sph, pln, so, sd, tm, MESH_SHADOW_BIAS,
                    cfg.shadow_bias), 5),
                scattered_bvh_closest_ms=cuda_ms(lambda: B.bvh_closest(
                    *tabs, sph, pln, o2, d2, t_init, "both"), 5),
                scattered_stream_closest_ms=cuda_ms(lambda: K.stream_closest(
                    pack.stream_rows, sph, pln, o2, d2, t_init, "both"), 5))
    check(occ_bad == 0, f"bvh_anyhit: {occ_bad} lanes differ")
    (bc, ba), (gc, ga) = res["bench"], res["bigmesh"]
    out = {
        "bhrt_bvh_closest": dict(
            max_abs_err=max(errs), **bc, shape="480K level-0 camera rays, "
            "bench scene (1408 faces)", bigmesh=gc),
        "bhrt_bvh_anyhit": dict(
            max_abs_err=float(occ_bad), **ba, shape="480K level-0 shadow "
            "rays, bench scene (1408 faces)", bigmesh=ga),
    }
    return out, res["route_bench"]


def compare_hbm(big, cam, dev):
    """Kernels 6 and 7 against their twins on the big-mesh scene: 480K
    scattered secondary rays from the level-0 hits, coherence-sorted as the
    router sorts them; the twins run on SUBSET lanes in whole blocks, so
    they see the kernel's own blocks. The grouped route is also held to the
    flat twin, and timed against the BVH kernel on the same rays."""
    import torch

    from bhraytracer_tpu_torch.ops import bvh as B
    from bhraytracer_tpu_torch.ops import stream as K
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
    rows, boxes = H.group_tables(big, H.GROUP)
    g = H.GROUP
    t_init = torch.full((LANES,), BIG, device=dev)
    order = coherence_order(big, o2, d2, t_init)
    os_, ds_ = o2[order].contiguous(), d2[order].contiguous()
    tm = torch.where(torch.arange(LANES, device=dev) % 3 == 0, BIG, 1.0)
    order_s = coherence_order(big, o2, d2, tm)
    so, sd, stm = (x[order_s].contiguous() for x in (o2, d2, tm))
    idx = subset(dev)

    t1, k1 = H.stream_closest_hbm(rows, boxes, g, sph, pln, os_, ds_, t_init,
                                  "both")
    t0, k0 = H.stream_closest_hbm_ref(rows, boxes, g, sph, pln, os_[idx],
                                      ds_[idx], t_init[idx], 2)
    err = compare_exact("stream_closest_hbm", t1[idx], k1[idx], t0, k0)
    tf, kf = K.stream_closest_ref(big.stream_rows, sph, pln, os_[idx],
                                  ds_[idx], t_init[idx], 2)
    compare_exact("stream_closest_hbm vs the flat twin", t1[idx], k1[idx],
                  tf, kf)
    a1 = H.stream_anyhit_hbm(rows, boxes, g, sph, pln, so, sd, stm,
                             MESH_SHADOW_BIAS, cfg.shadow_bias)
    a0 = H.stream_anyhit_hbm_ref(rows, boxes, g, sph, pln, so[idx], sd[idx],
                                 stm[idx], MESH_SHADOW_BIAS, cfg.shadow_bias,
                                 False)
    af = K.stream_anyhit_ref(big.stream_rows, sph, pln, so[idx], sd[idx],
                             stm[idx], MESH_SHADOW_BIAS, cfg.shadow_bias,
                             False)
    check(bool(a0.any()), "stream_anyhit_hbm: no occluded lane")
    n_bad = int((a1[idx] != a0).sum())
    check(n_bad == 0, f"stream_anyhit_hbm: {n_bad} lanes differ")
    check(bool((a0 == af).all()), "stream_anyhit_hbm: the flat twin differs")
    tab_bytes = nbytes(rows, boxes, sph, pln)
    out = {
        "bhrt_stream_closest_hbm": dict(
            max_abs_err=err, lanes_compared=SUBSET,
            ms=cuda_ms(lambda: H.stream_closest_hbm(
                rows, boxes, g, sph, pln, os_, ds_, t_init, "both"), 5),
            plain_ms=cuda_ms(lambda: H.stream_closest_hbm_ref(
                rows, boxes, g, sph, pln, os_[idx], ds_[idx], t_init[idx], 2),
                1),
            plain_lanes=SUBSET,
            shape="480K scattered sorted rays x 111616 faces, side both",
            **op_bound(tab_bytes + nbytes(os_, ds_, t_init) + LANES * 8,
                       closest_ops(big, os_, ds_, t_init, "both"))),
        "bhrt_stream_anyhit_hbm": dict(
            max_abs_err=float(n_bad), lanes_compared=SUBSET,
            ms=cuda_ms(lambda: H.stream_anyhit_hbm(
                rows, boxes, g, sph, pln, so, sd, stm, MESH_SHADOW_BIAS,
                cfg.shadow_bias), 5),
            plain_ms=cuda_ms(lambda: H.stream_anyhit_hbm_ref(
                rows, boxes, g, sph, pln, so[idx], sd[idx], stm[idx],
                MESH_SHADOW_BIAS, cfg.shadow_bias, False), 1),
            plain_lanes=SUBSET,
            shape="480K scattered sorted rays x 111616 faces, t_max 1 or BIG",
            **op_bound(tab_bytes + nbytes(so, sd, stm) + LANES,
                       occlusion_ops(big, so, sd, stm, MESH_SHADOW_BIAS,
                                     cfg.shadow_bias))),
    }

    def routed():
        order = coherence_order(big, o2, d2, t_init)
        t, k = H.stream_closest_hbm(rows, boxes, g, sph, pln,
                                    o2[order].contiguous(),
                                    d2[order].contiguous(), t_init, "both")
        inv = inverse_permutation(order)
        return t[inv], k[inv]

    tabs = (big.bvh_nodes, big.bvh_faces, big.bvh_depth)
    route = dict(
        hbm_closest_ms=out["bhrt_stream_closest_hbm"]["ms"],
        hbm_closest_with_sort_ms=cuda_ms(routed, 5),
        bvh_closest_ms=cuda_ms(lambda: B.bvh_closest(
            *tabs, sph, pln, o2, d2, t_init, "both"), 5),
        bvh_closest_sorted_ms=cuda_ms(lambda: B.bvh_closest(
            *tabs, sph, pln, os_, ds_, t_init, "both"), 5))
    return out, route


def render_main_path(pack, cam, dev, cfg_kw, name):
    """One main path at 800x600: warm, then timed with the launch counters
    from 0 just before it and read just after."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.ops import kernels

    cfg = B.RenderConfig(**cfg_kw)
    cam.width, cam.height = 800, 600
    B.render_image(pack, cam, cfg, seed=0)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    img, st = B.render_image(pack, cam, cfg, seed=1, return_stats=True)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    img = img.cpu()
    t_image = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
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
                image_mean=float(img.mean())), launches


def small_render_vs_cpu(dev):
    """Renders on the card (kernels) and on the CPU (twins): 64x48 of the
    small scenes, 32x24 of the big-mesh scene; the test suite's tolerances
    (tests/test_torch_render.py) and equal segment counts."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.scenes import bench_scene, bigmesh_scene, tiny_scene

    res = {}
    for name, fn, (w, h), cfg_kw in (
            ("tiny", tiny_scene, (64, 48), {}),
            ("bench", bench_scene, (64, 48), {}),
            ("bigmesh", bigmesh_scene, (32, 24), BIGMESH)):
        cfg = B.RenderConfig(**{**dict(spp=1, gi_bounces=1, extra_refr_levels=1,
                                       tir_bounces=4), **cfg_kw,
                                "chunk_rays": w * h})
        out = []
        for device in (dev, "cpu"):
            pack, cam = fn(device)
            cam.width, cam.height = w, h
            img, st = B.render_image(pack, cam, cfg, seed=0, return_stats=True)
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


def profile_frames(dev, card, names):
    """torch.profiler over one warm frame of each named main path:
    launches, device busy time, the kernels by device time and the host
    operators by CPU time (tables under chiprun_out/)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch import scenes

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    for name in names:
        pack, cam = getattr(scenes, f"{name}_scene")(dev)
        cam.width, cam.height = 800, 600
        cfg = B.RenderConfig(**(HEADLINE if name == "bench" else BIGMESH))
        B.render_image(pack, cam, cfg, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        B.render_image(pack, cam, cfg, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            B.render_image(pack, cam, cfg, seed=1)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        ka = prof.key_averages()
        col = ("self_device_time_total"
               if hasattr(ka[0], "self_device_time_total")
               else "self_cuda_time_total")
        # Device time: the events that ran on the card (the operator rows
        # above them carry the same time again), as the table's total.
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
        table = ka.table(sort_by=col, row_limit=60)
        host = ka.table(sort_by="self_cpu_time_total", row_limit=40)
        with open(os.path.join(REPO, "chiprun_out",
                               f"profile_{name}.txt"), "w") as f:
            f.write(f"{card}\n{table}\n{host}\n")
        print(json.dumps({"profile": name, "card": card, "wall_s": wall,
                          "profiled_wall_s": wall_prof,
                          "device_busy_ms": dev_us / 1e3,
                          "kernel_launches": launches, "syncs": syncs,
                          "port_kernels_calls_ms": ours}))
        print(ka.table(sort_by=col, row_limit=15))


def time_frames(dev, card, n: int, names):
    """N timed frames of each named main path, after a warm one."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch import scenes

    for name in names:
        pack, cam = getattr(scenes, f"{name}_scene")(dev)
        cam.width, cam.height = 800, 600
        cfg = B.RenderConfig(**(HEADLINE if name == "bench" else BIGMESH))
        B.render_image(pack, cam, cfg, seed=0)
        for seed in range(1, n + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = B.render_image(pack, cam, cfg, seed=seed,
                                   return_stats=True)
            torch.cuda.synchronize()
            print(json.dumps({"frame": name, "seed": seed, "card": card,
                              "wall_s": time.perf_counter() - t0,
                              "segments": st.segments}))


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
    args = sys.argv[1:]
    if "--profile" in args:
        profile_frames(dev, card, args[args.index("--profile") + 1:]
                       or ["bench", "bigmesh"])
        return 0
    if "--frames" in args:
        i = args.index("--frames")
        time_frames(dev, card, int(args[i + 1]),
                    args[i + 2:] or ["bench", "bigmesh"])
        return 0

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.scenes import bench_scene, bigmesh_scene, tiny_scene

    pack, cam = bench_scene()
    tiny, _ = tiny_scene()
    big, big_cam = bigmesh_scene()

    per_kernel = compare_stream(pack, tiny, cam, dev)
    per_kernel.update(compare_shade(pack, cam, dev))
    bvh, route_bench = compare_bvh(pack, big, cam, dev)
    per_kernel.update(bvh)
    hbm, route_big = compare_hbm(big, big_cam, dev)
    per_kernel.update(hbm)
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

    small = small_render_vs_cpu(dev)
    print("GPU vs CPU renders:", json.dumps(small))

    paths, launches = {}, {}
    for name, p, c, cfg_kw in (("bench", pack, cam, HEADLINE),
                               ("bigmesh", big, big_cam, BIGMESH)):
        paths[name], launches[name] = render_main_path(p, c, dev, cfg_kw, name)
        print(f"main path {name} 800x600 ({card}): "
              f"{paths[name]['segs_per_s']:.0f} segs/s, "
              f"{paths[name]['ms_per_chunk']:.1f} ms/chunk, image wall "
              f"{paths[name]['image_wall_s']:.3f} s, drops refr/tir/gi "
              f"{paths[name]['drop_refr']}/{paths[name]['drop_tir']}/"
              f"{paths[name]['drop_gi']}, segments {paths[name]['segments']}")
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
    # Level 0 (one closest and one shadow trace per pass over the levels)
    # is the BVH kernels' only caller on the bench scene.
    levels = B.RenderConfig(**HEADLINE).max_levels
    check(lb["bhrt_bvh_closest"] == lb["bhrt_bvh_anyhit"]
          == lb["bhrt_shade_setup"] // levels,
          "bench render: BVH launches other than level 0's")

    tiny_pack, tiny_cam = tiny_scene()
    tiny_cam.width, tiny_cam.height = 800, 600
    timg = B.render_image(tiny_pack, tiny_cam, B.RenderConfig(**HEADLINE))
    check(bool(torch.isfinite(timg).all()), "tiny_scene image not finite")
    print(json.dumps({"main_path": paths, "card": card}))
    print(json.dumps({"kernels": [
        dict(**KERNELS[k], route="cuda",
             launches=lb.get(k, 0) + lg.get(k, 0),
             launches_by_path={"bench": lb.get(k, 0),
                               "bigmesh": lg.get(k, 0)},
             library_ms=None, **v)
        for k, v in per_kernel.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
