#!/usr/bin/env python3
"""Smoke test of bhraytracer_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc and g++. It builds the CUDA kernels and the
host helper from the checkout's sources; holds each kernel against its
plain PyTorch twin on the card at the main path's shapes (480,000 lanes of
the bench scene); renders the bench scene at 800x600 with bench.py's
headline config through `render_image`, once to warm and once timed, with
the kernels' launch counters set to 0 just before the timed render; checks
the image, and a 64x48 render against the CPU twins; and prints the card,
the numbers and one JSON line per result. The last line is the device
line. Any failed check raises and the script exits non-zero; so does a run
without a CUDA card or outside a checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LANES = 480000
# Headline config of bench.py:167-176, less fused_levels (a TPU knob) and
# texture_sample_count (the slice's scenes have no textures).
HEADLINE = dict(spp=1, gi_bounces=3, extra_refr_levels=2, tir_bounces=16,
                chunk_rays=480000, refr_capacity=0.08)

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
}


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


def level0(pack, cam, dev):
    """The main path's level-0 inputs at 800x600 = 480,000 lanes: camera
    rays, their closest hits, the shade mask and the level's uniforms."""
    import torch

    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.ops.trace import trace_closest

    cfg = PT.RenderConfig(**HEADLINE)
    key = rng.fold_in(rng.fold_in(rng.prng_key(0, dev), 0), 0)
    o, d, _ = PT._raygen(pack, cfg, from_scene_camera(cam, dev), 800, 600,
                         LANES, 0, key)
    hit = trace_closest(pack, o, d, "front")
    u_tab = rng.uniform(rng.fold_in(PT._level_key(key, 0), 1), (LANES, 13))
    return cfg, o.contiguous(), d.contiguous(), hit, hit.hit.clone(), u_tab


def compare_stream(pack, tiny, cam, dev):
    """Kernels 1 and 2 against their twins at 480,000 lanes."""
    import torch

    from bhraytracer_tpu_torch.ops import shade as S
    from bhraytracer_tpu_torch.ops import stream as K
    from bhraytracer_tpu_torch.ops.linalg import BIG
    from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables

    cfg, o, d, hit, shade, u_tab = level0(pack, cam, dev)
    t_init = torch.full((LANES,), BIG, device=dev)
    # A scattered population as well: secondary rays from the hit points.
    gen = torch.Generator(device=dev).manual_seed(0)
    d2 = torch.randn((LANES, 3), generator=gen, device=dev)
    o2 = torch.where(hit.hit[:, None], o + d * hit.t[:, None].clamp_max(1e3)
                     - 1e-3 * d, o).contiguous()
    out = {}
    errs, n_bad = [], 0
    for p, oo, dd, side in ((pack, o, d, "front"), (pack, o2, d2, "both"),
                            (tiny, o, d, "front")):
        sph, pln = analytic_tables(p)
        t1, k1 = K.stream_closest(p.stream_rows, sph, pln, oo, dd, t_init, side)
        t0, k0 = K.stream_closest_ref(p.stream_rows, sph, pln, oo, dd, t_init,
                                      K.SIDES[side])
        hit_both = (t0 < BIG) & (t1 < BIG)
        check(bool(((t0 < BIG) == (t1 < BIG)).all()),
              "stream_closest: hit sets differ")
        close = torch.isclose(t1[hit_both], t0[hit_both], rtol=1e-6, atol=1e-6)
        check(bool(close.all()),
              f"stream_closest: {int((~close).sum())} t beyond 1e-6")
        check(bool(hit_both.any()), "stream_closest: no hit to compare")
        n_bad += int((k1 != k0).sum())
        errs.append(float((t1[hit_both] - t0[hit_both]).abs().max()))
    # Keys: equal except the equal-t seam family (none expected with the
    # same formulas on the same card).
    check(n_bad <= LANES * 1e-4, f"stream_closest: {n_bad} keys differ")
    sph, pln = analytic_tables(pack)
    out["bhrt_stream_closest"] = dict(
        max_abs_err=max(errs), key_mismatches=n_bad,
        ms=cuda_ms(lambda: K.stream_closest(pack.stream_rows, sph, pln, o2, d2,
                                            t_init, "both"), 5),
        plain_ms=cuda_ms(lambda: K.stream_closest_ref(pack.stream_rows, sph,
                                                      pln, o2, d2, t_init, 2), 2))

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
        max_abs_err=float(n_bad),
        ms=cuda_ms(lambda: K.stream_anyhit(pack.stream_rows, sph, pln, so, sd,
                                           tm, MESH_SHADOW_BIAS,
                                           cfg.shadow_bias), 5),
        plain_ms=cuda_ms(lambda: K.stream_anyhit_ref(
            pack.stream_rows, sph, pln, so, sd, tm, MESH_SHADOW_BIAS,
            cfg.shadow_bias, False), 2))
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
    return {"bhrt_shade_setup": dict(
        max_abs_err=float((fk - fr).abs().max()),
        ms=cuda_ms(lambda: S.shade_planes(*args), 5),
        plain_ms=cuda_ms(lambda: S.shade_setup_ref(*args), 2))}


def render_main_path(pack, cam, dev):
    """bench_scene at 800x600 with the headline config: warm, then timed
    with the launch counters from 0."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.ops import kernels

    cfg = B.RenderConfig(**HEADLINE)
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
    check(tuple(img.shape) == (600, 800, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image not finite")
    check(float(img.std()) > 1e-3, "image is constant")
    for name in KERNELS:
        check(launches.get(name, 0) > 0, f"{name} not launched by the render")
    return dict(segments=st.segments, segs_per_s=st.segments / t_render,
                ms_per_chunk=t_render / n_chunks * 1e3,
                image_wall_s=t_image, drop_refr=st.drop_refr,
                drop_tir=st.drop_tir, drop_gi=st.drop_gi,
                image_mean=float(img.mean())), launches


def small_render_vs_cpu(dev):
    """64x48 renders of both scenes on the card (kernels) and on the CPU
    (twins); the test suite's tolerances (tests/test_torch_render.py)."""
    import torch

    import bhraytracer_tpu_torch as B
    from bhraytracer_tpu_torch.scenes import bench_scene, tiny_scene

    cfg = B.RenderConfig(spp=1, gi_bounces=1, extra_refr_levels=1,
                         tir_bounces=4, chunk_rays=64 * 48)
    res = {}
    for name, fn in (("tiny", tiny_scene), ("bench", bench_scene)):
        out = []
        for device in (dev, "cpu"):
            pack, cam = fn(device)
            cam.width, cam.height = 64, 48
            img, st = B.render_image(pack, cam, cfg, seed=0, return_stats=True)
            out.append((img.cpu(), st))
        (g, sg), (c, sc) = out
        check(bool(torch.isfinite(g).all()), f"{name}: GPU image not finite")
        within = float(((g - c).abs().amax(-1) <= 1e-4).float().mean())
        mean_abs = float((g - c).abs().mean())
        res[name] = dict(within_1e4=within, mean_abs=mean_abs,
                         segs_gpu=sg.segments, segs_cpu=sc.segments)
        check(within >= 0.99 and mean_abs < 1e-3,
              f"{name}: GPU vs CPU render {within:.4f} within 1e-4, "
              f"mean abs {mean_abs:.2e}")
    return res


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
    from bhraytracer_tpu_torch.scenes import bench_scene, tiny_scene

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
    pack, cam = bench_scene(dev)
    tiny, _ = tiny_scene(dev)

    per_kernel = compare_stream(pack, tiny, cam, dev)
    per_kernel.update(compare_shade(pack, cam, dev))
    torch.cuda.synchronize()
    for k, v in per_kernel.items():
        print(f"{KERNELS[k]['name']}: kernel {v['ms']:.3f} ms, plain "
              f"{v['plain_ms']:.3f} ms, max abs err {v['max_abs_err']:.3g}")

    small = small_render_vs_cpu(dev)
    print("64x48 GPU vs CPU:", json.dumps(small))
    main_path, launches = render_main_path(pack, cam, dev)
    tiny_pack, tiny_cam = tiny_scene(dev)
    tiny_cam.width, tiny_cam.height = 800, 600
    import bhraytracer_tpu_torch as B

    timg = B.render_image(tiny_pack, tiny_cam, B.RenderConfig(**HEADLINE))
    check(bool(torch.isfinite(timg).all()), "tiny_scene image not finite")
    print(f"main path (bench_scene 800x600, headline config, {card}): "
          f"{main_path['segs_per_s']:.0f} segs/s, "
          f"{main_path['ms_per_chunk']:.1f} ms/chunk, image wall "
          f"{main_path['image_wall_s']:.3f} s, drops refr/tir/gi "
          f"{main_path['drop_refr']}/{main_path['drop_tir']}/"
          f"{main_path['drop_gi']}, segments {main_path['segments']}")
    print("launches:", json.dumps(launches))
    print(json.dumps({"main_path": main_path, "card": card}))
    print(json.dumps({"kernels": [
        dict(**KERNELS[k], route="cuda", launches=launches[k],
             max_abs_err=v["max_abs_err"], ms=v["ms"], plain_ms=v["plain_ms"])
        for k, v in per_kernel.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
