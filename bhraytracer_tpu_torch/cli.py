"""Command line (the port of bhraytracer_tpu/cli.py): the offline stand-in
for the reference's interactive GLUT viewport (viewport.cpp) and its
PhotonMapViewer tool.

  python -m bhraytracer_tpu_torch render scene.xml -o out.png [--spp N] ...
      BeginRender + SaveImages (Main.cpp:178-242, 414-417) on the card;
      --cpu renders on the CPU. --zbuffer and --probe stand in for the
      viewport's z view and click inspector (viewport.cpp:375-387,
      489-500).

  python -m bhraytracer_tpu_torch photonviz map.dat -o out.png
      PhotonMapViewer's point cloud (PhotonMapViz.cpp:159-231) as an
      orthographic splat render.

  python -m bhraytracer_tpu_torch info scene.xml
      The scene's structure as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

CHUNK_CARD = 480000  # lanes a chunk on the card: an 800x600 frame in one
CHUNK_CPU = 16384


def _add_render_args(p):
    p.add_argument("scene", help="scene XML file (reference dialect)")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--resource-root", default=None,
                   help="root for OBJ/texture paths (default: scene dir)")
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--gi-bounces", type=int, default=3)
    p.add_argument("--tir-bounces", type=int, default=16)
    p.add_argument("--extra-refr-levels", type=int, default=2)
    p.add_argument("--width", type=int, default=None, help="override camera width")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-rays", type=int, default=None,
                   help=f"lanes a chunk (default: {CHUNK_CARD} on the card, "
                        f"{CHUNK_CPU} on the CPU)")
    p.add_argument("--no-gamma", action="store_true")
    p.add_argument("--adaptive", type=int, metavar="EXTRA_SPP", default=0,
                   help="adaptive sampling: give the highest-contrast "
                        "pixels EXTRA_SPP extra samples after the base pass")
    p.add_argument("--adaptive-fraction", type=float, default=0.15,
                   help="fraction of pixels the adaptive pass refines")
    p.add_argument("--texture-taps", type=int, default=32)
    p.add_argument("--photon-map", action="store_true",
                   help="build + use a caustic photon map (USE_PhotonMap)")
    p.add_argument("--photon-count", type=int, default=1 << 17)
    p.add_argument("--save-photons", default=None,
                   help="write the built photon map to a reference-format .dat")
    p.add_argument("--zbuffer", default=None, help="also save the z-buffer PNG")
    p.add_argument("--probe", type=int, nargs=2, metavar=("X", "Y"), default=None,
                   help="print color + z at a pixel (viewport click inspector)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the CUDA card)")
    p.add_argument("--progressive", type=int, metavar="PASSES", default=0,
                   help="render in PASSES progressive passes, rewriting the "
                        "output PNG with the running mean after each one — "
                        "the headless stand-in for the reference viewport's "
                        "live in-progress view (viewport.cpp:354-366). The "
                        "final image draws exactly the same samples as a "
                        "single-pass render")
    p.add_argument("--serve", type=int, metavar="PORT", default=0,
                   help="serve a live auto-refreshing view of the render at "
                        "http://localhost:PORT while it runs — the headless "
                        "equivalent of the reference viewport's live "
                        "in-progress window (viewport.cpp:94-139, 344-391); "
                        "most useful with --progressive")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="checkpoint render state per chunk; re-running with "
                        "the same args resumes (killed renders lose nothing)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render "
                        "to DIR/render.trace.json")


def _render_progressive(args, pack, cam, cfg, photon_map, liveview=None):
    """K passes over the sample budget, rewriting the output PNG with the
    running mean after each. sample_offset keeps the union of the passes'
    RNG streams that of a single-pass render, so the final image is the
    single pass's (cli.py:82-154)."""
    from bhraytracer_tpu_torch.models.denoiser import denoise, load_pretrained
    from bhraytracer_tpu_torch.models.pathtracer import (
        image_to_u8,
        render_image,
        zbuffer_to_u8,
    )
    from bhraytracer_tpu_torch.utils.png import write_png

    passes = min(args.progressive, cfg.spp)
    m = cfg.spp // passes
    sizes = [m + (1 if j < cfg.spp % passes else 0) for j in range(passes)]
    accum = aux = None
    spp_done = 0
    t0 = time.time()
    for j, mj in enumerate(sizes):
        cfg_pass = dataclasses.replace(cfg, spp=mj, use_gamma=False,
                                       use_denoiser=False)
        img_j, aux_j = render_image(pack, cam, cfg_pass, seed=args.seed,
                                    photon_map=photon_map, return_aux=True,
                                    sample_offset=spp_done)
        img_j = img_j.cpu().numpy()
        if accum is None:
            accum = img_j * mj
            aux = aux_j
        else:
            accum += img_j * mj
            for k in aux["dropped_lanes"]:
                aux["dropped_lanes"][k] += aux_j["dropped_lanes"][k]
            aux["traced_segments"] += aux_j["traced_segments"]
            aux["sample_count"] = aux["sample_count"] + aux_j["sample_count"]
        spp_done += mj
        preview = accum / spp_done
        if cfg.use_gamma:
            preview = np.power(np.maximum(preview, 0.0), 1.0 / cfg.gamma)
        write_png(args.output, image_to_u8(preview))
        if liveview is not None:
            # Aux views (the viewport's 1-5 keys, viewport.cpp:419-485):
            # the z-buffer and sample-count PNGs, refreshed each pass.
            root, _ = os.path.splitext(args.output)
            zp, sp = root + ".z.png", root + ".samples.png"
            write_png(zp, zbuffer_to_u8(aux["zbuffer"]))
            sc = aux["sample_count"].astype(np.float32)
            sc8 = (sc / max(float(sc.max()), 1.0) * 255.0).astype(np.uint8)
            write_png(sp, sc8)
            liveview.register_aux("zbuffer", zp)
            liveview.register_aux("samples", sp)
            liveview.note_pass(j + 1, spp_done)
        print(f"pass {j + 1}/{passes}: {spp_done}/{cfg.spp} spp in "
              f"{time.time() - t0:.1f}s -> {args.output}")
    img = accum / cfg.spp
    if cfg.use_gamma:
        img = np.power(np.maximum(img, 0.0), 1.0 / cfg.gamma)
    if cfg.use_denoiser:
        model = load_pretrained(device=pack.device)
        aux_ch = None
        if model.aux_channels > 0:
            aux_ch = np.concatenate([aux["albedo"], aux["normal"]], -1)
        img = denoise(model, img, aux=aux_ch).cpu().numpy()
    return img, aux


def _device(args):
    """The card unless --cpu; None (with a message) where there is no card:
    the command line never falls back to the CPU."""
    import torch

    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("bhraytracer_tpu_torch: no CUDA device; pass --cpu to render "
              "on the CPU", file=sys.stderr)
        return None
    return torch.device("cuda")


def cmd_render(args) -> int:
    device = _device(args)
    if device is None:
        return 2
    import torch

    from bhraytracer_tpu_torch.config import RenderConfig
    from bhraytracer_tpu_torch.models.pathtracer import (
        image_to_u8,
        render_image,
        zbuffer_to_u8,
    )
    from bhraytracer_tpu_torch.scene.xml_loader import load_scene
    from bhraytracer_tpu_torch.utils.png import write_png

    pack, cam = load_scene(args.scene, resource_root=args.resource_root,
                           device=device)
    if args.width:
        cam.width = args.width
    if args.height:
        cam.height = args.height
    chunk_rays = args.chunk_rays or (
        CHUNK_CPU if device.type == "cpu" else CHUNK_CARD)
    cfg = RenderConfig(
        spp=args.spp,
        gi_bounces=args.gi_bounces,
        tir_bounces=args.tir_bounces,
        extra_refr_levels=args.extra_refr_levels,
        chunk_rays=chunk_rays,
        use_gamma=not args.no_gamma,
        texture_sample_count=args.texture_taps,
        use_photon_map=args.photon_map,
        photon_count=args.photon_count,
        adaptive_spp=args.adaptive,
        adaptive_fraction=args.adaptive_fraction,
    )

    photon_map = None
    if args.photon_map:
        from bhraytracer_tpu_torch.models.photonmap import build_photon_map

        t0 = time.time()
        photon_map = build_photon_map(pack, cfg, seed=args.seed, caustic=True)
        print(f"photon map: {int(photon_map.pos.shape[0])} photons "
              f"in {time.time() - t0:.1f}s")
        if args.save_photons:
            from bhraytracer_tpu_torch.io.photon_dat import write_dat

            write_dat(args.save_photons, *(x.cpu().numpy() for x in (
                photon_map.pos, photon_map.dirn, photon_map.power)))
            print(f"wrote {args.save_photons}")

    liveview = None
    if args.serve:
        from bhraytracer_tpu_torch.utils.liveview import LiveView

        liveview = LiveView(args.output, cfg.spp)
        port = liveview.serve(args.serve)
        print(f"live view: http://localhost:{port}/")

    def render():
        img, aux = render_image(pack, cam, cfg, seed=args.seed,
                                photon_map=photon_map, return_aux=True,
                                checkpoint_dir=args.checkpoint)
        return img.cpu().numpy(), aux

    t0 = time.time()
    if args.progressive and args.progressive > 1:
        if args.checkpoint:
            print("--progressive is incompatible with --checkpoint")
            return 2
        img, aux = _render_progressive(args, pack, cam, cfg, photon_map,
                                       liveview=liveview)
    elif args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            img, aux = render()
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "render.trace.json")
        prof.export_chrome_trace(trace)
        print(f"wrote {trace}")
    else:
        img, aux = render()
    dt = time.time() - t0
    # Render-time report, like the viewport's completion timer
    # (viewport.cpp:399-410), and the traced segments a second.
    print(f"rendered {cam.width}x{cam.height} @ {cfg.spp}spp in "
          f"{int(dt // 3600)}:{int(dt % 3600 // 60):02d}:{dt % 60:05.2f}")
    print(f"{aux['traced_segments'] / max(dt, 1e-9) / 1e6:.2f}M ray "
          "segments/s")
    dropped = aux.get("dropped_lanes", {})
    if any(dropped.values()):
        print(f"WARNING: dropped lanes (energy loss): {dropped}")
    write_png(args.output, image_to_u8(img))
    print(f"wrote {args.output}")
    if liveview is not None:
        liveview.note_pass(max(args.progressive, 1), cfg.spp)
        liveview.finish()
        # Keep the finished image viewable (the reference window stays open
        # after rendering, viewport.cpp:399-410), only with a human
        # attached; scripts and tests exit at once.
        if sys.stdin.isatty():
            try:
                input("live view still serving - press Enter to exit ")
            except EOFError:
                pass
        liveview.shutdown()
    if args.zbuffer:
        write_png(args.zbuffer, zbuffer_to_u8(aux["zbuffer"]))
        print(f"wrote {args.zbuffer}")
    if args.probe:
        x, y = args.probe
        c = img[y, x]
        z = aux["zbuffer"][y, x]
        print(f"pixel ({x}, {y}): color ({c[0]:.6f}, {c[1]:.6f}, {c[2]:.6f}) z {z:.6f}")
    return 0


def cmd_photonviz(args) -> int:
    from bhraytracer_tpu_torch.io.photon_dat import read_dat
    from bhraytracer_tpu_torch.utils.png import write_png

    pos, dirn, power = read_dat(args.dat)
    n = pos.shape[0]
    print(f"{n} photons")
    axes = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}[args.axis]
    a = pos[:, axes[0]]
    b = pos[:, axes[1]]
    lo_a, hi_a = np.percentile(a, [1, 99])
    lo_b, hi_b = np.percentile(b, [1, 99])
    res = args.size
    ia = np.clip(((a - lo_a) / max(hi_a - lo_a, 1e-9) * (res - 1)), 0, res - 1).astype(int)
    ib = np.clip(((b - lo_b) / max(hi_b - lo_b, 1e-9) * (res - 1)), 0, res - 1).astype(int)
    img = np.zeros((res, res, 3), np.float64)
    np.add.at(img, (res - 1 - ib, ia), power)
    if img.max() > 0:
        img = img / np.percentile(img[img > 0], 99)
    write_png(args.output, (np.clip(img, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.output}")
    return 0


def cmd_info(args) -> int:
    from bhraytracer_tpu_torch.scene.xml_loader import parse_scene_xml

    sd = parse_scene_xml(args.scene, resource_root=args.resource_root)
    info = {
        "nodes": [
            {"kind": n.kind, "name": n.name, "material": n.material}
            for n in sd.nodes
        ],
        "materials": [m.name for m in sd.materials],
        "lights": [
            {"kind": li.kind, "name": li.name, "gray": li.gray} for li in sd.lights
        ],
        "meshes": [
            {"name": m.name, "verts": int(m.verts.shape[0]), "faces": int(m.faces.shape[0])}
            for m in sd.meshes
        ],
        "textures": [t.name for t in sd.textures],
        "camera": {
            "width": sd.camera.width,
            "height": sd.camera.height,
            "fov": sd.camera.fov,
        },
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bhraytracer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene XML to PNG")
    _add_render_args(pr)

    pv = sub.add_parser("photonviz", help="visualize a photon .dat as PNG")
    pv.add_argument("dat")
    pv.add_argument("-o", "--output", default="photons.png")
    pv.add_argument("--axis", choices=["x", "y", "z"], default="z",
                    help="projection axis")
    pv.add_argument("--size", type=int, default=512)

    pi = sub.add_parser("info", help="print scene structure as JSON")
    pi.add_argument("scene")
    pi.add_argument("--resource-root", default=None)

    args = parser.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "photonviz":
        return cmd_photonviz(args)
    if args.cmd == "info":
        return cmd_info(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
