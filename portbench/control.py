"""The control of a cell's output check: the plain reference in
bfloat16 put in the program's place, compared with the reference in
float32 by the cell's own numbers (portbench/checks.py). The check has to
judge it not correct; with the faults below, its readings are the upper
ends each limit was set below (PERF.md).

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--fault half]

prints one JSON line a seed. A render cell: the passes the harness would
check for that seed among `--passes` completed passes, rendered in
bfloat16; with `--fault ior`, instead, in float32 with the glass's index
of refraction at 1.40 (a fault of the refraction chain alone). An
inverse-rendering cell: the reference's first steps in bfloat16; with
`--fault half`, instead, in float32 with the loss's mean taken over the
first half of the lanes only (half of the batch left out).
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import checks, harness  # noqa: E402

FAULT_IOR = 1.40  # the glass's index of refraction in the "ior" fault (the scene's: 1.52)


def faulty_ior(config: dict, ior: float = FAULT_IOR) -> dict:
    """The configuration with every refracting material's index of
    refraction set to `ior`."""
    mats = [dict(m, ior=ior) if max(m["refraction"]) > 0 else m for m in config["materials"]]
    return dict(config, materials=mats)


def control_gaps(config: dict, traffic: dict, seed: int, n_passes: int, device,
                 fault=None) -> list:
    """The numbers (checks.judge's list) of the reference computed in
    bfloat16 (or, with fault "ior", in float32 with the glass's index of
    refraction at FAULT_IOR) against the reference in float32, on the
    passes the harness checks for `seed` among `n_passes`."""
    import torch

    from portbench.reference import render as ref_render
    from portbench.reference import scene as ref_scene

    picks = np.random.default_rng(seed).choice(
        n_passes, size=min(traffic["check_passes"], n_passes), replace=False)
    settings = ref_render.Settings(**config["render"])
    sides = {"ref": (config, torch.float32),
             "ctl": (faulty_ior(config), torch.float32) if fault == "ior"
             else (config, torch.bfloat16)}
    r = {name: ref_render.Renderer(ref_scene.build_scene(cfg, harness.ROOT, device, dtype=dt),
                                   traffic["width"], traffic["height"])
         for name, (cfg, dt) in sides.items()}
    gaps, ctl, ref, masks = [], [], [], []
    for k in sorted(int(x) for x in picks):
        with torch.no_grad():
            img, st = r["ref"].render_pass(seed, k, settings)
            cimg, _ = r["ctl"].render_pass(seed, k, settings)
        ref.append(img.float().cpu().numpy())
        ctl.append(cimg.float().cpu().numpy())
        masks.append(st["involved"].cpu().numpy())
        gaps.append(dict(checks.image_gaps(ctl[-1], ref[-1], masks[-1]), pass_index=k,
                         involved_share=float(masks[-1].mean())))
    z2, tiles = checks.refraction_z2(ctl, ref, masks, traffic["refr_tile"])
    gaps.append({"refr_tile_z2": z2, "refr_tiles": tiles})
    return gaps


def control_train(config: dict, traffic: dict, seed: int, device, fault=None) -> dict:
    """The numbers of the reference's first steps in bfloat16 (or, with
    fault "half", in float32 over half of the lanes) against the
    reference's in float32."""
    import torch

    from portbench.loops.inverse import perturbed_diffuse
    from portbench.reference import render as ref_render
    from portbench.reference import scene as ref_scene
    from portbench.reference import train as ref_train

    settings = ref_render.Settings(**{k: traffic["render"][k] for k in (
        "gi_bounces", "extra_refr_levels", "tir_bounces", "refr_capacity")})
    d0 = perturbed_diffuse(config, traffic, seed)
    w, h = traffic["width"], traffic["height"]
    steps = traffic["first_steps"]
    runs = {}
    for name, dt, lanes in (("ref", torch.float32, None),
                            ("ctl", torch.float32 if fault == "half" else torch.bfloat16,
                             slice(0, w * h // 2) if fault == "half" else None)):
        scene = ref_scene.build_scene(config, harness.ROOT, device, dtype=dt)
        losses, first, d = ref_train.follow(scene, w, h, seed, torch.from_numpy(d0).to(device, dt),
                                            traffic, settings, steps, lanes=lanes)
        runs[name] = (losses, {k: g.float().cpu() for k, g in first.items()},
                      d.float().cpu().numpy() - d0)
        del scene
    (pl, pg, pc), (rl, rg, rc) = runs["ctl"], runs["ref"]
    gaps, info = checks.train_gaps(pl, rl, pg, rg, pc, rc, traffic["lr"])
    return dict(gaps, seed=seed, fault=fault or "bfloat16", losses=[pl, rl],
                grad_gap_leaves=info["grad_gap_leaves"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--fault", choices=("half", "ior"), default=None)
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell, _, _ = harness.cell_spec(bench, args.workload)
    config = harness.load_json(harness.HERE, "configs", cell["config"] + ".json")
    traffic = harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json")
    limits = harness.load_json(harness.HERE, "limits", cell["name"] + ".json")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        if traffic["kind"] == "inverse":
            g = control_train(config, traffic, seed, dev, fault=args.fault)
            ok, chk = checks.judge([g], limits)
        else:
            passes = control_gaps(config, traffic, seed, args.passes, dev, fault=args.fault)
            ok, chk = checks.judge(passes, limits)
            g = dict({k: v["value"] for k, v in chk.items()}, seed=seed,
                     fault=args.fault or "bfloat16", passes=passes)
        print(json.dumps(dict(g, judged_correct=ok, workload=cell["name"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
