"""The plain reference against the program's CPU path at small sizes:
a render cell's pass image and segment count, an inverse-rendering cell's
losses, gradients and change; and the reference's cluster cull against
its own brute force."""

import os
import time

import numpy as np
import pytest
import torch

from portbench import checks, harness, program
from portbench.loops import inverse
from portbench.reference import intersect, render, scene

SIZES = {"cornell_glass": (64, 36)}


def config(name):
    return harness.load_json(harness.HERE, "configs", name + ".json")


@pytest.mark.parametrize("name", sorted(SIZES))
def test_cull_equals_brute_force(name):
    sc = scene.build_scene(config(name), harness.ROOT, "cpu")
    tr = intersect.Tracer(sc)
    g = torch.Generator().manual_seed(3)
    lo, hi = tr.mesh.root_lo, tr.mesh.root_hi
    o = lo - 1.0 + (hi - lo + 2.0) * torch.rand((512, 3), generator=g)
    target = lo + (hi - lo) * torch.rand((512, 3), generator=g)
    d = target - o
    t, f = tr.mesh.closest(o, d, "both", torch.full((512,), intersect.BIG))
    faces = torch.arange(sc.faces.shape[0])
    bt = torch.full((512,), intersect.BIG)
    bf = torch.full((512,), -1, dtype=torch.int64)
    for s in range(0, faces.numel(), 4096):
        fs = faces[s:s + 4096].expand(512, -1)
        tt, _, ok = tr.mesh.face_test(fs, o, d, "both")
        tc = torch.where(ok, tt, intersect.BIG)
        m, i = tc.min(1)
        upd = m < bt
        bt, bf = torch.where(upd, m, bt), torch.where(upd, fs[torch.arange(512), i], bf)
    assert torch.equal(t, bt) and torch.equal(f, torch.where(bt < intersect.BIG, bf, -1))
    assert (f >= 0).sum() > 100
    tmax = torch.rand(512, generator=g) * 2.0
    occ = tr.mesh.anyhit(o, d, tmax)
    tt, _, ok = tr.mesh.face_test(faces.expand(512, -1), o, d, "front")
    brute = (ok & (tt > intersect.MESH_BIAS) & (tt < tmax[:, None])).any(1)
    assert torch.equal(occ, brute)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_reference_matches_program_pass(name):
    from bhraytracer_tpu_torch.models.pathtracer import render_image

    w, h = SIZES[name]
    cfg = config(name)
    pack, cam = program.compile_scene(cfg, harness.ROOT, "cpu")
    cam.width, cam.height = w, h
    rcfg = program.render_config(cfg, spp=1, use_gamma=False, chunk_rays=w * h,
                                 texture_sample_count=1)
    img, aux = render_image(pack, cam, rcfg, seed=2 ** 31 + 7, return_aux=True, sample_offset=3)
    r = render.Renderer(scene.build_scene(cfg, harness.ROOT, "cpu"), w, h)
    ref, st = r.render_pass(2 ** 31 + 7, 3, render.Settings(**cfg["render"]))
    gaps = checks.image_gaps(img.numpy(), ref.numpy(), st["involved"].numpy())
    assert st["segs"] == aux["traced_segments"]
    assert gaps["bad_pixel_share"] <= 2e-3 and gaps["mean_abs_gap"] <= 1e-5, gaps


def test_reference_matches_program_steps():
    cfg = config("cornell_glass")
    traffic = dict(harness.load_json(harness.HERE, "traffic", "inverse_1024.json"),
                   width=24, height=24)
    t0 = time.perf_counter()
    run = inverse.Run(root=harness.ROOT, config=cfg, traffic=traffic,
                      limits={"loss_gap": 1e-3, "grad_gap_scene": 1e-3, "grad_gap_camera": 1e-3,
                              "change_gap": 1e-3},
                      seed=2 ** 31 + 11, seconds=0.1, trace=False,
                      setup_clock=lambda: time.perf_counter() - t0, device="cpu")
    res = run.go()
    assert res.correct, res.checks
    norms = res.notes["grad_norms"]
    assert all(np.isfinite(v).all() and v[1] > 0 for v in norms.values()), norms
    assert os.path.exists(os.path.join(harness.ROOT, "BENCHMARK.json"))
