"""A whole run of each cell on the CPU, the harness's look for a card
skipped, with the timed path broken underneath: the output check has to
judge it not correct. Faults of a render cell: a pass that returns the
previous pass's image (its state unchanged), half of the image left out,
an image altered where it is produced, and a fault of the refraction
chain alone: the program renders the glass with the wrong index of
refraction. Faults of an inverse-rendering cell: a step that leaves the
table unchanged, and a loss whose mean is taken over half of the lanes
only. (One card: no exchange between chips to leave out.) A render cell's limits are the cell's own,
portbench/limits/. The inverse-rendering loop has no cell yet (PERF.md,
Open questions): it runs here with the limits that sound runs of the
program's CPU path keep at this size (test_portbench_reference.py)."""

import contextlib
import io
import json
import time

import pytest

from portbench import harness
from portbench.loops import inverse

SIZES = {"progressive": (40, 30)}
SIZES_INVERSE = {"width": 24, "height": 24}
RENDER = "cornell_glass.render_2160p"
INVERSE_LIMITS = {"loss_gap": 1e-3, "grad_gap_scene": 1e-3, "grad_gap_camera": 1e-3,
                  "change_gap": 1e-3}


def run_cell(monkeypatch, cell: str, seed: int = 2 ** 31 + 21, seconds: float = 0.1,
             **traffic) -> dict:
    monkeypatch.setattr(harness, "cards", lambda: 1)
    monkeypatch.setattr(harness, "device_name", lambda: "cpu")
    orig = harness.load_json

    def small(*parts):
        d = orig(*parts)
        if parts[-2:-1] == ("traffic",):
            w, h = SIZES[d["kind"]]
            d = dict(d, **dict(dict(width=w, height=h, check_passes=2, refr_tile=4), **traffic))
        return d

    monkeypatch.setattr(harness, "load_json", small)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", "0"], 0.0, device="cpu")
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def break_render(monkeypatch, fault: str):
    from bhraytracer_tpu_torch.models import pathtracer

    orig = pathtracer.render_image
    first = []

    def broken(*a, **kw):
        img, aux = orig(*a, **kw)
        if fault == "unchanged":
            if not first or kw["sample_offset"] >= (1 << 30):
                first[:] = [img]
            return first[0].clone(), aux
        if fault == "half":
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0
        elif fault == "altered":
            img = img * 1.05 + 0.01
        return img, aux

    monkeypatch.setattr(pathtracer, "render_image", broken)


def break_inverse(monkeypatch, fault: str):
    import torch

    from bhraytracer_tpu_torch.parallel import sharding

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
        return
    orig = sharding.loss_and_grads

    def half(params, pack, cfg, cam, width, height, px, py, target, key, **kw):
        n = px.shape[0] // 2
        return orig(params, pack, cfg, cam, width, height, px[:n], py[:n], target[:n], key, **kw)

    monkeypatch.setattr(sharding, "loss_and_grads", half)


def run_inverse(seed: int = 2 ** 31 + 23):
    """The inverse-rendering loop on the CPU at 24x24 (configuration
    cornell_glass, traffic inverse_1024): its Result."""
    cfg = harness.load_json(harness.HERE, "configs", "cornell_glass.json")
    traffic = dict(harness.load_json(harness.HERE, "traffic", "inverse_1024.json"),
                   **SIZES_INVERSE)
    t0 = time.perf_counter()
    return inverse.Run(root=harness.ROOT, config=cfg, traffic=traffic, limits=INVERSE_LIMITS,
                       seed=seed, seconds=0.1, trace=False,
                       setup_clock=lambda: time.perf_counter() - t0, device="cpu").go()


def test_sound_run_is_correct(monkeypatch):
    out = run_cell(monkeypatch, RENDER)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out)[-1] == "checks"


def test_sound_inverse_run_is_correct():
    res = run_inverse()
    assert res.correct and res.failed == 0, res.checks


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_render_fault_is_not_correct(monkeypatch, fault):
    break_render(monkeypatch, fault)
    out = run_cell(monkeypatch, RENDER)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_inverse_fault_is_not_correct(monkeypatch, fault):
    break_inverse(monkeypatch, fault)
    res = run_inverse()
    assert not res.correct, (fault, res.checks)


def test_refraction_fault_is_not_correct(monkeypatch):
    """The program's scene with the glass at index of refraction 1.0 (the
    reference keeps the configuration's 1.52): every pixel without glass
    in its tree is unchanged, so only the refraction pixels' number can
    catch it. 384x216 passes, tiles of 8 pixels (a tile at 2160p is 64:
    the same share of the frame's height, about). On the chip, at the
    cell's own size, the fault of 1.40 is read by portbench/control.py
    --fault ior (PERF.md)."""
    from portbench import control, program

    orig = program.compile_scene
    monkeypatch.setattr(program, "compile_scene",
                        lambda cfg, root, dev: orig(control.faulty_ior(cfg, 1.0), root, dev))
    out = run_cell(monkeypatch, RENDER, seconds=1.0, width=384, height=216, refr_tile=8)
    assert not out["correct"], out["checks"]
    assert out["checks"]["bad_plain_share"]["value"] <= out["checks"]["bad_plain_share"]["limit"]
