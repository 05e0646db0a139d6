"""The control of each cell's output check: the plain reference in
bfloat16 put in the program's place (and, for the render cell, the glass
at the wrong index of refraction; for the inverse-rendering loop, the
loss over half of the lanes) is judged not correct, here at a size a test
run holds: by the render cell's own limits, and by the limits that sound
CPU runs keep for the inverse-rendering loop, which has no cell yet. The
chip readings at the cells' own sizes are in PERF.md (python3
portbench/control.py)."""

import pytest
import torch

from portbench import checks, control, harness
from portbench.test_portbench_faults import INVERSE_LIMITS


def cell_files(cell):
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    c, _, _ = harness.cell_spec(bench, cell)
    return (harness.load_json(harness.HERE, "configs", c["config"] + ".json"),
            harness.load_json(harness.HERE, "traffic", c["traffic"] + ".json"),
            harness.load_json(harness.HERE, "limits", c["name"] + ".json"))


def test_render_control_fails():
    cfg, traffic, limits = cell_files("cornell_glass.render_2160p")
    traffic = dict(traffic, width=64, height=36, check_passes=2, refr_tile=4)
    g = control.control_gaps(cfg, traffic, 2 ** 31 + 3, 3, torch.device("cpu"))
    ok, chk = checks.judge(g, limits)
    assert not ok, chk


def test_ior_fault_leaves_plain_pixels_equal():
    """control.py's refraction fault (the glass at 1.40) changes the
    refraction pixels alone: the other pixels read equal. At this size its
    refraction number stays small; at the cell's it reads above 11 (PERF.md)."""
    cfg, traffic, limits = cell_files("cornell_glass.render_2160p")
    traffic = dict(traffic, width=64, height=36, check_passes=1, refr_tile=4)
    g = control.control_gaps(cfg, traffic, 2 ** 31 + 3, 3, torch.device("cpu"), fault="ior")
    _, chk = checks.judge(g, limits)
    assert chk["bad_plain_share"]["value"] == 0.0 and chk["bad_pixel_share"]["value"] > 0.0


@pytest.mark.parametrize("fault", [None, "half"])
def test_inverse_control_fails(fault):
    cfg = harness.load_json(harness.HERE, "configs", "cornell_glass.json")
    traffic = dict(harness.load_json(harness.HERE, "traffic", "inverse_1024.json"),
                   width=32, height=32)
    g = control.control_train(cfg, traffic, 2 ** 31 + 5, torch.device("cpu"), fault=fault)
    ok, _ = checks.judge([g], INVERSE_LIMITS)
    assert not ok, g
