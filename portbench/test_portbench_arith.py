"""The benchmark's arithmetic on synthetic inputs: the whole-window rate,
the idle share's union of intervals, the roofline's byte counts and the
compared numbers."""

import numpy as np
import pytest

from portbench import checks, roofline, tracing
from portbench.loops.progressive import timed_window


class Clock:
    """A clock that advances by each unit's given duration."""

    def __init__(self, durations):
        self.t, self.durations, self.calls = 0.0, list(durations), 0

    def __call__(self):
        return self.t

    def unit(self, k):
        self.t += self.durations[k]
        return k


@pytest.mark.parametrize("durations,seconds,n,wall", [
    ([2.0] * 10, 5.0, 3, 6.0),          # whole units past the window's end
    ([2.0, 9.0, 2.0, 2.0], 10.0, 2, 11.0),  # a stalled unit counts in full
    ([2.0, 2.0, 7.0, 2.0], 12.0, 4, 13.0),
    ([0.5] * 40, 10.0, 20, 10.0),
])
def test_timed_window(durations, seconds, n, wall):
    clock = Clock(durations)
    out, walls, window = timed_window(clock.unit, seconds, clock=clock)
    assert out == list(range(n)) and window == pytest.approx(wall)
    assert sum(walls) == pytest.approx(window)
    pixels = 1920 * 1080
    # samples_per_s: all the samples over all the window's wall.
    assert n * pixels / window == pytest.approx(n * pixels / sum(durations[:n]))


@pytest.mark.parametrize("starts,ends,lo,hi,busy,gaps", [
    ([0, 1, 5, 6], [2, 3, 7, 6.5], 0, 10, 5.0, [(3, 5), (7, 10)]),
    ([2, 2, 2], [4, 3, 4], 0, 5, 2.0, [(0, 2), (4, 5)]),
    ([-1, 4], [1, 12], 0, 10, 7.0, [(1, 4)]),
    ([], [], 0, 3, 0.0, [(0, 3)]),
])
def test_union_length(starts, ends, lo, hi, busy, gaps):
    b, gs, ge = tracing.union_length(np.array(starts, float), np.array(ends, float), lo, hi)
    assert b == pytest.approx(busy)
    assert list(zip(gs.tolist(), ge.tolist())) == gaps


def test_roofline_bytes():
    # A tiny scene: one triangle, two spheres, one plane; 10 segments.
    assert roofline.scene_bytes(1, 2, 1) == 36 + 48 * 3
    assert roofline.trace_bytes(10, 1, 2, 1) == 40 * 10 + 36 + 144
    assert roofline.trace_bytes(10, 1, 2, 1, passes=2) == 400 + 2 * 180
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    b = roofline.bound(3.35e9, 67e12)
    assert b["bound_ms"] == pytest.approx(1000.0) and b["bound_by"] == "operations"


def test_image_gaps():
    ref = np.zeros((4, 5, 3))
    prog = ref.copy()
    prog[0, 0, 1] = 0.5
    prog[1, 1] = np.nan
    involved = np.zeros((4, 5), bool)
    involved[0, 0] = True
    g = checks.image_gaps(prog, ref, involved)
    assert g["bad_pixel_share"] == pytest.approx(2 / 20)
    assert g["bad_plain_share"] == pytest.approx(1 / 19)
    assert g["mean_abs_gap"] == pytest.approx((0.5 + 3.0) / 60)
    ok, chk = checks.judge([g], {"bad_pixel_share": 0.2, "mean_abs_gap": 0.01})
    assert not ok and chk["bad_pixel_share"]["value"] == g["bad_pixel_share"]


def test_refraction_z2():
    rng = np.random.default_rng(5)
    shape = (3, 16, 24, 3)
    truth = rng.uniform(0.2, 1.0, shape[1:])
    ref = [truth * rng.exponential(1.0, shape[1:]) for _ in range(shape[0])]
    prog = [x.copy() for x in ref]
    involved = [np.zeros(shape[1:3], bool) for _ in range(shape[0])]
    for m in involved:
        m[:8, :8] = True  # one tile of 8 filled, one (8:16) left out
        m[8:12, 8:16] = True
    # The same samples: 0. Samples from another draw (a moved slot): noise
    # of variance one at most, well under a systematic change.
    assert checks.refraction_z2(prog, ref, involved, 8) == (0.0, 2)
    moved = [truth * rng.exponential(1.0, shape[1:]) for _ in range(shape[0])]
    noise, tiles = checks.refraction_z2(moved, ref, involved, 8)
    assert tiles == 2 and noise < 3.0
    biased = [x * 1.5 for x in moved]
    assert checks.refraction_z2(biased, ref, involved, 8)[0] > 3.0 * max(noise, 1.0)
    # Only tiles half full or more count; none: 0 over no tiles.
    assert checks.refraction_z2(prog, ref, [m & False for m in involved], 8) == (0.0, 0)
    prog[1][0, 0, 0] = np.nan
    assert checks.refraction_z2(prog, ref, involved, 8)[0] == float("inf")
    # Pixels outside the refraction region are left out of the number.
    other = [x.copy() for x in ref]
    for x in other:
        x[:, 16:] += 5.0
    assert checks.refraction_z2(other, ref, involved, 8)[0] == 0.0


def test_train_gaps():
    rg = {"mtl_diffuse": np.array([3.0, 4.0, 1e-6]), "b": np.array([1e-9]),
          "cam_pos": np.array([1.0]), "cam_dir": np.array([2.0]), "cam_up": np.array([1.0])}
    pg = {"mtl_diffuse": np.array([3.0, 4.5, 0.0]), "b": np.array([2e-9]),
          "cam_pos": np.array([1.5]), "cam_dir": np.array([2.0]), "cam_up": np.array([1.1])}
    g, info = checks.train_gaps([1.0, 0.5], [1.0, 0.4], pg, rg,
                                np.array([0.1, -0.1, 0.1]), np.array([0.1, -0.05, -0.1]), 0.05)
    assert g["loss_gap"] == pytest.approx(0.25)
    # Scene leaves: mtl_diffuse |sqrt(29.25) - 5| / 5 and b ~1e-9 (against
    # the median leaf's norm, 1); the worst is mtl_diffuse's.
    assert g["grad_gap_scene"] == pytest.approx((np.sqrt(29.25) - 5.0) / 5.0)
    # Camera leaves 0.5, 0 and 0.1: their median.
    assert g["grad_gap_camera"] == pytest.approx(0.1)
    assert info["grad_gap_worst"] == ["cam_pos", pytest.approx(0.5)]
    # The third element's reference gradient is under 1e-3 of the median
    # element's: it moves by round-off alone and is left out.
    assert g["change_gap"] == pytest.approx(0.05 / 0.05)
    assert info["change_elements_left_out"] == 1
    bad, _ = checks.train_gaps([float("nan")], [1.0], pg, rg, np.zeros(3), np.zeros(3), 0.05)
    assert bad["loss_gap"] == float("inf")
