"""The comparisons that decide `correct`.

Progressive passes: the images of `check_passes` passes of the program
against the plain reference's images of the same passes:

  - `bad_pixel_share`: the share of a pass's pixels whose largest channel
    differs from the reference's by more than PIXEL_TOL;
  - `bad_plain_share`: the same share among the pixels with no refraction
    candidate anywhere in their tree (by the reference's render). Only
    refraction children are compacted, so only those pixels' samples
    depend on other pixels: one discrete decision that the program and the
    reference round differently (a silhouette, a total internal
    reflection) moves the slots, and so the samples, of every later
    refraction child of its level. The other pixels draw their samples by
    their own index alone and have to agree to rounding;
  - `refr_tile_z2` (`refraction_z2`): the refraction pixels, held to the
    reference by their expected values. The image is cut into square
    tiles (the traffic's `refr_tile` pixels a side); a tile counts where
    refraction pixels fill at least half of it over the checked passes.
    Per tile and channel, z is the gap between the program's and the
    reference's sums over its refraction pixels, over the square root of
    the two sides' summed squared deviations from their tile means.
    Where the samples of a pixel moved to another slot, both sides are
    unbiased estimates of one value and z is noise of variance one at
    most; a wrong index of refraction, Fresnel weight or absorption moves
    the expected values and z with them. The number is the mean of z
    squared over the tiles and channels;
  - `mean_abs_gap`: the mean absolute difference over pixels and channels,
    printed for the record and not compared (the numbers above part sound
    runs from the control more widely; PERF.md).

Inverse-rendering steps: the program's first steps against the
reference's from the same inputs (`train_gaps`). A leaf's gradient gap is
the gap between the norms of the program's and the reference's first
gradient of that leaf, over the larger of the reference's norm of that
leaf and of the median leaf:

  - `loss_gap`: the largest |loss - reference loss| / reference loss over
    the steps;
  - `grad_gap_scene`: the worst leaf's gradient gap among the scene's
    leaves (materials, lights, vertices);
  - `grad_gap_camera`: the median of the camera leaves' gradient gaps
    (cam_pos, cam_dir, cam_up): under the hit-frozen estimator their
    gradients rest on a few grazing pixels whose hits flip with rounding,
    so the worst of them swings by itself (PERF.md); the worst is printed;
  - `change_gap`: the largest gap, element by element, between the
    program's and the reference's change of the diffuse table over the
    steps, over the learning rate; elements whose reference gradient is
    under a thousandth of the table's median element's are left out (they
    move by round-off alone).

Each is held to its limit in portbench/limits/<cell>.json (where and how
each limit was set: PERF.md). A run is correct where no number read in it
exceeds its limit.
"""

from __future__ import annotations

import numpy as np

PIXEL_TOL = 1e-3
TILE_FILL = 0.5  # the share of a tile's pixel samples that have to be refraction pixels
CAMERA_LEAVES = ("cam_pos", "cam_dir", "cam_up")


def image_gaps(prog: np.ndarray, ref: np.ndarray, involved: np.ndarray) -> dict:
    """The per-pass numbers of one (H, W, 3) image against the
    reference's; `involved` (H, W) marks the pixels whose tree has a
    refraction candidate. A non-finite value in either counts as a bad
    pixel and as a gap of 1."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        return {"bad_pixel_share": 1.0, "bad_plain_share": 1.0, "mean_abs_gap": 1.0}
    gap = np.abs(prog - ref)
    gap = np.where(np.isfinite(gap), gap, 1.0)
    bad = gap.max(-1) > PIXEL_TOL
    plain = ~np.asarray(involved, bool)
    return {"bad_pixel_share": float(bad.mean()),
            "bad_plain_share": float(bad[plain].mean()) if plain.any() else 0.0,
            "mean_abs_gap": float(gap.mean())}


def _tiles(x: np.ndarray, tile: int) -> np.ndarray:
    """(P, H, W, ...) -> (tiles, P * tile * tile, ...), whole tiles only."""
    p, h, w = x.shape[:3]
    ht, wt = h // tile, w // tile
    x = x[:, :ht * tile, :wt * tile].reshape(p, ht, tile, wt, tile, *x.shape[3:])
    x = np.moveaxis(x, 0, 2)  # (ht, tile, P, wt, tile, ...)
    x = np.moveaxis(x, 3, 1)  # (ht, wt, tile, P, tile, ...)
    return x.reshape(ht * wt, tile * p * tile, *x.shape[5:])


def refraction_z2(progs, refs, involveds, tile: int, fill: float = TILE_FILL):
    """(refr_tile_z2, the number of tiles it was taken over) of passes'
    (H, W, 3) images against the reference's, `involveds` (H, W) each, in
    tiles of `tile` pixels a side (the traffic's `refr_tile`; see the
    module's docstring). No tile: (0.0, 0). A non-finite value of the
    program reads infinite."""
    a = np.stack([np.asarray(x, np.float64) for x in progs])
    b = np.stack([np.asarray(x, np.float64) for x in refs])
    if a.shape != b.shape:
        return float("inf"), 0
    m = _tiles(np.stack([np.asarray(x, bool) for x in involveds]), tile)
    a, b = _tiles(a, tile), _tiles(b, tile)
    n = m.sum(1)
    keep = n >= fill * m.shape[1]
    if not keep.any():
        return 0.0, 0
    m, a, b, n = m[keep][..., None], a[keep], b[keep], n[keep][:, None]
    if not np.isfinite(np.where(m, a, 0.0)).all():
        return float("inf"), int(keep.sum())
    sa, sb = np.where(m, a, 0.0).sum(1), np.where(m, b, 0.0).sum(1)
    va = np.where(m, (a - (sa / n)[:, None]) ** 2, 0.0).sum(1)
    vb = np.where(m, (b - (sb / n)[:, None]) ** 2, 0.0).sum(1)
    z2 = (sa - sb) ** 2 / np.maximum(va + vb, 1e-30)
    return float(z2.mean()), int(keep.sum())


def judge(gaps: list, limits: dict):
    """(correct, {name: {value, limit}}) over the checked passes or steps:
    each number's largest reading against its limit."""
    checks = {}
    ok = bool(gaps)
    for name, limit in limits.items():
        vals = [g[name] for g in gaps if name in g]
        value = max(vals) if vals else float("inf")
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks


def _norm(x) -> float:
    return float(np.sqrt(np.sum(np.asarray(x, np.float64) ** 2)))


def train_gaps(losses, ref_losses, grads, ref_grads, change, ref_change, lr: float):
    """(the compared numbers, what they came from) of the program's first
    steps against the reference's: losses (floats a step), first gradients
    ({leaf: array}) and the diffuse table's change over the steps (arrays).
    A number that is not finite on either side reads infinite."""
    inf = float("inf")

    def gap(a, b, scale):
        g = abs(a - b) / max(scale, 1e-30)
        return g if np.isfinite(g) else inf

    loss_gap = max(gap(a, b, abs(b)) for a, b in zip(losses, ref_losses))
    gn = {k: _norm(grads[k]) for k in ref_grads}
    rn = {k: _norm(ref_grads[k]) for k in ref_grads}
    finite = [v for v in rn.values() if np.isfinite(v)]
    med = float(np.median(finite)) if finite else inf
    leaf_gaps = {k: gap(gn[k], rn[k], max(rn[k], med)) for k in rn}
    scene = {k: v for k, v in leaf_gaps.items() if k not in CAMERA_LEAVES}
    camera = [leaf_gaps[k] for k in CAMERA_LEAVES if k in leaf_gaps]

    g_ref = np.abs(np.asarray(ref_grads["mtl_diffuse"], np.float64)).reshape(-1)
    moved = g_ref >= 1e-3 * np.median(g_ref)
    d = (np.asarray(change, np.float64) - np.asarray(ref_change, np.float64)).reshape(-1)
    d = np.where(np.isfinite(d), np.abs(d), inf)
    change_gap = float(d[moved].max()) / lr if moved.any() else 0.0

    gaps = {"loss_gap": float(loss_gap),
            "grad_gap_scene": float(max(scene.values())) if scene else 0.0,
            "grad_gap_camera": float(np.median(camera)) if camera else 0.0,
            "change_gap": change_gap}
    worst = max(leaf_gaps, key=leaf_gaps.get)
    return gaps, {"grad_norms": {k: [gn[k], rn[k]] for k in rn},
                  "grad_gap_leaves": leaf_gaps,
                  "grad_gap_worst": [worst, leaf_gaps[worst]],
                  "change_elements_left_out": int((~moved).sum())}
