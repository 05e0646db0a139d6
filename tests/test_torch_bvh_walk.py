"""Kernels 4 and 5's tree walk (csrc/bvh.cu) on the CPU: the sibling-pair
node table (scene/pack.py:pair_table) and the walk's plain PyTorch twin
(ops/bvh.py:bvh_walk_ref). Torch and numpy only.

  - The pair table of the bench pack: every face in exactly one leaf, each
    row the binary node it came from (its box, its entry code, its box's
    magnitude), every inner node's children one aligned pair (starting at
    an even row), the same table from compile_scene and from
    pack_from_numpy.
  - The walk (the root's box, then both children of a node from its pair,
    the nearer first, a popped entry beyond the ray's best t dropped)
    against the brute-force twins bvh_closest_ref / bvh_anyhit_ref, on 2048
    seeded rays over the bench scene and on rays along the edges of a
    cube's flat leaf boxes (every leaf box of the cube is flat: its faces
    lie in one side of the cube).
  - A mutant: the same walk with the box widening removed and every box
    one ulp tighter must lose hits on the cube's flat boxes, which shows
    the comparison can fail.

Tolerance: none. The walk tests each face the kernels' way, in the
brute-force twin's arithmetic (ops/bvh.py:_tri_cols), ties go to the lowest
face at equal t whatever the visit order, and the widened boxes drop no
face a ray can hit, so t, key and occlusion are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from bhraytracer_tpu_torch import scenes
from bhraytracer_tpu_torch.accel.bvh import build_bvh
from bhraytracer_tpu_torch.ops import bvh as B
from bhraytracer_tpu_torch.ops import cull
from bhraytracer_tpu_torch.ops.linalg import BIG
from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables
from bhraytracer_tpu_torch.scene.pack import (
    _DATA,
    _META,
    bvh_tables,
    pack_from_numpy,
    pair_table,
)
from tests._torch_parity import seeded_rays

torch.set_num_threads(2)

N = 2048


@pytest.fixture(scope="module")
def bench():
    return scenes.bench_scene(device="cpu")[0]


def _cube(n=4):
    """(pairs, faces) of a BVH over the unit cube's surface, each side cut
    into n x n quads of two outward-facing triangles."""
    g = np.linspace(0.0, 1.0, n + 1)
    tris = []
    for ax in range(3):
        u, w = (ax + 1) % 3, (ax + 2) % 3
        for side in (0.0, 1.0):
            for i in range(n):
                for j in range(n):
                    q = []
                    for a, b in ((i, j), (i + 1, j), (i + 1, j + 1),
                                 (i, j + 1)):
                        p = np.zeros(3)
                        p[ax], p[u], p[w] = side, g[a], g[b]
                        q.append(p)
                    t1, t2 = (q[0], q[1], q[2]), (q[0], q[2], q[3])
                    if side == 0.0:
                        t1, t2 = t1[::-1], t2[::-1]
                    tris += [t1, t2]
    v = np.array(tris, np.float32)  # (F, 3, 3)
    bvh = build_bvh(v.reshape(-1, 3), np.arange(3 * len(tris),
                                                dtype=np.int32).reshape(-1, 3))
    v = v[bvh.face_order]
    tree = (bvh.bmin, bvh.bmax, bvh.left, bvh.count)
    pairs, faces = bvh_tables(*tree, v[:, 0], v[:, 1], v[:, 2])
    return torch.from_numpy(pairs), torch.from_numpy(faces)


def _edge_rays():
    """Rays on the leaf boxes' edges: axis-aligned through grid lines and
    along the cube's sides, aimed at shared edges and corners, from grid
    vertices on the surface."""
    o, d = [], []
    for x in (0.0, 0.25, 0.5, 1.0):
        for y in (0.25, 0.5, 0.3):
            o.append((x, y, -1.0)), d.append((0.0, 0.0, 1.0))
            o.append((x, y, 2.0)), d.append((0.0, 0.0, -1.0))
    for y, z in ((0.3, 0.0), (0.5, 0.5), (0.0, 0.0), (1.0, 0.25),
                 (0.25, 1.0)):
        o.append((-1.0, y, z)), d.append((1.0, 0.0, 0.0))
    for tx, ty in ((0.5, 0.3), (0.25, 0.75), (0.5, 0.5)):
        o.append((tx - 0.5, ty - 1.0, -2.0)), d.append((0.25, 0.5, 1.0))
    for p in ((0.25, 0.25, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
              (0.5, 0.5, 1.0), (0.5, 0.5, 0.5)):
        for dd in ((0.0, 0.0, 1.0), (1.0, 1.0, 1.0), (-1.0, -1.0, -1.0),
                   (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0)):
            o.append(p), d.append(dd)
    return (torch.tensor(x, dtype=torch.float32) for x in (o, d))


def _t_init(kind, n, seed):
    if kind == "big":
        return torch.full((n,), BIG)
    t = np.random.default_rng(seed).uniform(2.0, 12.0, n).astype(np.float32)
    t[::3] = BIG
    return torch.from_numpy(t)


def _case(name, bench):
    """(pairs, faces, sph, pln, o, d) of the bench scene's seeded rays or
    the cube's edge rays (no analytic instances)."""
    if name == "bench":
        sph, pln = analytic_tables(bench)
        o, d = (torch.from_numpy(x) for x in seeded_rays(N, 31))
        return bench.bvh_pairs, bench.bvh_faces, sph, pln, o, d
    pairs, faces = _cube()
    o, d = _edge_rays()
    empty = torch.zeros((0, 12))
    return pairs, faces, empty, empty, o, d


def test_pair_table_invariants(bench):
    pairs = bench.bvh_pairs.numpy()
    bmin, bmax = bench.bvh_bmin.numpy(), bench.bvh_bmax.numpy()
    left, count = bench.bvh_left.numpy(), bench.bvh_count.numpy()
    n_nodes, n_faces = left.shape[0], bench.wtri_v0.shape[0]
    assert pairs.shape == (n_nodes + 1, 8) and pairs.dtype == np.float32
    # Row r + 1 is node r: its box, its entry code (int32 bits: `left`, or
    # the leaf's faces) and its widening scale; row 0 an empty box.
    np.testing.assert_array_equal(pairs[1:, 0:3], bmin)
    np.testing.assert_array_equal(pairs[1:, 3:6], bmax)
    code = np.ascontiguousarray(pairs[1:, 6]).view(np.int32)
    np.testing.assert_array_equal(
        code, np.where(count == 0, left,
                       B.leaf_code(left.astype(np.int64),
                                   count.astype(np.int64))))
    box = np.abs(np.concatenate([bmin, bmax], 1))
    np.testing.assert_array_equal(pairs[1:, 7], box.max(1))
    assert (pairs[0, 0:3] > pairs[0, 3:6]).all()
    # Every inner node's children fill one aligned pair: rows left + 1
    # (even) and left + 2.
    inner = count == 0
    assert inner.sum() == n_nodes // 2
    assert ((left[inner] + 1) % 2 == 0).all()
    # From the root, every node is reached once, and the leaves cover every
    # face exactly once.
    seen = np.zeros(n_nodes, np.int64)
    covered = np.zeros(n_faces, np.int64)
    todo = [0]
    while todo:
        r = todo.pop()
        seen[r] += 1
        if count[r]:
            covered[left[r]:left[r] + count[r]] += 1
        else:
            todo += [left[r], left[r] + 1]
    assert (seen == 1).all() and (covered == 1).all()


def test_pair_table_same_from_both_builders(bench):
    arrays = {k: getattr(bench, k).numpy() for k in _DATA}
    arrays.update({k: getattr(bench, k) for k in _META})
    carried = pack_from_numpy(arrays, device="cpu")
    for k in ("bvh_pairs", "bvh_faces"):
        np.testing.assert_array_equal(getattr(carried, k).numpy(),
                                      getattr(bench, k).numpy(), err_msg=k)


def test_pair_table_refuses_other_layouts(bench):
    tree = [getattr(bench, k).numpy() for k in ("bvh_bmin", "bvh_bmax",
                                                "bvh_left", "bvh_count")]
    bad = tree[2].copy()
    bad[0] += 1  # the root's children at an even `left`
    with pytest.raises(ValueError):
        pair_table(tree[0], tree[1], bad, tree[3])
    big = tree[3].copy()
    big[big > 0] = B.LEAF_FACES
    with pytest.raises(ValueError):
        pair_table(tree[0], tree[1], tree[2], big)


@pytest.mark.parametrize("scene,side,tinit", [
    ("bench", "front", "big"), ("bench", "both", "random"),
    ("bench", "front", "random"), ("bench", "both", "big"),
    ("cube", "both", "big"), ("cube", "front", "random")])
def test_walk_closest_equals_brute_force(bench, scene, side, tinit):
    pairs, faces, sph, pln, o, d = _case(scene, bench)
    t_init = _t_init(tinit, o.shape[0], 5)
    s = B.SIDES[side]
    t, key, counts = B.bvh_walk_ref(pairs, faces, sph, pln, o, d, t_init, s)
    t0, k0 = B.bvh_closest_ref(faces, sph, pln, o, d, t_init, s)
    assert (k0 >= 0).sum() > (100 if scene == "bench" else 10)
    assert torch.equal(t, t0) and torch.equal(key, k0)
    # One root test, two a visited inner node; a leaf's faces each.
    assert counts.dtype == torch.int32 and counts.shape == (o.shape[0], 2)
    assert ((counts[:, 0] % 2 == 1) & (counts[:, 1] >= 0)).all()
    assert counts[k0 >= 0, 1].min() >= 1


@pytest.mark.parametrize("scene,plane_bug", [("bench", False),
                                             ("bench", True),
                                             ("cube", False)])
def test_walk_occlusion_equals_brute_force(bench, scene, plane_bug):
    pairs, faces, sph, pln, o, d = _case(scene, bench)
    n = o.shape[0]
    t_max = torch.where(torch.arange(n) % 3 == 0, BIG, 1.0)
    occ, counts = B.bvh_walk_ref(pairs, faces, sph, pln, o, d, t_max,
                                 shadow=(MESH_SHADOW_BIAS, 1e-5, plane_bug))
    occ0 = B.bvh_anyhit_ref(faces, sph, pln, o, d, t_max, MESH_SHADOW_BIAS,
                            1e-5, plane_bug)
    assert 0 < int(occ0.sum()) < n
    assert torch.equal(occ, occ0)
    assert counts.shape == (n, 2) and (counts >= 0).all()


def test_walk_mutant_loses_hits(monkeypatch):
    """No widening and boxes one ulp tighter: the walk drops hits on the
    cube's flat leaf boxes, so the exact comparisons above can fail."""
    pairs, faces, sph, pln, o, d = _case("cube", None)
    t_init = torch.full((o.shape[0],), BIG)
    t0, k0 = B.bvh_closest_ref(faces, sph, pln, o, d, t_init, 2)
    tight = pairs.clone()
    tight[1:, 0:3] = torch.nextafter(tight[1:, 0:3], torch.tensor(BIG))
    tight[1:, 3:6] = torch.nextafter(tight[1:, 3:6], torch.tensor(-BIG))
    monkeypatch.setattr(cull, "BOX_EPS", 0.0)
    t, key, _ = B.bvh_walk_ref(tight, faces, sph, pln, o, d, t_init, 2)
    assert int((key != k0).sum()) > 0
