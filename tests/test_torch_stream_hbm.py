"""Kernels 6 and 7 (ops/stream_hbm.py) and the coherence sort
(ops/trace.py:coherence_order): the plain PyTorch twins against the JAX
package's grouped stream_closest_hbm / stream_anyhit_hbm Pallas kernels,
run in interpret mode on the CPU, on coherence-sorted seeded rays over the
bench scene (the 1408-face teapot and the analytic instances), with the
group shrunk to 256 faces on both sides (as tests/test_stream_hbm.py does)
so the group sweep and the cull run over several groups.

Tolerances are those of tests/test_stream_hbm.py:39-54: hit sets differ on
under 0.5% of lanes, t to rtol = 1e-4, face ids equal on over 99% of the
lanes both hit, and where they differ the two t agree to 1e-3 (equal-t
seam faces). The JAX kernel builds its face rows with XLA, which contracts
multiply-adds, so rows and tests differ by ulps. Occlusion differs on under
0.5% of lanes. Against the port's own flat twin, which reads the same rows
with the same arithmetic, the grouped twin is exact: the cull is
conservative. The sort is an integer permutation and equals JAX's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhraytracer_tpu.ops import pallas_stream_hbm as JH
from bhraytracer_tpu.ops.linalg import BIG
from bhraytracer_tpu.ops.pallas_bvh import _coherence_order
from bhraytracer_tpu.ops.pallas_trace import instance_table
from bhraytracer_tpu_torch.ops import stream as K
from bhraytracer_tpu_torch.ops import stream_hbm as H
from bhraytracer_tpu_torch.ops.compact import inverse_permutation
from bhraytracer_tpu_torch.ops.trace import (
    MESH_SHADOW_BIAS,
    analytic_tables,
    coherence_order,
)
from tests._torch_parity import jax_scene, port_pack, seeded_rays

torch.set_num_threads(2)

N = 2048
GROUP = 256


@pytest.fixture
def small_groups():
    old = JH.GROUP
    JH.set_group_faces(GROUP)
    try:
        yield
    finally:
        JH.set_group_faces(old)


def _sorted_rays(seed, aux):
    """Seeded rays in the port's coherence order, as numpy and torch."""
    o, d = seeded_rays(N, seed)
    order = coherence_order(port_pack("bench"), torch.from_numpy(o),
                            torch.from_numpy(d), torch.from_numpy(aux)).numpy()
    o, d, aux = o[order], d[order], aux[order]
    return (o, d, aux), tuple(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (o, d, aux))


def _jax_tables(jpack):
    return (instance_table(jpack.sph_itm, jpack.sph_pos),
            instance_table(jpack.pln_itm, jpack.pln_pos))


@pytest.mark.parametrize("side,seed", [("front", 31), ("both", 32)])
def test_hbm_closest_twin_matches_jax(side, seed, small_groups):
    jpack, _ = jax_scene("bench")
    (o, d, ti), (to, td, tti) = _sorted_rays(seed, np.full(N, BIG, np.float32))
    jsph, jpln = _jax_tables(jpack)
    jt, jface, jfront = (np.asarray(x) for x in JH.stream_closest_hbm(
        jpack, jnp.asarray(o), jnp.asarray(d), side, jnp.asarray(ti),
        sph_tab=jsph, pln_tab=jpln))

    pack = port_pack("bench")
    sph, pln = analytic_tables(pack)
    rows, boxes = H.group_tables(pack, GROUP)
    t, key = H.stream_closest_hbm(rows, boxes, GROUP, sph, pln, to, td, tti,
                                  side)
    t, key = t.numpy(), key.numpy()
    face = key >> 1

    hit, jhit = t < BIG, jt < BIG
    assert (jface[jhit] >= 0).sum() > 100 and (jface[jhit] <= -2).sum() > 100
    assert (hit != jhit).mean() < 0.005
    both = hit & jhit
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-4, atol=1e-5)
    match = face[both] == jface[both]
    assert match.mean() > 0.99
    np.testing.assert_allclose(t[both][~match], jt[both][~match], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal((key & 1)[both][match],
                                  jfront[both][match])


def test_hbm_anyhit_twin_matches_jax(small_groups):
    jpack, _ = jax_scene("bench")
    tm = np.where(np.arange(N) % 3 == 0, BIG, 1.0).astype(np.float32)
    (o, d, tm), (to, td, ttm) = _sorted_rays(33, tm)
    jsph, jpln = _jax_tables(jpack)
    jocc = np.asarray(JH.stream_anyhit_hbm(
        jpack, jnp.asarray(o), jnp.asarray(d), MESH_SHADOW_BIAS,
        jnp.asarray(tm), sph_tab=jsph, pln_tab=jpln, ana_bias=1e-5))

    pack = port_pack("bench")
    sph, pln = analytic_tables(pack)
    rows, boxes = H.group_tables(pack, GROUP)
    occ = H.stream_anyhit_hbm(rows, boxes, GROUP, sph, pln, to, td, ttm,
                              MESH_SHADOW_BIAS, ana_bias=1e-5).numpy()
    assert 0.05 < jocc.mean() < 0.95
    assert (occ != jocc).mean() < 0.005


def _fan_rays(n):
    """Camera-like rays: one origin, targets on a fine grid over the
    teapot's box, so 128 consecutive rays form a tight beam."""
    pack = port_pack("bench")
    lo, hi = pack.bvh_bmin[0].numpy(), pack.bvh_bmax[0].numpy()
    side = int(np.sqrt(n))
    u, v = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, n // side))
    target = np.stack([lo[0] + u.ravel() * (hi[0] - lo[0]),
                       np.full(u.size, 0.5 * (lo[1] + hi[1])),
                       lo[2] + v.ravel() * (hi[2] - lo[2])], 1)
    o = np.tile(np.array([[0.3, -6.0, 2.0]]), (u.size, 1))
    return o.astype(np.float32), (target - o).astype(np.float32)


@pytest.mark.parametrize("side,rays", [("front", "fan"), ("both", "seeded")])
def test_hbm_twin_equals_flat_twin(side, rays):
    """The grouped twin gives the flat twin's result key for key, on
    coherence-sorted rays; on the beam the cull skips groups."""
    pack = port_pack("bench")
    sph, pln = analytic_tables(pack)
    rows, boxes = H.group_tables(pack, GROUP)
    o, d = _fan_rays(N) if rays == "fan" else seeded_rays(N, 34)
    n = o.shape[0]
    ti = np.full(n, BIG, np.float32)
    ti[::5] = 3.0
    o, d, t_init = (torch.from_numpy(x) for x in (o, d, ti))
    order = coherence_order(pack, o, d, t_init)
    o, d, t_init = (x[order].contiguous() for x in (o, d, t_init))
    t1, k1 = H.stream_closest_hbm(rows, boxes, GROUP, sph, pln, o, d, t_init,
                                  side)
    t0, k0 = K.stream_closest(pack.stream_rows, sph, pln, o, d, t_init, side)
    assert torch.equal(t1, t0) and torch.equal(k1, k0)
    assert (k0 >> 1 >= 0).sum() > 100

    tm = torch.where(torch.arange(n) % 2 == 0, BIG, 1.5)
    a1 = H.stream_anyhit_hbm(rows, boxes, GROUP, sph, pln, o, d, tm,
                             MESH_SHADOW_BIAS, ana_bias=1e-5)
    a0 = K.stream_anyhit(pack.stream_rows, sph, pln, o, d, tm,
                         MESH_SHADOW_BIAS, ana_bias=1e-5)
    assert torch.equal(a1, a0) and 0.05 < float(a0.float().mean()) < 0.95

    if rays == "fan":  # the cull really skips groups on a beam
        _, _, _, rbox = H._block_rays(o, d)
        cap = torch.full((rbox.shape[0],), BIG)
        skipped = sum(rbox.shape[0] - H._live_blocks(boxes[g], rbox,
                                                     cap).numel()
                      for g in range(boxes.shape[0]))
        assert skipped > 0


@pytest.mark.parametrize("aux", ["big", "near"])
def test_coherence_order_matches_jax(aux):
    jpack, _ = jax_scene("bench")
    o, d = seeded_rays(N, 36)
    d[::11, 0] = 0.0  # axis-parallel components
    t = np.full(N, BIG, np.float32) if aux == "big" else \
        np.random.default_rng(37).uniform(0.5, 8.0, N).astype(np.float32)
    jorder = np.asarray(_coherence_order(jpack, 0, jnp.asarray(o),
                                         jnp.asarray(d), jnp.asarray(t)))
    order = coherence_order(port_pack("bench"), torch.from_numpy(o),
                            torch.from_numpy(d), torch.from_numpy(t))
    np.testing.assert_array_equal(order.numpy(), jorder)
    inv = inverse_permutation(order)
    np.testing.assert_array_equal(order[inv].numpy(), np.arange(N))


def test_hbm_wrapper_refuses_bad_inputs():
    pack = port_pack("bench")
    sph, pln = analytic_tables(pack)
    rows, boxes = H.group_tables(pack, GROUP)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError):  # rows not a whole number of groups
        H.stream_closest_hbm(rows[:-1], boxes, GROUP, sph, pln, o, o,
                             torch.zeros(4), "front")
    with pytest.raises(ValueError):  # group not a multiple of the tile
        H.group_tables(pack, 100)
    with pytest.raises(ValueError):
        H.stream_anyhit_hbm(rows, boxes[:, :6].contiguous(), GROUP, sph, pln,
                            o, o, torch.zeros(4), MESH_SHADOW_BIAS)
