"""Kernels 1 and 2 (ops/stream.py): the plain PyTorch twins against the
JAX package's stream_closest / stream_anyhit Pallas kernels, run in
interpret mode on the CPU, on seeded rays over the bench scene (1408
faces, two spheres, a plane) and the mesh-free tiny scene (one all-zero
face row, culled everywhere).

Both sides are fed the same face table (the JAX kernel's own
`_stream_table`), so the comparison isolates the kernels' arithmetic.
Tolerances: t to rtol = 5e-5, atol = 1e-5. XLA on the CPU contracts a*b+c
into fused multiply-adds where the twin (and the CUDA kernel) round each
product, so the two sides differ by a few ulps in every product; the
sphere roots (-b +- sqrt(b^2 - 4ac)) / 2a amplify that near tangency and
grazing plane hits amplify it in -o_z / d_z, up to 1.6e-5 relative on
these rays (1e-6 fails on 0.2-0.6% of the lanes). Keys are equal except
in the documented equal-t seam family (a seam ray may take the adjacent
face at the same t, pallas_stream.py:31-34). Occlusion is equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhraytracer_tpu.ops.linalg import BIG
from bhraytracer_tpu.ops.pallas_stream import _stream_table
from bhraytracer_tpu.ops.pallas_stream import stream_anyhit as j_anyhit
from bhraytracer_tpu.ops.pallas_stream import stream_closest as j_closest
from bhraytracer_tpu.ops.pallas_trace import instance_table
from bhraytracer_tpu_torch.ops import stream as K
from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables
from tests._torch_parity import jax_scene, port_pack, seeded_rays

torch.set_num_threads(2)

N = 2048


def _tables(name):
    jpack, _ = jax_scene(name)
    sph = instance_table(jpack.sph_itm, jpack.sph_pos) if jpack.n_sph else None
    pln = instance_table(jpack.pln_itm, jpack.pln_pos) if jpack.n_pln else None
    return jpack, sph, pln


@pytest.mark.parametrize("name,side,seed", [("bench", "front", 1),
                                            ("bench", "both", 2),
                                            ("tiny", "front", 3),
                                            ("tiny", "both", 4)])
def test_stream_closest_twin_matches_jax(name, side, seed):
    jpack, sph, pln = _tables(name)
    o, d = seeded_rays(N, seed)
    t_init = np.full(N, BIG, np.float32)
    t_init[::7] = 4.0  # some lanes seeded with a nearer hit
    jt, jface, jfront = j_closest(jpack, jnp.asarray(o), jnp.asarray(d), side,
                                  t_init=jnp.asarray(t_init), sph_tab=sph,
                                  pln_tab=pln)
    jt, jface, jfront = np.asarray(jt), np.asarray(jface), np.asarray(jfront)
    jkey = jface * 2 + jfront

    rows = torch.from_numpy(np.array(_stream_table(jpack)))
    tsph, tpln = analytic_tables(port_pack(name))
    t, key = K.stream_closest(rows, tsph, tpln, torch.from_numpy(o),
                              torch.from_numpy(d), torch.from_numpy(t_init),
                              side)
    t, key = t.numpy(), key.numpy()

    hit = jt < BIG
    assert hit.sum() > N // 4
    if name == "bench":
        assert (jface[hit] >= 0).sum() > 100  # the teapot is hit
    assert (jface[hit] <= -2).sum() > 100  # and the analytic instances
    np.testing.assert_array_equal(t < BIG, hit)
    np.testing.assert_allclose(t, jt, rtol=5e-5, atol=1e-5)
    same = key == jkey
    assert same.mean() > 0.995
    seam = ~same
    # Seam family only: both mesh faces, same t.
    assert (jface[seam] >= 0).all() and (key[seam] >= 0).all()
    np.testing.assert_allclose(t[seam], jt[seam], rtol=5e-5, atol=1e-5)


@pytest.mark.parametrize("name,plane_bug,seed", [("bench", False, 5),
                                                 ("bench", True, 6),
                                                 ("tiny", False, 7)])
def test_stream_anyhit_twin_matches_jax(name, plane_bug, seed):
    jpack, sph, pln = _tables(name)
    o, d = seeded_rays(N, seed)
    t_max = np.where(np.arange(N) % 3 == 0, BIG, 1.0).astype(np.float32)
    jocc = np.asarray(j_anyhit(jpack, jnp.asarray(o), jnp.asarray(d),
                               MESH_SHADOW_BIAS, jnp.asarray(t_max),
                               sph_tab=sph, pln_tab=pln, ana_bias=1e-5,
                               plane_world_bug=plane_bug))
    rows = torch.from_numpy(np.array(_stream_table(jpack)))
    tsph, tpln = analytic_tables(port_pack(name))
    occ = K.stream_anyhit(rows, tsph, tpln, torch.from_numpy(o),
                          torch.from_numpy(d), torch.from_numpy(t_max),
                          MESH_SHADOW_BIAS, ana_bias=1e-5,
                          plane_world_bug=plane_bug).numpy()
    assert 0.05 < jocc.mean() < 0.95
    np.testing.assert_array_equal(occ, jocc)


def test_wrapper_refuses_bad_inputs():
    pack = port_pack("tiny")
    sph, pln = analytic_tables(pack)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        K.stream_closest(pack.stream_rows, sph, pln, o.double(), o,
                         torch.zeros(4), "front")
    with pytest.raises(ValueError):
        K.stream_closest(pack.stream_rows[:5], sph, pln, o, o,
                         torch.zeros(4), "front")
    with pytest.raises(ValueError):
        K.stream_anyhit(pack.stream_rows, sph, pln, o, o.T.contiguous().T,
                        torch.zeros(4), MESH_SHADOW_BIAS)


@pytest.mark.parametrize("side,seed", [("front", 8), ("both", 9)])
def test_stream_twin_matches_reference_tests(side, seed):
    """The stream twin on the port's own rows against the reference's
    per-primitive tests (ops/intersect.py: sphere and plane in the instance
    frame, the dominant-axis triangle test over every face), as
    tests/test_stream.py holds the JAX stream kernel to the XLA traversal:
    the affine-barycentric inside set equals the dominant-axis one up to
    edge rounding, so hit sets may differ on a sub-percent seam tail and
    face ids only at equal t."""
    from bhraytracer_tpu_torch.ops.intersect import (
        plane_intersect,
        sphere_intersect,
        triangle_intersect,
    )
    from bhraytracer_tpu_torch.ops.linalg import mat_vec
    from bhraytracer_tpu_torch.ops.trace import trace_closest

    pack = port_pack("bench")
    o, d = (torch.from_numpy(x) for x in seeded_rays(N, seed))
    best = torch.full((N,), BIG)
    code = torch.full((N,), -1, dtype=torch.int64)
    for kind, (itm, pos, fn) in enumerate(
            ((pack.sph_itm, pack.sph_pos, sphere_intersect),
             (pack.pln_itm, pack.pln_pos, plane_intersect))):
        for k in range(itm.shape[0]):
            t, _ = fn(mat_vec(itm[k], o - pos[k]), mat_vec(itm[k], d), side)
            upd = t < best
            best = torch.where(upd, t, best)
            code = torch.where(upd, -(2 + 4 * k + 2 * kind), code)
    t, _ = triangle_intersect(pack.wtri_v0[None], pack.wtri_v1[None],
                              pack.wtri_v2[None], o[:, None], d[:, None], side)
    tmin, face = t.min(1)
    mesh = tmin < best
    best = torch.where(mesh, tmin, best)
    hit_ref = (best < BIG).numpy()

    h = trace_closest(pack, o, d, side)
    t, hit = h.t.numpy(), h.hit.numpy()
    assert hit_ref.sum() > N // 4 and mesh.sum() > 100
    assert (hit != hit_ref).mean() < 0.005
    both = hit & hit_ref
    np.testing.assert_allclose(t[both], best.numpy()[both], rtol=1e-4,
                               atol=1e-5)
    mesh_both = both & mesh.numpy() & (h.face.numpy() >= 0)
    assert (h.face.numpy()[mesh_both] == face.numpy()[mesh_both]).mean() > 0.99
