"""Kernels 4 and 5 (ops/bvh.py): the plain PyTorch twins against the JAX
package's BVH traversals on seeded rays over the bench scene (1408 faces,
no treelets): the packet Pallas kernels (bvh_closest_pallas /
bvh_anyhit_pallas, reorder=False, analytic tables folded in), the
per-row-stack Pallas kernels (bvh_closest_divergent / bvh_anyhit_divergent)
and the XLA traversal (bvh_closest), the Pallas ones in interpret mode on
the CPU. The divergent and XLA forms trace the mesh alone, so the twin is
given empty analytic tables there.

Tolerances, and why they are not exact:
  - t to rtol = 5e-5, atol = 1e-5, as tests/test_torch_stream.py: XLA on
    the CPU contracts a*b+c into fused multiply-adds where the twin rounds
    each product.
  - hit/miss equal on at least 99.9% of lanes: a ray grazing an edge may
    fall inside under one rounding and outside under the other.
  - face ids equal except where the two t agree to 1e-6 relative: the
    reference keeps the first face its traversal visits at equal t, the
    twin the lowest face id.
  - occlusion equal on at least 99.9% of lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhraytracer_tpu.ops import trace as JT
from bhraytracer_tpu.ops.linalg import BIG
from bhraytracer_tpu.ops.pallas_bvh import bvh_anyhit_pallas, bvh_closest_pallas
from bhraytracer_tpu.ops.pallas_bvh_divergent import (
    bvh_anyhit_divergent,
    bvh_closest_divergent,
)
from bhraytracer_tpu.ops.pallas_trace import instance_table
from bhraytracer_tpu_torch.ops import bvh as B
from bhraytracer_tpu_torch.ops.trace import MESH_SHADOW_BIAS, analytic_tables
from tests._torch_parity import jax_scene, port_pack, seeded_rays

torch.set_num_threads(2)

N = 2048


@pytest.fixture
def divergent_on():
    JT.set_divergent_mode("on")
    try:
        yield
    finally:
        JT.set_divergent_mode("off")


def _t_init(kind: str, seed: int):
    if kind == "big":
        return np.full(N, BIG, np.float32)
    rng = np.random.default_rng(seed)
    t = rng.uniform(2.0, 12.0, N).astype(np.float32)
    t[::3] = BIG
    return t


def _jax_closest(impl, jpack, o, d, side, t_init):
    args = (jpack, 0, jnp.asarray(o), jnp.asarray(d), side,
            jnp.asarray(t_init))
    if impl == "packet":
        out = bvh_closest_pallas(
            *args, reorder=False,
            sph_tab=instance_table(jpack.sph_itm, jpack.sph_pos),
            pln_tab=instance_table(jpack.pln_itm, jpack.pln_pos))
    elif impl == "divergent":
        out = bvh_closest_divergent(*args, reorder=False)
    else:
        out = JT.bvh_closest(*args)
    return tuple(np.asarray(x) for x in out)


def _port_tables(impl):
    pack = port_pack("bench")
    sph, pln = analytic_tables(pack)
    if impl != "packet":  # mesh-only forms
        sph, pln = sph[:0], pln[:0]
    return pack, sph, pln


@pytest.mark.parametrize("impl,side,tinit,seed", [
    ("packet", "front", "big", 21), ("packet", "both", "random", 22),
    ("divergent", "front", "random", 23), ("divergent", "both", "big", 24),
    ("xla", "front", "big", 25), ("xla", "both", "random", 26)])
def test_bvh_closest_twin_matches_jax(impl, side, tinit, seed, divergent_on):
    jpack, _ = jax_scene("bench")
    o, d = seeded_rays(N, seed)
    t_init = _t_init(tinit, seed)
    jt, jface, jfront = _jax_closest(impl, jpack, o, d, side, t_init)
    jkey = jface * 2 + jfront

    pack, sph, pln = _port_tables(impl)
    t, key = B.bvh_closest(pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth,
                           sph, pln, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(t_init), side)
    t, key = t.numpy(), key.numpy()
    face = key >> 1

    jhit, hit = jface != -1, face != -1
    assert (jface >= 0).sum() > 100  # the teapot is hit
    if impl == "packet":
        assert (jface <= -2).sum() > 100  # and the analytic instances
    assert (hit == jhit).mean() >= 0.999
    both = hit & jhit
    np.testing.assert_allclose(t[both], jt[both], rtol=5e-5, atol=1e-5)
    np.testing.assert_array_equal(t[~hit & ~jhit], jt[~hit & ~jhit])
    differ = both & (key != jkey)
    # Equal-t ties only: both mesh faces, t equal to 1e-6 relative.
    assert (face[differ] >= 0).all() and (jface[differ] >= 0).all()
    np.testing.assert_allclose(t[differ], jt[differ], rtol=1e-6)


@pytest.mark.parametrize("impl,plane_bug,seed", [("packet", False, 27),
                                                 ("packet", True, 28),
                                                 ("divergent", False, 29)])
def test_bvh_anyhit_twin_matches_jax(impl, plane_bug, seed, divergent_on):
    jpack, _ = jax_scene("bench")
    o, d = seeded_rays(N, seed)
    t_max = np.where(np.arange(N) % 3 == 0, BIG, 1.0).astype(np.float32)
    args = (jpack, 0, jnp.asarray(o), jnp.asarray(d), MESH_SHADOW_BIAS,
            jnp.asarray(t_max))
    if impl == "packet":
        jocc = bvh_anyhit_pallas(
            *args, reorder=False,
            sph_tab=instance_table(jpack.sph_itm, jpack.sph_pos),
            pln_tab=instance_table(jpack.pln_itm, jpack.pln_pos),
            ana_bias=1e-5, plane_world_bug=plane_bug)
    else:
        jocc = bvh_anyhit_divergent(*args, reorder=False)
    jocc = np.asarray(jocc)

    pack, sph, pln = _port_tables(impl)
    occ = B.bvh_anyhit(pack.bvh_pairs, pack.bvh_faces, pack.bvh_depth, sph,
                       pln, torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(t_max), MESH_SHADOW_BIAS,
                       ana_bias=1e-5, plane_world_bug=plane_bug).numpy()
    assert 0.05 < jocc.mean() < 0.95
    assert (occ == jocc).mean() >= 0.999


def test_bvh_wrapper_refuses_bad_inputs():
    pack = port_pack("bench")
    sph, pln = analytic_tables(pack)
    o = torch.zeros((4, 3))
    tabs = (pack.bvh_pairs, pack.bvh_faces)
    with pytest.raises(ValueError):  # deeper than the kernels' stack
        B.bvh_closest(*tabs, B.STACK_DEPTH - 1, sph, pln, o, o,
                      torch.zeros(4), "front")
    # Not the sibling-pair table: 16-float node rows (the JAX package's
    # layout), rows cut short, the pad row dropped (an odd row count).
    n_nodes = pack.bvh_left.shape[0]
    for nodes in (torch.zeros((n_nodes, 16)),
                  pack.bvh_pairs[:, :4].contiguous(), pack.bvh_pairs[1:]):
        with pytest.raises(ValueError):
            B.bvh_closest(nodes, pack.bvh_faces, pack.bvh_depth, sph, pln, o,
                          o, torch.zeros(4), "front")
        with pytest.raises(ValueError):
            B.bvh_anyhit(nodes, pack.bvh_faces, pack.bvh_depth, sph, pln, o,
                         o, torch.zeros(4), MESH_SHADOW_BIAS)
    with pytest.raises(ValueError):
        B.bvh_anyhit(*tabs, pack.bvh_depth, sph, pln, o, o.double(),
                     torch.zeros(4), MESH_SHADOW_BIAS)
