"""Kernel 3 (ops/shade.py): the plain PyTorch twin against the JAX
package's fused shade_setup Pallas kernel, run in interpret mode on the
CPU, with the same rays, hits, shade mask and uniform table on both sides.

Tolerances: float outputs to rtol = atol = 1e-4 on the shaded lanes (miss
lanes carry junk that every consumer masks). XLA on the CPU contracts
a*b+c into fused multiply-adds where the twin rounds each product, and its
pow, sin and cos differ from PyTorch's by an ulp or two; the sphere root
and the normalisations amplify that to at most 7.2e-5 on these lanes
(1e-5 fails on up to 12 of the 2048). The CUDA kernel and the twin agree
exactly on the card. The discrete outputs mtl, gate and rr0 are equal on
every lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhraytracer_tpu.config import RenderConfig as JConfig
from bhraytracer_tpu.ops import trace as JT
from bhraytracer_tpu.ops.pallas_shade import shade_setup as j_shade_setup
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.ops import shade as S
from bhraytracer_tpu_torch.ops.trace import Hit
from tests._torch_parity import jax_scene, pallas_on, port_pack, seeded_rays

torch.set_num_threads(2)

N = 2048
FLOAT_FIELDS = [f for f in S.ShadeSetup._fields
                if f not in ("mtl", "gate", "rr0")]


@pytest.mark.parametrize("name,seed", [("bench", 11), ("tiny", 12)])
def test_shade_twin_matches_jax(name, seed):
    jpack, _ = jax_scene(name)
    o, d = seeded_rays(N, seed)
    rng = np.random.default_rng(seed)
    u_tab = rng.uniform(size=(N, 13)).astype(np.float32)
    active = rng.uniform(size=N) > 0.1
    with pallas_on():
        jhit = JT.trace_closest(jpack, jnp.asarray(o), jnp.asarray(d), "front")
        shade = np.asarray(jhit.hit) & active
        jout = j_shade_setup(jpack, JConfig(), jnp.asarray(o), jnp.asarray(d),
                             jhit, jnp.asarray(shade), jnp.asarray(u_tab))
    jout = jax.tree.map(np.asarray, jout)

    hit = Hit(*[torch.from_numpy(np.array(x)) for x in jhit])
    out = S.shade_setup(port_pack(name), RenderConfig(), torch.from_numpy(o),
                        torch.from_numpy(d), hit, torch.from_numpy(shade),
                        torch.from_numpy(u_tab))
    out = {k: v.numpy() for k, v in out._asdict().items()}

    assert shade.sum() > N // 4
    assert jout.gate.sum() > N // 8  # lanes that issue a shadow ray
    for k in ("mtl", "gate", "rr0"):
        np.testing.assert_array_equal(out[k], getattr(jout, k), err_msg=k)
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(out[k][shade], getattr(jout, k)[shade],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_shade_planes_refuse_bad_inputs():
    pack = port_pack("tiny")
    inst, mtl, light = S.shade_tables(pack)
    n = 8
    planes, hits, u = (torch.zeros((6, n)), torch.zeros((4, n), dtype=torch.int32),
                       torch.zeros((13, n)))
    args = [planes, hits, u, pack.resolve_rows, inst, pack.n_sph, pack.n_pln,
            pack.n_msh, mtl, light, 1e-4]
    assert S.shade_planes(*args).shape == (S.N_OUT, n)
    for i, bad in ((0, planes.double()), (1, hits.float()), (2, u[:12]),
                   (4, inst[:1])):
        with pytest.raises(ValueError):
            S.shade_planes(*args[:i], bad, *args[i + 1:])


def test_gate_refuses_big_tables():
    import dataclasses

    pack = port_pack("tiny")
    big = dataclasses.replace(pack, n_lights=S.MAX_LIGHTS + 1)
    with pytest.raises(NotImplementedError):
        S.check_supported(big)


@pytest.mark.parametrize("name,seed", [("bench", 13), ("tiny", 14)])
def test_fused_step_matches_unfused_functions(name, seed):
    """The level's fused shade step (twin + shadow trace + visibility fold)
    against the port's unfused functions (_direct_light, _gi_sample, ...),
    the JAX package's XLA shading path. Tolerances as JAX's own fused-vs-XLA
    test (tests/test_pallas_shade.py): the kernel's samplers are algebraic
    rewrites of the unfused ones (no acos/tan, other summation order), so
    pow and the normalisations differ by a few ulps, and a lobe or light
    choice at a threshold would differ far beyond them."""
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops.trace import trace_closest

    pack = port_pack(name)
    o, d = (torch.from_numpy(x) for x in seeded_rays(N, seed))
    rng = np.random.default_rng(seed)
    u_tab = torch.from_numpy(rng.uniform(size=(N, 13)).astype(np.float32))
    hit = trace_closest(pack, o, d, "front")
    shade = hit.hit & torch.from_numpy(rng.uniform(size=N) > 0.1)
    cfg = RenderConfig()
    f = PT._shade_fused(pack, cfg, o, d, hit, shade, u_tab)
    u = PT._shade_unfused(pack, cfg, o, d, hit, shade, u_tab)
    m = shade.numpy()
    assert m.sum() > N // 4
    assert int(f.n_shadow) == int(u.n_shadow) > N // 8
    np.testing.assert_array_equal(f.surf.mtl.numpy()[m], u.surf.mtl.numpy()[m])
    for a, b, rtol, atol in ((f.surf.p, u.surf.p, 1e-4, 1e-4),
                             (f.surf.n, u.surf.n, 1e-4, 1e-5),
                             (f.surf.z, u.surf.z, 1e-4, 1e-5),
                             (f.direct, u.direct, 2e-3, 2e-4),
                             (f.gi_o, u.gi_o, 1e-4, 1e-4),
                             (f.gi_d, u.gi_d, 1e-3, 1e-4),
                             (f.gi_albedo, u.gi_albedo, 1e-3, 1e-5),
                             (f.gi_env, u.gi_env, 1e-3, 1e-5),
                             (f.refr_eff, u.refr_eff, 1e-3, 1e-5),
                             (f.cos_phi1, u.cos_phi1, 1e-4, 1e-5)):
        np.testing.assert_allclose(a.numpy()[m], b.numpy()[m], rtol=rtol,
                                   atol=atol)
