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


def _lane_args(pack, o, d, hit, shade, u_tab):
    """shade_lanes' arguments for a level's tensors, as shade_setup passes
    them."""
    inst, mtl, light = S.shade_tables(pack)
    return [o, d, hit.kind, hit.inst, hit.face, hit.front, shade, u_tab,
            pack.resolve_rows, inst, pack.n_sph, pack.n_pln, pack.n_msh, mtl,
            light, RenderConfig().bias]


def test_shade_planes_refuse_bad_inputs():
    """shade_lanes (the kernel's and the twin's one entry) takes the
    level's tensors as they are and refuses what the kernel does not."""
    n = 8
    ids = torch.zeros(n, dtype=torch.int32)
    mask = torch.zeros(n, dtype=torch.bool)
    hit = Hit(t=torch.zeros(n), kind=ids, inst=ids, face=ids, front=mask,
              hit=mask)
    args = _lane_args(port_pack("tiny"), torch.zeros((n, 3)),
                      torch.zeros((n, 3)), hit, mask, torch.zeros((n, 13)))
    assert S.shade_lanes(*args).p.shape == (n, 3)
    o, kind, front, u = args[0], args[2], args[5], args[7]
    for i, bad in ((0, o.double()), (0, o.T.contiguous().T), (2, kind.long()),
                   (5, front.int()), (7, u[:, :12].contiguous()),
                   (7, u[:4]), (9, args[9][:1])):
        with pytest.raises(ValueError):
            S.shade_lanes(*args[:i], bad, *args[i + 1:])


def test_shade_outputs_in_consumer_layouts():
    """The fused step's outputs come in the layouts their consumers read:
    every vector a contiguous (N,3), every scalar an (N,) of its type, so
    the shadow trace and the GI children copy nothing."""
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops.trace import trace_closest

    pack = port_pack("bench")
    n = 256
    o, d = (torch.from_numpy(x) for x in seeded_rays(n, 15))
    u_tab = torch.from_numpy(
        np.random.default_rng(15).uniform(size=(n, 13)).astype(np.float32))
    hit = trace_closest(pack, o, d, "front")
    fo = S.shade_setup(pack, RenderConfig(), o, d, hit, hit.hit, u_tab)
    lanes = S.shade_lanes(*_lane_args(pack, o, d, hit, hit.hit, u_tab))
    for a, b in zip(fo, lanes):
        assert torch.equal(a, b)
    scalars = {"z": torch.float32, "mtl": torch.int32,
               "shadow_tmax": torch.float32, "gate": torch.bool,
               "rr0": torch.bool, "cos_theta": torch.float32,
               "cos_phi1": torch.float32}
    for name, x in fo._asdict().items():
        assert x.is_contiguous(), name
        if name in scalars:
            assert x.shape == (n,) and x.dtype == scalars[name], name
        else:
            assert x.shape == (n, 3) and x.dtype == torch.float32, name
    f = PT._shade_fused(pack, RenderConfig(), o, d, hit, hit.hit, u_tab)
    for x in (f.surf.p, f.surf.n, f.gi_o, f.gi_d, f.gi_albedo, f.refr_eff):
        assert x.shape == (n, 3) and x.is_contiguous()


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


@pytest.mark.parametrize("name,seed", [("tiny", 15), ("bench", 16),
                                       ("lights0", 17), ("textured", 18)])
def test_unfused_step_gradients_finite(name, seed):
    """A differentiable render shades unfused (the gate's differentiable
    clause, as pallas_shade.py:508), and the unfused step's gradients with
    respect to the rays and the material, light, vertex and texture tables
    are finite on every lane, shaded or not: the masked branches (misses,
    no lights, grazing and degenerate directions, the 32-tap filter) are
    guarded as the JAX package guards them (safe_sqrt, safe_pow, the
    plane's and the mesh's graze selects)."""
    import dataclasses

    from bhraytracer_tpu_torch import scenes
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops.trace import rows_from_pools, trace_closest

    if name == "lights0":
        pack = scenes.crowd_scene("lights0", "cpu")[0]
    elif name == "textured":
        pack = scenes.textured_scene("cpu")[0]
    else:
        pack = port_pack(name)
    cfg = RenderConfig(differentiable=True)
    assert not S.shade_setup_supported(pack, cfg, None)
    keys = ["mtl_diffuse", "mtl_specular", "mtl_gloss", "mtl_refraction",
            "light_intensity", "light_vec"]
    if pack.n_msh:
        keys.append("verts")
    if pack.n_texmaps:
        keys += ["tex_c1", "atlas"]
    leaves = {k: getattr(pack, k).detach().float().clone().requires_grad_()
              for k in keys}
    pack = dataclasses.replace(pack, **leaves)
    if pack.n_msh:
        pack = dataclasses.replace(pack, resolve_rows=rows_from_pools(pack))
    o, d = (torch.from_numpy(x).requires_grad_()
            for x in seeded_rays(N, seed))
    rng = np.random.default_rng(seed)
    u_tab = torch.from_numpy(rng.uniform(size=(N, 13)).astype(np.float32))
    hit = trace_closest(pack, o, d, "front")
    shade = hit.hit & torch.from_numpy(rng.uniform(size=N) > 0.1)
    sh = PT._shade_unfused(pack, cfg, o, d, hit, shade, u_tab)
    outs = (sh.surf.p, sh.surf.n, sh.direct, sh.refr_eff, sh.gi_o, sh.gi_d,
            sh.gi_albedo, sh.gi_env)
    loss = sum((torch.where(shade[:, None], x, 0.0)
                * torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
                ).sum() for x in outs)
    grads = torch.autograd.grad(loss, [o, d, *leaves.values()],
                                allow_unused=True)
    assert int(shade.sum()) > N // 4
    for k, g in zip(["o", "d", *leaves], grads):
        assert g is None or bool(torch.isfinite(g).all()), k
    assert float(grads[2].abs().max()) > 0  # mtl_diffuse
