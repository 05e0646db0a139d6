"""The port's texture pipeline against the JAX package's, function by
function, on the same seeded numpy inputs: tile_clamp, texture_eval,
texmap_sample (1 and 32 taps), the environment and background mappings,
the filter taps, the PNG and PPM readers, resolve_hit's full form and the
textured direct-light term with a photon map. The scene is the port's
data/textured.xml (checker, wood.png, china.png, a textured background
and environment), loaded by the JAX package and carried across
(pack_from_numpy), so both sides read the same tables.

Tolerances, and why:
  - tile_clamp, the filter taps, the decoded images and every texel index
    the lookups read are equal;
  - colours to 1e-6: the bilinear weights and the 32-tap sum are float32
    sums of the same terms, which XLA may contract into fused multiply-adds
    and sum in another order;
  - uvw and duvw of resolve_hit to 1e-5 (a sphere's uv goes through atan2
    and asin, whose ulps differ between XLA and torch; measured: 2.5e-7);
  - the direct term to 1e-5 with rtol 1e-4 on every lane where both
    packages take the same light and shadow decisions (equal shadow-query
    counts, and at least 99% of lanes).
All JAX calls run op by op (no jit of a whole render), a few seconds in
all.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhraytracer_tpu.config import RenderConfig as JConfig
from bhraytracer_tpu.ops import texturing as JT
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.ops import texturing as T
from tests._torch_parity import jax_scene, port_pack

torch.set_num_threads(2)

N = 4096


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Recorder:
    """A JAX atlas that records every (texture, row, column) it is indexed
    with, in call order, and answers from the real atlas."""

    def __init__(self, atlas):
        self.atlas, self.seen = atlas, []

    def __getitem__(self, idx):
        self.seen.append([_np(i).astype(np.int64) for i in idx])
        return self.atlas[idx]


def _uvw(seed, n=N):
    """Seeded texture coordinates over several tiles, with the edges of
    tile_clamp among them (integers, tiny negatives, one ulp below 1; the
    subnormals, on which XLA on the CPU differs, only in
    test_tile_clamp_matches_jax)."""
    g = np.random.default_rng(seed)
    uvw = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    edges = np.array([0.0, -0.0, 1.0, -1.0, 0.5, 2.0, -2.0, 1e-8, -1e-8,
                      -1e-30, -1e-37, np.float32(1) - np.float32(2 ** -24),
                      -np.float32(1) + np.float32(2 ** -24), 255.0 / 256.0,
                      -1.0 / 256.0], np.float32)
    k = len(edges)
    uvw[:k * k, 0] = np.repeat(edges, k)
    uvw[:k * k, 1] = np.tile(edges, k)
    return uvw


def test_tile_clamp_matches_jax():
    """Equal on every normal float32 input. XLA on the CPU flushes float32
    subnormals to zero, so JAX wraps -1e-45 to 0.0; the port keeps the
    subnormal, negative, as the reference's C++ does, and wraps it to 1.0
    (a recorded divergence, ROADMAP Queue 3)."""
    u = np.concatenate([_uvw(0).reshape(-1),
                        np.array([-1e-45, 1e-45, -1e-40], np.float32)])
    ours = T.tile_clamp(torch.from_numpy(u)).numpy()
    ref = np.asarray(JT.tile_clamp(jnp.asarray(u)))
    normal = (u == 0) | (np.abs(u) >= np.finfo(np.float32).tiny)
    assert (~normal).any()
    np.testing.assert_array_equal(ours[normal], ref[normal])
    neg = ~normal & (u < 0)
    assert (ours[neg] == 1.0).all() and (ref[~normal] == 0.0).all()
    assert ((ours >= 0.0) & (ours <= 1.0)).all()
    # A tiny negative u wraps to exactly 1.0 (u - trunc(u) + 1).
    assert T.tile_clamp(torch.tensor([-1e-8]))[0] == 1.0


@pytest.mark.parametrize("taps", [1, 32])
def test_texmap_sample_gradients_match_jax(taps):
    """The gradients of a seeded weighting of texmap_sample (every map,
    zero and nonzero duvw) with respect to the checker colours and the
    float32 atlas, port against JAX: the port gathers one texture id a
    lane for the filter's taps and reads the tables through lookup_rows,
    JAX expands the ids and indexes. Within 1e-3 max|g| + 1e-9 per table
    (measured: equal at 1 tap; at 32, 3.9e-6 of max|g| on the checker
    colours, summed in another order, and the atlas equal)."""
    import jax

    jpack = jax_scene("textured")[0]
    pack = port_pack("textured")
    g = np.random.default_rng(6)
    n = 1024
    tm = g.integers(-1, pack.n_texmaps, n).astype(np.int32)
    uvw, duvw = _uvw(7, n), _duvw(8, n)
    wts = g.normal(size=(n, 3)).astype(np.float32)
    tabs = (np.array(jpack.tex_c1), np.array(jpack.tex_c2),
            np.array(jpack.atlas).astype(np.float32))

    def jf(c1, c2, atlas):
        p = dataclasses.replace(jpack, tex_c1=c1, tex_c2=c2, atlas=atlas)
        return (JT.texmap_sample(p, jnp.asarray(tm), jnp.asarray(uvw),
                                 jnp.asarray(duvw), taps=taps)
                * jnp.asarray(wts)).sum()

    ref = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, tabs))
    leaves = [torch.from_numpy(t).requires_grad_() for t in tabs]
    p = dataclasses.replace(pack, tex_c1=leaves[0], tex_c2=leaves[1],
                            atlas=leaves[2])
    f = (T.texmap_sample(p, torch.from_numpy(tm), torch.from_numpy(uvw),
                         torch.from_numpy(duvw), taps=taps)
         * torch.from_numpy(wts)).sum()
    for name, ours, jg in zip(("tex_c1", "tex_c2", "atlas"),
                              torch.autograd.grad(f, leaves), ref):
        jg = np.asarray(jg)
        top = float(np.abs(jg).max())
        assert top > 0, name
        err = float(np.abs(ours.numpy() - jg).max())
        assert err <= 1e-3 * top + 1e-9, (name, err, top)



@pytest.mark.parametrize("n", [1, 2, 32, 64])
def test_filter_taps_match_jax(n):
    from bhraytracer_tpu.utils.halton import texture_filter_taps as j_taps
    from bhraytracer_tpu_torch.utils.halton import texture_filter_taps

    np.testing.assert_array_equal(texture_filter_taps(n), j_taps(n))
    np.testing.assert_array_equal(T.filter_taps(n, "cpu").numpy(), j_taps(n))


def test_texture_eval_matches_jax(monkeypatch):
    """Checker and both file textures: every texel index the four bilinear
    fetches read is equal (the JAX atlas's indexing against the port's
    atlas_texels), and the colours agree to 1e-6."""
    jpack = jax_scene("textured")[0]
    pack = port_pack("textured")
    kinds = pack.tex_kind.numpy()
    assert set(kinds.tolist()) == {0, 1}
    uvw = _uvw(1)
    tex = np.random.default_rng(2).integers(0, len(kinds), N).astype(np.int32)
    jrec, seen = _Recorder(jpack.atlas), []
    texels = T.atlas_texels

    def recorded(atlas, tex_id, yy, xx):
        seen.append([_np(i).astype(np.int64) for i in (tex_id, yy, xx)])
        return texels(atlas, tex_id, yy, xx)

    monkeypatch.setattr(T, "atlas_texels", recorded)
    ref = JT.texture_eval(dataclasses.replace(jpack, atlas=jrec),
                          jnp.asarray(tex), jnp.asarray(uvw))
    ours = T.texture_eval(pack, torch.from_numpy(tex), torch.from_numpy(uvw))
    assert len(seen) == len(jrec.seen) == 4
    for a, b in zip(seen, jrec.seen):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # Both kinds were taken, and the file lanes are not constant.
    file_lanes = kinds[tex] == 0
    assert file_lanes.any() and (~file_lanes).any()
    assert ours.numpy()[file_lanes].std() > 0.05


def _duvw(seed, n=N, zero_every=2):
    g = np.random.default_rng(seed)
    duvw = g.normal(0.0, 0.02, (n, 2, 3)).astype(np.float32)
    duvw[::zero_every] = 0.0
    return duvw


@pytest.mark.parametrize("taps", [1, 32])
@pytest.mark.parametrize("with_duvw", [False, True], ids=["uvw", "duvw"])
def test_texmap_sample_matches_jax(taps, with_duvw):
    """Every texture map (the ids -1 included) at 1 and 32 taps, with no
    derivatives, or with zero and nonzero ones on alternate lanes."""
    jpack = jax_scene("textured")[0]
    pack = port_pack("textured")
    g = np.random.default_rng(3)
    tm = g.integers(-1, pack.n_texmaps, N).astype(np.int32)
    uvw = _uvw(4)
    duvw = _duvw(5) if with_duvw else None
    ref = JT.texmap_sample(jpack, jnp.asarray(tm), jnp.asarray(uvw),
                           None if duvw is None else jnp.asarray(duvw),
                           taps=taps)
    ours = T.texmap_sample(pack, torch.from_numpy(tm), torch.from_numpy(uvw),
                           None if duvw is None else torch.from_numpy(duvw),
                           taps=taps)
    ours, ref = ours.numpy(), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert (ours[tm < 0] == 0).all()
    if with_duvw and taps > 1:
        # The filter changed the colours where duvw is nonzero.
        center = T.texmap_sample(pack, torch.from_numpy(tm),
                                 torch.from_numpy(uvw)).numpy()
        moved = np.abs(ours - center).max(1) > 1e-3
        assert moved[1::2].mean() > 0.2 and not moved[::2].any()
    # textured_color: colour * texture where there is a map, else colour.
    color = g.uniform(0, 1, (N, 3)).astype(np.float32)
    jc = JT.textured_color(jpack, jnp.asarray(color), jnp.asarray(tm),
                           jnp.asarray(uvw),
                           None if duvw is None else jnp.asarray(duvw),
                           taps=taps)
    tc = T.textured_color(pack, torch.from_numpy(color), torch.from_numpy(tm),
                          torch.from_numpy(uvw),
                          None if duvw is None else torch.from_numpy(duvw),
                          taps=taps)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def _directions(seed, n=N):
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] /= np.linalg.norm(d[: n // 2], axis=1, keepdims=True)
    d[:8] = [[0, 0, 1], [0, 0, -1], [0, 0, 2], [1, 0, 0], [0, -1, 0],
             [1e-30, 0, 0.5], [0, 0, 0], [0.3, 0.3, 1.5]]
    return d


@pytest.mark.parametrize("name", ["textured", "tiny"])
def test_environment_and_background_match_jax(name):
    """environment_uvw, sample_environment and sample_background against
    the JAX package's, on normalised, unnormalised and degenerate
    directions and on seeded pixel uvs; on the untextured tiny scene too
    (constant colours, no texture work)."""
    jpack = jax_scene(name)[0]
    pack = port_pack(name)
    d = _directions(6)
    juvw, jvalid = JT.environment_uvw(jnp.asarray(d))
    uvw, valid = T.environment_uvw(torch.from_numpy(d))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.numpy().any() and not valid.numpy().all()
    np.testing.assert_allclose(uvw.numpy(), np.asarray(juvw), rtol=0,
                               atol=1e-6)
    jc, jv = JT.sample_environment(jpack, jnp.asarray(d))
    c, v = T.sample_environment(pack, torch.from_numpy(d))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    px = np.random.default_rng(7).uniform(0, 1, (N, 3)).astype(np.float32)
    px[:, 2] = 0.0
    jb = JT.sample_background(jpack, jnp.asarray(px))
    b = T.sample_background(pack, torch.from_numpy(px))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    if name == "textured":
        assert c.numpy().std() > 0.01 and b.numpy().std() > 0.01


def test_png_readers_match_jax(tmp_path, monkeypatch):
    """read_png of both repository PNGs equals the JAX reader's (the
    native unfilter; wood.png also without the native helper, through the
    Python loop), and write_png round-trips RGB and grey images."""
    import os

    from bhraytracer_tpu.utils.png import read_png as j_read_png
    from bhraytracer_tpu_torch import native
    from bhraytracer_tpu_torch.scenes import ASSETS
    from bhraytracer_tpu_torch.utils import png

    assert native.get_lib() is not None
    final = os.path.join(ASSETS, "Resource", "BHRTFinal")
    for f in ("china.png", "wood.png"):
        img = png.read_png(os.path.join(final, f))
        assert img.shape == (256, 256, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, j_read_png(os.path.join(final, f)))
    wood = png.read_png(os.path.join(final, "wood.png"))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(png.read_png(os.path.join(final, "wood.png")),
                                  wood)
    monkeypatch.undo()
    g = np.random.default_rng(8)
    for shape in ((17, 23, 3), (9, 5)):
        img = g.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f"img{len(shape)}.png")
        png.write_png(path, img)
        want = img if img.ndim == 3 else np.repeat(img[:, :, None], 3, 2)
        np.testing.assert_array_equal(png.read_png(path), want)
        np.testing.assert_array_equal(j_read_png(path), want)


def test_ppm_reader_matches_jax(tmp_path):
    from bhraytracer_tpu.utils.ppm import read_ppm as j_read_ppm
    from bhraytracer_tpu_torch.utils.ppm import read_ppm

    img = np.random.default_rng(9).integers(0, 256, (7, 11, 3)).astype(np.uint8)
    path = tmp_path / "t.ppm"
    path.write_bytes(b"P6\n# a comment\n11 7\n255\n" + img.tobytes())
    np.testing.assert_array_equal(read_ppm(str(path)), img)
    np.testing.assert_array_equal(j_read_ppm(str(path)), img)


def _hits(seed):
    """The textured scene's camera rays at 64x48 plus seeded rays from
    above the ground: (o, d) numpy, the port's hits and their JAX Hit."""
    from bhraytracer_tpu.ops.trace import Hit as JHit
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.ops import rng
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera
    from bhraytracer_tpu_torch.ops.trace import trace_closest

    pack = port_pack("textured")
    cam = jax_scene("textured")[1]
    ck = rng.prng_key(seed, "cpu")
    o, d, _ = PT._raygen(pack, RenderConfig(), from_scene_camera(cam, "cpu"),
                         64, 48, 64 * 48, 0, ck)
    g = np.random.default_rng(seed)
    o2 = g.uniform([-4, -6, 0.2], [4, 0, 4], (1024, 3)).astype(np.float32)
    t2 = g.uniform([-4, -1, 0], [4, 4, 3], (1024, 3)).astype(np.float32)
    o = torch.cat([o, torch.from_numpy(o2)])
    d = torch.cat([d, torch.from_numpy(t2 - o2)])
    hit = trace_closest(pack, o, d, "front")
    jhit = JHit(*(jnp.asarray(_np(x)) for x in hit))
    return o, d, hit, jhit


def _camera_deltas():
    from bhraytracer_tpu_torch.ops.camera import camera_basis, from_scene_camera

    cam = jax_scene("textured")[1]
    _, dd_x, dd_y = camera_basis(from_scene_camera(cam, "cpu"), 64, 48)
    return dd_x, dd_y


def test_resolve_hit_full_form_matches_jax():
    """Hits on spheres, the plane and both meshes (camera rays and seeded
    ones): p, n, z and mtl, and the texture coordinates uvw and the
    plane's ray differentials duvw to 1e-5;
    the minimal form keeps p, n, z and mtl and zeroes uvw and duvw."""
    from bhraytracer_tpu.ops.trace import resolve_hit as j_resolve
    from bhraytracer_tpu_torch.ops.trace import resolve_hit

    jpack = jax_scene("textured")[0]
    pack = port_pack("textured")
    o, d, hit, jhit = _hits(0)
    dd_x, dd_y = _camera_deltas()
    s = resolve_hit(pack, o, d, hit, dd_x, dd_y)
    js = j_resolve(jpack, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                   jhit, jnp.asarray(dd_x.numpy()), jnp.asarray(dd_y.numpy()),
                   fast_rows=True)
    m = hit.hit.numpy()
    kind = hit.kind.numpy()
    for k in (0, 1, 2):
        assert (m & (kind == k)).sum() > 100, k
    np.testing.assert_array_equal(s.mtl.numpy()[m], np.asarray(js.mtl)[m])
    for a, b in ((s.p, js.p), (s.n, js.n), (s.z, js.z)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(s.uvw.numpy()[m], np.asarray(js.uvw)[m],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.duvw.numpy()[m], np.asarray(js.duvw)[m],
                               rtol=0, atol=1e-5)
    plane = m & (kind == 1)
    assert np.abs(s.duvw.numpy()[plane]).max() > 1e-3
    assert (s.duvw.numpy()[m & (kind != 1)] == 0).all()
    assert s.uvw.numpy()[m].std() > 0.1
    mini = resolve_hit(pack, o, d, hit, minimal=True)
    for a, b in ((mini.p, s.p), (mini.n, s.n), (mini.z, s.z), (mini.mtl, s.mtl)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not mini.uvw.any() and not mini.duvw.any()


@pytest.mark.parametrize("taps,with_map", [(32, True), (1, False)],
                         ids=["taps32-map", "taps1"])
def test_direct_light_matches_jax(taps, with_map):
    """The textured direct term against JAX's _direct_light: at 32 taps
    with a caustic photon map carried across (pmap_from_numpy; photons
    scattered around the hit points, indexed by the JAX package, whose
    gather alone compiles for ~25 s op by op), at 1 tap without one."""
    from bhraytracer_tpu.models import photonmap as JP
    from bhraytracer_tpu.models import pathtracer as JPT
    from bhraytracer_tpu.ops.trace import Surface as JSurface
    from bhraytracer_tpu.ops.trace import resolve_hit as j_resolve
    from bhraytracer_tpu_torch.models import pathtracer as PT
    from bhraytracer_tpu_torch.models.photonmap import pmap_from_numpy
    from bhraytracer_tpu_torch.ops.linalg import dot, normalize
    from bhraytracer_tpu_torch.ops.trace import resolve_hit

    jpack = jax_scene("textured")[0]
    pack = port_pack("textured")
    o, d, hit, jhit = _hits(1)
    dd_x, dd_y = _camera_deltas()
    surf = resolve_hit(pack, o, d, hit, dd_x, dd_y)
    n = o.shape[0]
    g = np.random.default_rng(10 + taps)
    hp = surf.p.numpy()[hit.hit.numpy()]
    pos = (hp[g.integers(0, len(hp), 8192)]
           + g.normal(0, 0.1, (8192, 3))).astype(np.float32)
    dirn = g.normal(size=(8192, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    power = g.uniform(0, 0.01, (8192, 3)).astype(np.float32)
    jpmap = JP.build_grid_index(pos, dirn, power, 0.5) if with_map else None
    pmap = pmap_from_numpy(*(np.asarray(x) for x in jpmap[:5]), *jpmap[5:],
                           device="cpu") if with_map else None
    cfg = RenderConfig(texture_sample_count=taps, photon_gather_max=64)
    jcfg = JConfig(texture_sample_count=taps, photon_gather_max=64)
    mtl = PT._fetch_mtl(pack, surf.mtl)
    vn = surf.n
    vv = normalize(o - surf.p)
    cos_phi1 = torch.clamp(dot(vn, vv), 0.0, 1.0)
    r0 = ((1.0 - mtl.ior) / (1.0 + mtl.ior)) ** 2
    fres = r0 + (1.0 - r0) * torch.pow(1.0 - cos_phi1, 5.0)
    new_spec = torch.clamp_max(mtl.specular + fres[:, None] * mtl.refraction,
                               1.0)
    u = torch.from_numpy(g.uniform(size=(n, 8)).astype(np.float32))
    mask = hit.hit
    diff, spec = PT._surface_colors(pack, cfg, surf, mtl, new_spec)
    out, n_shadow = PT._direct_light(pack, cfg, surf, mtl, new_spec, diff,
                                     spec, vn, vv, u, mask, True, pmap)

    def j(x):
        return jnp.asarray(_np(x))

    jsurf = JSurface(*(j(x) for x in surf))
    jmtl = JPT.Mtl(*(j(x) for x in mtl))
    jout, jn = JPT._direct_light(jpack, jcfg, jsurf, jmtl, j(new_spec), j(vn),
                                 j(vv), j(u), j(mask), pmap=jpmap)
    # The JAX package resolves the same surface (its own full form).
    js = j_resolve(jpack, j(o), j(d), jhit, j(dd_x), j(dd_y), fast_rows=True)
    np.testing.assert_allclose(np.asarray(js.uvw)[mask.numpy()],
                               surf.uvw.numpy()[mask.numpy()], atol=1e-5)
    assert int(n_shadow) == int(jn)
    out, jout = out.numpy(), np.asarray(jout)
    close = np.isclose(out, jout, rtol=1e-4, atol=1e-5).all(1)
    assert close.mean() >= 0.99, close.mean()
    assert out[mask.numpy()].std() > 0.05
    if not with_map:
        # The textures show: the untextured colours give another term.
        plain, _ = PT._direct_light(pack, cfg, surf, mtl, new_spec,
                                    mtl.diffuse, new_spec, vn, vv, u, mask)
        assert np.abs(plain.numpy() - out).max() > 0.1
