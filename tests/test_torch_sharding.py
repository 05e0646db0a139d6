"""Data parallelism of the port (parallel/sharding.py) over gloo worlds on
the CPU, against the JAX package on conftest's virtual CPU mesh, with
tests/test_sharding.py's tiny scene and config.

The module's first test starts, side by side: the JAX side in one child
process (tests/_torch_sharding_jax.py: render_radiance_sharded on
make_mesh(2) and make_mesh(4), render_image_distributed on make_mesh(2),
and train_step_sharded on make_mesh(2)), and one world of 2 and one of 4
ranks of the port (tests/_torch_dist_ranks.py, one process a rank, each
world at a file:// rendezvous in its own tmp dir). Each rank runs every
port-side check and writes what it saw; rank 0 also what one process
gets.

The port's sharded render keys shard r by fold_in(key, r*shard), as the
JAX shard_map body does, and its RNG is bit-equal to JAX's, so lanes pair
up one to one. Its sharded train step renders each rank's lanes in the
lane frame of the whole chunk keyed by `key`, so at any world size it is
the one-process step, as JAX's one global program is. Tolerances:
  - sharded radiance rtol = atol = 1e-5 (the ROADMAP standard);
  - the distributed image: tests/test_torch_render.py's tiny-scene bound,
    at least 99.9% of pixels within 1e-4;
  - gradients |g_port - g_jax| <= 1e-3 max|g_jax| + 1e-9
    (tests/test_torch_gradients.py:_close_grad), the loss rtol 1e-5;
    against JAX's step, plus what JAX's step and its one-device
    value_and_grad differ by, and for the camera 1e-3 of its lane mass
    (test_train_step_grads_match_jax says why);
  - a sharded step against one process's: the loss rtol 1e-5, the
    gradients within _close_grad; drop and segment counts equal;
  - what the ranks hold in common (gathered radiance, images, reduced
    gradients) is equal bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.ops import rng
from bhraytracer_tpu_torch.ops.camera import from_scene_camera
from bhraytracer_tpu_torch.parallel import sharding as S
from bhraytracer_tpu_torch.parallel.multihost import shutdown
from bhraytracer_tpu_torch.scenes import tiny_scene
from tests import _torch_sharding_jax as J
from tests._torch_dist_ranks import CAMERA, LR
from tests.test_torch_gradients import _close_grad

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = J.WORLDS


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Start the JAX child and the port's worlds with the module's first
    test; the fixture gives "jax" -> the JAX side's arrays and n -> the
    list of world n's ranks' arrays (waiting for their processes)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    jax_out = str(tmp_path_factory.mktemp("jax_sharding") / "jax.npz")
    procs["jax"] = ([subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_sharding_jax.py"), jax_out],
        env=env, cwd=REPO)], [jax_out])
    for n in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{n}")
        procs[n] = ([subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "_torch_dist_ranks.py"),
             str(r), str(n), str(tmp / "init"), str(tmp)], env=env,
            cwd=REPO) for r in range(n)],
            [str(tmp / f"rank{r}.npz") for r in range(n)])

    def result(name):
        ps, paths = procs[name]
        codes = [p.wait(timeout=600) for p in ps]
        assert codes == [0] * len(ps), f"{name}: exit codes {codes}"
        out = []
        for path in paths:
            with np.load(path) as z:
                out.append({k: z[k] for k in z.files})
        return out[0] if name == "jax" else out

    yield result
    for ps, _ in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


def _tol(ref):
    return 1e-5 + 1e-5 * np.abs(ref)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_forward_matches_jax(runs, n):
    """render_radiance_sharded over n gloo ranks against JAX's on
    make_mesh(n), lane for lane at rtol = atol = 1e-5; every rank holds
    the same gathered radiance.

    The port is held to what JAX's shard_map body computes (JAX's
    _render_chunk of each shard keyed fold_in(key, r*shard), jitted on one
    device) on every lane. JAX's shard_map program itself differs from
    that composition on a few lanes by more than 1e-5 (XLA compiles the
    body inside shard_map otherwise: at most 1.5e-5 on this config, two
    lanes of 512); against JAX's sharded radiance each lane's bound is
    1e-5 plus that lane's own JAX-side difference, which is within 1e-5
    on at least 99% of lanes and below 1e-4 on all."""
    ranks, jx = runs(n), runs("jax")
    ref, single = jx[f"rad/{n}"], jx[f"single/{n}"]
    rad = ranks[0]["rad"]
    assert rad.shape == ref.shape == single.shape == (J.LANES, 3)
    assert (np.abs(rad - single) <= _tol(single)).all()
    jax_self = np.abs(ref - single)
    assert (jax_self <= _tol(single)).all(-1).mean() >= 0.99
    assert jax_self.max() < 1e-4
    assert (np.abs(rad - ref) <= _tol(ref) + jax_self).all()
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["rad"], rad)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_forward_deterministic(runs, n):
    """Call to call, the same lanes and key give the same bits."""
    for r in runs(n):
        np.testing.assert_array_equal(r["rad"], r["rad_again"])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_streams_decorrelated(runs, n):
    """Every shard gets the same pixels (test_sharding.py:78-94): without
    the lane-offset key fold all shards would repeat shard 0's stream."""
    shards = runs(n)[0]["rad_tiled"].reshape(n, J.LANES // n, 3)
    for i in range(1, n):
        assert not np.array_equal(shards[0], shards[i]), i


@pytest.mark.parametrize("n", WORLDS)
def test_each_rank_renders_local_shapes(runs, n):
    """Each rank's _render_chunk sees its shard's lanes alone, once a call
    (test_sharding.py:97-114)."""
    for r in runs(n):
        assert r["local_shapes"].tolist() == [[J.LANES // n]]


def test_render_image_distributed_matches_jax(runs):
    """render_image_distributed over 2 ranks (one chunk padded by a lane,
    two samples) against JAX's on make_mesh(2): the same image on both
    ranks, a tensor as render_image returns, and the JAX image within the
    tiny-scene tolerance."""
    ranks, ref = runs(2), runs("jax")["image"]
    w, h = J.IMAGE_SIZE
    img = ranks[0]["image"]
    assert ranks[0]["image_is_tensor"]
    assert img.shape == ref.shape == (h, w, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(ranks[1]["image"], img)
    np.testing.assert_array_equal(ranks[1]["image_stats"],
                                  ranks[0]["image_stats"])
    within = float((np.abs(img - ref).max(-1) <= 1e-4).mean())
    assert within >= 0.999, within
    assert ranks[0]["image_stats"][3] > 0  # segments


def _held(g, ref, extra=0.0):
    """|g - ref| <= 1e-3 max|ref| + 1e-9 + extra, element by element
    (_close_grad with a per-element term)."""
    lim = 1e-3 * float(np.abs(ref).max(initial=0.0)) + 1e-9 + extra
    assert (np.abs(g - ref) <= lim).all(), float(
        np.max(np.abs(g - ref) - lim))


def test_train_step_grads_match_jax(runs):
    """The loss and the all-reduced gradients of a sharded step over 2
    ranks against JAX's train_step_sharded on make_mesh(2), one global
    program keyed by `key`, and against JAX's one-device value_and_grad of
    the same loss (`vg_*`, the same function compiled as another program).

    Against the value_and_grad: the loss at rtol 1e-5, each gradient
    within _close_grad, the camera's with 1e-3 of its lane mass added
    (below). Against the step: the same bounds plus the step's own
    difference from the value_and_grad, element by element: JAX's two
    programs differ on one lane of 512, where a Monte Carlo decision takes
    the other branch (the step's loss 2.3e-5 of itself above the other's,
    its camera gradients 1.6-1.8% of max|g| apart).

    The lane mass (tests/_torch_dist_ranks.py:camera_mass) is
    sum_i |d l_i / d theta| / (3N), the terms the camera gradient sums
    before they cancel. Lane 275 meets the sphere at cos 0.075, where the
    hit point's derivative grows as 1/cos: its d l / d cam_pos is 16.2,
    1,800x the net cam_pos gradient, and the two packages round its
    sphere quadratic apart (XLA contracts multiply-adds), agreeing on that
    term to 1.1e-3 of itself. The camera gradients are held to that
    relative error of their terms; the tables' gradients have no such
    lanes and keep _close_grad."""
    ranks, ref = runs(2), runs("jax")
    g0 = ranks[0]
    loss, step, vg = (float(x) for x in (g0["loss"], ref["loss"],
                                         ref["vg_loss"]))
    assert abs(loss - vg) <= 1e-5 * abs(vg), (loss, vg)
    assert abs(loss - step) <= 1e-5 * abs(step) + abs(step - vg), (loss,
                                                                   step)
    keys = [k[len("grad/"):] for k in ref if k.startswith("grad/")]
    assert keys and {f"grad/{k}" for k in keys} == {
        k for k in g0 if k.startswith("grad/")}
    assert set(CAMERA) <= set(keys)
    for k in keys:
        np.testing.assert_array_equal(g0[f"param/{k}"], ref[f"param/{k}"])
        g, g_step = g0[f"grad/{k}"], ref[f"grad/{k}"]
        g_vg = ref[f"vg_grad/{k}"]
        mass = 1e-3 * g0[f"camera_mass/{k}"] if k in CAMERA else 0.0
        _held(g, g_vg, mass)
        _held(g, g_step, mass + np.abs(g_step - g_vg))
        np.testing.assert_array_equal(ranks[1][f"grad/{k}"], g)


def test_train_step_applies_sgd(runs):
    """train_step_sharded: params - lr * the reduced gradients on every
    rank, the loss loss_and_grads_sharded's, opt_state passed through."""
    for r in runs(2):
        assert r["state_passed"]
        np.testing.assert_array_equal(r["loss_step"], r["loss"])
        for k in (k[len("grad/"):] for k in r if k.startswith("grad/")):
            np.testing.assert_array_equal(
                r[f"new/{k}"], r[f"param/{k}"] - np.float32(LR)
                * r[f"grad/{k}"])


def test_train_step_reduces_loss(runs):
    """Five sharded SGD steps toward a half-bright target cut the loss by
    at least 10% (test_sharding.py:143-163)."""
    losses = runs(2)[0]["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_step_is_world_invariant(runs, n):
    """The loss and the reduced gradients of loss_and_grads_sharded over n
    ranks equal one process's loss_and_grads of all the lanes up to the
    order of float sums (loss rtol 1e-5, _close_grad), and every rank
    holds the same bits. One process's values come from rank 0 of the
    world of 2."""
    ranks, single = runs(n), runs(2)[0]
    one = ranks[0]
    np.testing.assert_allclose(one["loss"], single["single_loss"],
                               rtol=1e-5)
    keys = [k[len("grad/"):] for k in one if k.startswith("grad/")]
    assert keys and {f"single_grad/{k}" for k in keys} == {
        k for k in single if k.startswith("single_grad/")}
    for k in keys:
        _close_grad(one[f"grad/{k}"], single[f"single_grad/{k}"])
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"grad/{k}"], one[f"grad/{k}"])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["loss"], one["loss"])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_drops_match_one_process(runs, n):
    """DROP_CFG drops refraction and GI lanes over three levels; rendered
    over n ranks in the lane frame of all its lanes, the ranks' drop and
    segment counts sum to one process's, and their radiance is one
    process's at rtol = atol = 1e-5 (one process: rank 0 of the world of
    2)."""
    ranks, one = runs(n), runs(2)[0]
    single = one["drop_single_stats"]
    assert single[0] > 0 and single[2] > 0, single  # drop_refr, drop_gi
    got = sum(r["drop_stats"] for r in ranks)
    np.testing.assert_array_equal(got, single)
    rad = np.concatenate([r["drop_rad"] for r in ranks])
    ref = one["drop_single_rad"]
    assert rad.shape == ref.shape == (J.DROP_LANES, 3)
    assert (np.abs(rad - ref) <= _tol(ref)).all()


@pytest.mark.parametrize("n", WORLDS)
def test_make_mesh_takes_the_world(runs, n):
    """In a world of n, make_mesh() spans n ranks and make_mesh(n + 1)
    raises, lanes that do not split over the ranks raise (the JAX
    assert), and the ranks imported no JAX."""
    for r in runs(n):
        assert r["mesh_size"] == n and r["mesh_refused"]
        assert r["split_refused"]
        assert not r["jax_imported"]


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    mesh = S.make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        shutdown()


def test_world_of_one_is_one_shard(world_of_one):
    """make_mesh() without a group starts a world of one: the sharded
    render is _render_chunk of all lanes keyed fold_in(key, 0), bit for
    bit."""
    mesh = world_of_one
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("dp",)
    pack, cam = tiny_scene("cpu")
    cfg = RenderConfig(**dict(J.CFG, differentiable=False))
    cam_p = from_scene_camera(cam, "cpu")
    px, py = (torch.from_numpy(a.astype(np.int64))
              for a in J.lanes(cam.width, cam.height, 64))
    key = rng.prng_key(J.KEY)
    rad = S.render_radiance_sharded(pack, cfg, cam_p, cam.width, cam.height,
                                    px, py, key, mesh)
    ref, _, _ = S._render_chunk(pack, cfg, cam_p, cam.width, cam.height, px,
                                py, rng.fold_in(key, 0))
    assert torch.equal(rad, ref)


def test_world_of_one_frame_is_no_frame(world_of_one):
    """In a world of one, _render_chunk in lane_frame's frame is
    _render_chunk without one, bit for bit, on DROP_CFG, whose levels
    drop lanes in each compaction."""
    mesh = world_of_one
    pack, cam = tiny_scene("cpu")
    cfg = RenderConfig(**J.DROP_CFG)
    cam_p = from_scene_camera(cam, "cpu")
    px, py = (torch.from_numpy(a.astype(np.int64))
              for a in J.lanes(cam.width, cam.height, J.DROP_LANES))
    key = rng.prng_key(J.DROP_KEY)
    with torch.no_grad():
        ref = S._render_chunk(pack, cfg, cam_p, cam.width, cam.height, px,
                              py, key)
        got = S._render_chunk(pack, cfg, cam_p, cam.width, cam.height, px,
                              py, key,
                              frame=S.lane_frame(mesh, J.DROP_LANES, "cpu"))
    assert ref[2].drop_refr > 0 and ref[2].drop_gi > 0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert [int(x) for x in got[2]] == [int(x) for x in ref[2]]


def test_make_mesh_rejects_other_sizes():
    """make_mesh(n) with n other than the world size raises, and starts no
    group."""
    with pytest.raises(ValueError):
        S.make_mesh(2, device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("reorder", [False, True])
def test_zero_length_batches(reorder):
    """A rank left with no lanes at a level traces and shades zero-length
    batches: every trace route (analytic on the tiny scene; BVH, or the
    flat stream with reorder, on the bench scene) and the shade setup
    return empty results."""
    from bhraytracer_tpu_torch.ops.shade import shade_setup
    from bhraytracer_tpu_torch.ops.trace import (
        trace_closest,
        trace_route,
        trace_shadow,
    )
    from bhraytracer_tpu_torch.scenes import bench_scene

    cfg = RenderConfig(**J.CFG)
    o = torch.zeros((0, 3))
    for pack in (tiny_scene("cpu")[0], bench_scene("cpu")[0]):
        hit = trace_closest(pack, o, o, "both", reorder=reorder)
        assert hit.t.shape == hit.inst.shape == (0,)
        occ = trace_shadow(pack, o, o, torch.zeros(0), cfg.shadow_bias,
                           reorder=reorder)
        assert occ.shape == (0,) and occ.dtype == torch.bool
        if trace_route(pack, reorder) != "analytic":
            fo = shade_setup(pack, cfg, o, o, hit, hit.hit, torch.zeros(0, 13))
            assert fo.p.shape == (0, 3) and fo.gate.shape == (0,)
