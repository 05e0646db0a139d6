"""The port's scene compiler and pack against the JAX package's: every
field both packs share is array-equal on the port's scenes, pack_from_numpy
carries the JAX pack across unchanged, and the BVH kernels' tables equal
the JAX packet kernel's single-shot tables, with or without treelets."""

import numpy as np
import pytest
import torch

from bhraytracer_tpu_torch.scene.pack import _DATA, _META
from bhraytracer_tpu_torch.scenes import bench_scene, bigmesh_scene, tiny_scene
from tests._torch_parity import jax_scene, pack_dict, port_pack, teapot_desc

torch.set_num_threads(2)

PORT_SCENES = {"tiny": tiny_scene, "bench": bench_scene,
               "bigmesh": bigmesh_scene}


@pytest.mark.parametrize("name", ["tiny", "bench", "bigmesh"])
def test_compile_scene_matches_jax(name):
    jpack, jcam = jax_scene(name)
    pack, cam = PORT_SCENES[name](device="cpu")
    for k in _DATA:
        a, b = np.asarray(getattr(jpack, k)), getattr(pack, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in _META:
        assert getattr(pack, k) == getattr(jpack, k), k
    for k in ("pos", "dir", "up"):
        np.testing.assert_array_equal(getattr(cam, k), getattr(jcam, k))
    assert (cam.fov, cam.width, cam.height) == (jcam.fov, jcam.width, jcam.height)


@pytest.mark.parametrize("name", ["tiny", "bench"])
def test_pack_from_numpy_round_trip(name):
    pack, _ = PORT_SCENES[name](device="cpu")
    carried = port_pack(name)
    for k in _DATA + ("stream_rows", "bvh_pairs", "bvh_faces"):
        np.testing.assert_array_equal(getattr(carried, k).numpy(),
                                      getattr(pack, k).numpy(), err_msg=k)
    for k in _META:
        assert getattr(carried, k) == getattr(pack, k), k


@pytest.mark.parametrize("name", ["tiny", "bench"])
def test_stream_rows_match_jax_table(name):
    """The stream rows against the JAX kernel's own table
    (pallas_stream._stream_table). XLA on the CPU contracts a*b+c into
    fused multiply-adds, which round once where the port rounds twice, so
    the rows agree to a few float32 ulps, not bit for bit."""
    from bhraytracer_tpu.ops.pallas_stream import _stream_table

    jpack, _ = jax_scene(name)
    rows = np.asarray(_stream_table(jpack))
    ours = port_pack(name).stream_rows.numpy()
    assert ours.shape == rows.shape
    np.testing.assert_allclose(ours, rows, rtol=1e-5, atol=1e-6)


def test_bvh_tables_match_jax_pallas_tables():
    """The BVH kernels' tables against the JAX packet kernel's
    pallas_nodes / pallas_faces on the bench pack (no treelets): bvh_pairs
    (after its pad row) holds each node's bounds and, as its entry code,
    the node's left (inner) or leaf_code(left, count) (leaf), taken from
    pallas_nodes[:, :8]; bvh_faces[:, :14] (vertices, normal, n.v0, 1/|n|)
    equals pallas_faces[:, :14]. Both sides are computed in numpy with the
    same formulas."""
    from bhraytracer_tpu_torch.ops.bvh import leaf_code

    jpack, _ = jax_scene("bench")
    assert not jpack.treelets
    pack = port_pack("bench")
    jnodes = np.asarray(jpack.pallas_nodes)
    pairs = pack.bvh_pairs.numpy()
    assert pairs.shape == (jnodes.shape[0] + 1, 8)
    np.testing.assert_array_equal(pairs[1:, :6], jnodes[:, :6])
    left = jnodes[:, 6].astype(np.int64)
    count = jnodes[:, 7].astype(np.int64)
    inner = count == 0
    assert inner.any() and (~inner).any()
    code = np.where(inner, left, leaf_code(left, count)).astype(np.int32)
    np.testing.assert_array_equal(pairs[1:, 6].view(np.int32), code)
    np.testing.assert_array_equal(pack.bvh_faces[:, :14].numpy(),
                                  np.asarray(jpack.pallas_faces)[:, :14])


def test_bvh_tables_ignore_treelets():
    """A JAX pack compiled with a small VMEM row budget carries per-treelet
    padded tables; the port rebuilds its tables from the tree and the world
    triangles in global face order, so they equal the bench pack's."""
    from bhraytracer_tpu.scene.compile import compile_scene as j_compile
    from bhraytracer_tpu_torch.scene.pack import pack_from_numpy

    jpack = j_compile(teapot_desc("teapot.obj"), pallas_budget_rows=512)
    assert len(jpack.treelets) > 1
    ours = pack_from_numpy(pack_dict(jpack), device="cpu")
    ref = port_pack("bench")
    for k in ("bvh_pairs", "bvh_faces", "stream_rows"):
        np.testing.assert_array_equal(getattr(ours, k).numpy(),
                                      getattr(ref, k).numpy(), err_msg=k)


def test_scenes_default_to_the_card():
    """With no device the scenes are built on the card; where there is
    none, asking for the default raises instead of taking the CPU."""
    if torch.cuda.is_available():
        pack, _ = tiny_scene()
        assert pack.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tiny_scene()
    assert tiny_scene(device="cpu")[0].device.type == "cpu"


def test_camera_and_weights_default_to_the_card(tmp_path):
    """from_scene_camera and the denoiser's load_weights take the card by
    default too, as the scenes do, and raise without one."""
    from bhraytracer_tpu_torch.models import denoiser as D
    from bhraytracer_tpu_torch.ops.camera import from_scene_camera

    _, cam = tiny_scene(device="cpu")
    path = str(tmp_path / "w.npz")
    D.save_weights(D.init_denoiser(torch.Generator().manual_seed(0)), path)
    if torch.cuda.is_available():
        assert from_scene_camera(cam).pos.device.type == "cuda"
        assert next(D.load_weights(path).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            from_scene_camera(cam)
        with pytest.raises(RuntimeError, match="CUDA"):
            D.load_weights(path)
    assert from_scene_camera(cam, "cpu").pos.device.type == "cpu"
    assert next(D.load_weights(path, "cpu").parameters()).device.type == "cpu"
