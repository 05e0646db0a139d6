"""The port's scene compiler and pack against the JAX package's: every
field both packs share is array-equal on the slice's two scenes, and
pack_from_numpy carries the JAX pack across unchanged."""

import numpy as np
import pytest
import torch

from bhraytracer_tpu_torch.scene.pack import _DATA, _META
from bhraytracer_tpu_torch.scenes import bench_scene, tiny_scene
from tests._torch_parity import jax_scene, port_pack

torch.set_num_threads(2)

PORT_SCENES = {"tiny": tiny_scene, "bench": bench_scene}


@pytest.mark.parametrize("name", ["tiny", "bench"])
def test_compile_scene_matches_jax(name):
    jpack, jcam = jax_scene(name)
    pack, cam = PORT_SCENES[name]()
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
    pack, _ = PORT_SCENES[name]()
    carried = port_pack(name)
    for k in _DATA + ("stream_rows",):
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
