"""The port's denoiser (models/denoiser.py) against the JAX package's: the
shipped weights and randomly initialised ones carried across through the
npz layout, three training steps from the same start, the weights' round
trip, and render_image(use_denoiser=True). On the CPU, in float32.

Tolerances: 1e-5 (absolute) on images, 2e-5 on trained parameters
(test_train_matches_jax says why). The convolutions sum
27 * C products in another order on the two sides (XLA's and oneDNN's), so
outputs agree to a few ulps of their magnitude, not bit for bit. The
render's tolerances are tests/test_torch_adaptive.py's (radiance rtol =
atol = 1e-5 for the tiny scene): the denoiser runs on images equal to that.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhraytracer_tpu.config import RenderConfig as JConfig
from bhraytracer_tpu.models import denoiser as JD
from bhraytracer_tpu.models.pathtracer import render_image as j_render
from bhraytracer_tpu_torch.config import RenderConfig
from bhraytracer_tpu_torch.models import denoiser as D
from bhraytracer_tpu_torch.models.pathtracer import render_image
from bhraytracer_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
)
from tests._torch_parity import jax_scene, port_pack

torch.set_num_threads(2)

RENDER = dict(spp=2, gi_bounces=1, extra_refr_levels=1, tir_bounces=4,
              chunk_rays=32 * 24, use_denoiser=True)


@pytest.fixture(scope="module")
def jax_render():
    """The JAX package's denoised 32x24 tiny_scene render, started on first
    use (its compile overlaps the tests before it)."""
    cam = dataclasses.replace(jax_scene("tiny")[1], width=32, height=24)
    with ThreadPoolExecutor(1) as ex:
        yield cam, ex.submit(j_render, jax_scene("tiny")[0], cam,
                             JConfig(**RENDER, fused_levels=False), seed=0,
                             return_aux=True)


def _image(seed, h=29, w=37, c=3):
    g = np.random.default_rng(seed)
    return g.uniform(0, 1, (h, w, c)).astype(np.float32)


def _port_params(model):
    return {f"Conv_{i}/{k}": v.detach().numpy()
            for i, conv in enumerate(model.convs)
            for k, v in (("kernel", conv.weight.permute(2, 3, 1, 0)),
                         ("bias", conv.bias))}


def _jax_params(params):
    return {f"{c}/{k}": np.asarray(v)
            for c, d in params["params"].items() for k, v in d.items()}


def test_shipped_weights_are_the_reference_file():
    import filecmp
    import os

    ref = os.path.join(os.path.dirname(JD.__file__), "denoiser_weights.npz")
    port = os.path.join(os.path.dirname(D.__file__), "denoiser_weights.npz")
    assert filecmp.cmp(ref, port, shallow=False)


def test_pretrained_matches_jax(jax_render):
    """The shipped weights (features (24, 48, 96), albedo + normal aux) on a
    seeded 37x29 image: odd sizes, so _pad4's edge padding is reached."""
    model = D.load_pretrained(device="cpu")
    jmodel, jparams = JD.load_pretrained()
    assert model.aux_channels == jmodel.aux_channels == 6
    assert model.features == tuple(jmodel.features) == (24, 48, 96)
    img, aux = _image(0), _image(1, c=6) * 2.0 - 1.0
    out = D.denoise(model, torch.from_numpy(img), aux=torch.from_numpy(aux))
    ref = np.asarray(JD.denoise(jmodel, jparams, jnp.asarray(img),
                                aux=jnp.asarray(aux)))
    assert out.shape == (29, 37, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert np.abs(ref - img).max() > 1e-2  # the net changed the image


def test_random_weights_carried_across(tmp_path):
    """Colour-only weights of a fresh JAX model, written by the JAX
    package's save_weights and read by the port's load_weights; and the
    port's own init, carried the other way."""
    jmodel, jparams = JD.init_denoiser(jax.random.PRNGKey(3))
    path = str(tmp_path / "w.npz")
    JD.save_weights(jparams, path)
    model = D.load_weights(path, "cpu")
    assert model.aux_channels == 0 and model.features == (16, 32, 64)
    img = _image(2, 21, 26)
    out = D.denoise(model, img).numpy()
    ref = np.asarray(JD.denoise(jmodel, jparams, jnp.asarray(img)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)

    mine = D.init_denoiser(torch.Generator().manual_seed(0))
    D.save_weights(mine, path)
    jm, jp = JD.load_weights(path)
    np.testing.assert_allclose(
        np.asarray(JD.denoise(jm, jp, jnp.asarray(img))),
        D.denoise(mine, img).numpy(), rtol=0, atol=1e-5)


def test_init_denoiser():
    """flax's nn.Conv init: lecun_normal kernels (truncated at 2 sigma,
    variance 1 / fan_in), zero biases; seeded by the generator."""
    a = D.init_denoiser(torch.Generator().manual_seed(0), aux_channels=6)
    b = D.init_denoiser(torch.Generator().manual_seed(0), aux_channels=6)
    c = D.init_denoiser(torch.Generator().manual_seed(1), aux_channels=6)
    for ca, cb, cc in zip(a.convs, b.convs, c.convs):
        assert torch.equal(ca.weight, cb.weight)
        assert not torch.equal(ca.weight, cc.weight)
        assert not ca.bias.any()
        fan_in = ca.in_channels * 9
        assert ca.weight.abs().max() <= 2.0 / 0.87962566 * fan_in ** -0.5
    w = a.convs[1].weight  # 24 x 16 x 9 = 3,456 draws
    assert abs(float(w.var()) * 16 * 9 - 1.0) < 0.1
    assert a.convs[0].in_channels == 9 and a.convs[-1].out_channels == 3


def test_train_matches_jax():
    """Three Adam steps (lr 1e-3) on the same pairs, batches and per-pair
    weights, from the same parameters: the losses within rtol 1e-5, every
    parameter within 2e-5. Adam divides a gradient by its own size plus
    eps (1e-8): where a dead ReLU gives a gradient of exactly 0 on one side
    and a rounding residue (~1e-10) on the other, the first step already
    moves that parameter by lr * 1e-10 / eps, 1e-5. Measured: 1.02e-5 on
    one of the 70,195 parameters, every other one within 2.1e-6."""
    g = np.random.default_rng(5)
    clean = g.uniform(0, 1, (3, 10, 14, 3)).astype(np.float32)
    noisy = (clean + g.normal(0, 0.2, clean.shape)).astype(np.float32)
    weights = np.array([0.5, 1.0, 1.5], np.float32)
    jmodel, jparams = JD.init_denoiser(jax.random.PRNGKey(4))
    jp2, jlosses = JD.train_denoiser(jmodel, jparams, noisy, clean, steps=3,
                                     batch=2, seed=9, weights=weights)
    model = D.DenoiserUNet()
    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            p = jparams["params"][f"Conv_{i}"]
            conv.weight.copy_(torch.from_numpy(
                np.asarray(p["kernel"])).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    losses = D.train_denoiser(model, noisy, clean, steps=3, batch=2, seed=9,
                              weights=weights)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    mine, ref = _port_params(model), _jax_params(jp2)
    assert mine.keys() == ref.keys()
    moved = 0.0
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=2e-5,
                                   err_msg=k)
        moved = max(moved, float(np.abs(ref[k] - _jax_params(jparams)[k]).max()))
    assert moved > 1e-4  # three steps moved the parameters


def test_weights_round_trip(tmp_path):
    model = D.init_denoiser(torch.Generator().manual_seed(2), aux_channels=6,
                            features=(8, 16, 24))
    path = str(tmp_path / "w.npz")
    D.save_weights(model, path)
    back = D.load_weights(path, "cpu")
    assert (back.features, back.aux_channels) == ((8, 16, 24), 6)
    for a, b in zip(model.convs, back.convs):
        assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    data = np.load(path)
    assert data["params/Conv_0/kernel"].shape == (3, 3, 9, 8)
    assert int(data["__aux_channels__"]) == 6


def test_train_state_round_trip(tmp_path):
    model = D.init_denoiser(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.rand(1, 8, 8, 3)
    model(x).square().mean().backward()
    opt.step()
    params = dict(model.named_parameters())
    path = str(tmp_path / "train")
    assert load_train_state(path) is None
    save_train_state(path, params, opt.state_dict())
    p2, st2 = load_train_state(path)
    assert p2.keys() == params.keys()
    for k, v in params.items():
        assert torch.equal(p2[k], v.detach())
    ref = opt.state_dict()
    assert st2["param_groups"] == ref["param_groups"]
    for i, st in ref["state"].items():
        for k, v in st.items():
            assert torch.equal(st2["state"][i][k], v), (i, k)
    opt2 = torch.optim.Adam(model.parameters(), lr=1e-3)
    opt2.load_state_dict(st2)  # an optimizer takes it back
    save_train_state(path, params)
    assert load_train_state(path)[1] is None


def test_denoise_refuses_another_device():
    model = D.DenoiserUNet()
    with pytest.raises(ValueError):
        D.denoise(model, torch.zeros((8, 8, 3), device="meta"))


def test_render_denoised_matches_jax(jax_render):
    cam, fut = jax_render
    pack = port_pack("tiny")
    img, aux = render_image(pack, cam, RenderConfig(**RENDER), seed=0,
                            return_aux=True)
    jimg, jaux = fut.result(timeout=900)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(aux["albedo"], jaux["albedo"])
    plain = render_image(pack, cam, RenderConfig(
        **dict(RENDER, use_denoiser=False)), seed=0)
    assert np.abs(img.numpy() - plain.numpy()).max() > 1e-2
    # The same model passed in: the same image.
    again = render_image(pack, cam, RenderConfig(**RENDER), seed=0,
                         denoiser=D.load_pretrained(device="cpu"))
    np.testing.assert_array_equal(again.numpy(), img.numpy())


def test_render_training_pairs():
    pack = port_pack("tiny")
    cam = dataclasses.replace(jax_scene("tiny")[1], width=8, height=4)
    cfg = RenderConfig(gi_bounces=0, extra_refr_levels=0, tir_bounces=2,
                       chunk_rays=32)
    noisy, clean = D.render_training_pairs(pack, cam, cfg, n_pairs=2,
                                           noisy_spp=1, clean_spp=2,
                                           with_aux=True)
    assert noisy.shape == (2, 4, 8, 9) and clean.shape == (2, 4, 8, 3)
    assert np.isfinite(noisy).all() and np.isfinite(clean).all()
    assert not np.array_equal(noisy[0, ..., :3], noisy[1, ..., :3])
