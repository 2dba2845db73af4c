"""NIF subsystem tests: H5 round-trip, encode/decode parity vs numpy,
training convergence, and the escaped-ray environment-light wiring."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu.nif.hdf5 import load_keras_h5, save_keras_h5, NifWeights, DenseLayer
from ipu_ray_lib_tpu.nif.metadata import NifMetadata
from ipu_ray_lib_tpu.nif.model import (
    NifModel,
    direction_to_equirect_uv,
    load_nif_env,
)
from ipu_ray_lib_tpu.nif.train import make_nif, save_nif_assets, train_nif


def test_reference_metadata_parses():
    meta = NifMetadata.load(
        "assets/nif/urban_alley_01_4k_fp16_yuv/assets.extra/nif_metadata.txt"
    )
    assert meta.embedding_dimension == 12
    assert meta.hidden_size == 320
    assert meta.log_tone_map
    assert meta.image_shape == [2048, 4096, 3]
    # eps folded into the mean:
    assert meta.mean[0] == pytest.approx(-2.3514461517333984 - 1e-8)


def test_h5_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    layers = [
        DenseLayer("dense_0", "relu", rng.normal(size=(48, 32)).astype(np.float16),
                   rng.normal(size=32).astype(np.float16), "float16"),
        DenseLayer("dense_1", "linear", rng.normal(size=(80, 3)).astype(np.float16),
                   rng.normal(size=3).astype(np.float16), "float16"),
    ]
    path = str(tmp_path / "m.h5")
    save_keras_h5(path, NifWeights(layers=layers), embedding_dimension=12)
    loaded = load_keras_h5(path)
    assert len(loaded.layers) == 2
    np.testing.assert_array_equal(loaded.layers[0].kernel, layers[0].kernel)
    np.testing.assert_array_equal(loaded.layers[1].bias, layers[1].bias)
    assert loaded.layers[0].activation == "relu"
    assert loaded.layers[1].activation == "none"


def test_apply_matches_numpy():
    """The jitted MLP must equal a straightforward numpy evaluation —
    validates fourier encoding, skip concat, and decode."""
    key = jax.random.PRNGKey(3)
    model = make_nif(key, embedding_dimension=4, layer_count=3, layer_size=16)
    uv = np.random.default_rng(0).uniform(0, 1, (32, 2)).astype(np.float32)

    out = np.asarray(NifModel.apply(model.config, model.params, jnp.asarray(uv)))

    # numpy re-implementation:
    E = 4
    coeffs = 2.0 ** np.arange(E)
    uvn = 2.0 * (uv - 1.0)
    pu = uvn[:, :1] * coeffs
    pv = uvn[:, 1:2] * coeffs
    feats = np.concatenate([np.sin(pu), np.sin(pv), np.cos(pu), np.cos(pv)], axis=-1)
    x = feats
    for i, (k, b) in enumerate(zip(model.params["kernels"], model.params["biases"])):
        if model.config.concat_before[i]:
            x = np.concatenate([x, feats], axis=-1)
        x = x @ np.asarray(k) + np.asarray(b)
        if model.config.activations[i] == "relu":
            x = np.maximum(x, 0)
    x = x * float(model.params["max"]) + np.asarray(model.params["mean"])
    x = np.exp(x)
    np.testing.assert_allclose(out, x, rtol=2e-4, atol=2e-5)


def test_equirect_uv():
    dirs = np.array(
        [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1]], np.float32
    )
    uv = np.asarray(direction_to_equirect_uv(jnp.asarray(dirs), 0.0))
    assert uv[0, 0] == pytest.approx(0.0, abs=1e-6)      # up
    assert uv[1, 0] == pytest.approx(1.0, abs=1e-6)      # down
    assert uv[2, 1] == pytest.approx(0.0, abs=1e-6)      # +x azimuth 0
    assert uv[3, 1] == pytest.approx(0.5, abs=1e-6)      # -x azimuth pi
    assert uv[4, 1] == pytest.approx(0.25, abs=1e-6)     # +z azimuth pi/2
    assert np.all((uv >= 0) & (uv <= 1))


def test_train_and_reload_small_nif(tmp_path):
    """Train a tiny NIF on a synthetic HDR gradient and verify both direct
    reconstruction and the assets round-trip through H5."""
    h, w = 16, 32
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.stack(
        [1.0 + np.sin(cc / w * 6.28), 0.5 + 0.5 * rr / h, 2.0 * cc / w], axis=-1
    ).astype(np.float32) + 0.05

    model, meta = train_nif(
        img, embedding_dimension=4, layer_count=3, layer_size=32,
        steps=600, batch_size=512, learning_rate=3e-3, seed=1,
    )
    recon_bgr = model.reconstruct_image(h, w)
    err = np.abs(recon_bgr[..., ::-1] - img).mean()
    assert err < 0.15, f"NIF training failed to fit: mean abs err {err}"

    out_dir = str(tmp_path / "nif_assets")
    save_nif_assets(model, meta, out_dir)
    env_fn, env_params = load_nif_env(out_dir, rotation_degrees=0.0)
    dirs = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb = np.asarray(env_fn(env_params, jnp.asarray(dirs)))
    assert rgb.shape == (64, 3)
    assert np.all(np.isfinite(rgb))
    assert np.all(rgb > 0)  # exp decode => positive radiance

    # The env lookup must agree with direct bilinear-free sampling of the
    # reconstructed image at the same uv (loose: fp16 weights + bf16 matmul):
    uv = np.asarray(direction_to_equirect_uv(jnp.asarray(dirs), 0.0))
    ri = np.clip((uv[:, 0] * h).astype(int), 0, h - 1)
    ci = np.clip((uv[:, 1] * w).astype(int), 0, w - 1)
    ref = recon_bgr[ri, ci][:, ::-1]
    assert np.median(np.abs(rgb - ref) / (ref + 0.1)) < 0.35


def test_path_trace_with_env_light(tmp_path):
    """Spheres scene + trained NIF env: escaped rays must pick up light."""
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_primitive_scene

    img = np.full((8, 16, 3), 0.8, np.float32)
    model, meta = train_nif(
        img, embedding_dimension=2, layer_count=2, layer_size=8,
        steps=300, batch_size=128, seed=2,
    )
    out_dir = str(tmp_path / "flat_env")
    save_nif_assets(model, meta, out_dir)
    env_fn, env_params = load_nif_env(out_dir)

    scene = make_primitive_scene()
    arrays, params, _ = build_scene(
        scene, image_width=16, image_height=16, samples_per_pixel=4,
        max_path_length=4,
    )
    out = render(
        arrays, params, mode="path-trace", chunk_size=256,
        env_fn=env_fn, env_params=env_params,
    )
    assert np.all(np.isfinite(out.rgb))
    # With a bright uniform env, the image must be clearly lit:
    assert out.rgb.mean() > 0.1
