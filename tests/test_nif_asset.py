"""Shipped reference-class NIF asset: loads, matches the reference
architecture, and reconstructs its training HDRI.

The reference's flagship NIF is urban_alley_01_4k (6 x 320, embedding
12, fp16, log tone map — ref assets/nif/.../nif_metadata.txt,
README.md:99); it ships metadata but no weights. This repo ships a
trained equivalent (assets/nif/synthetic_urban_4k, trained by
examples/train_reference_nif.py on the deterministic synthetic 4k HDRI),
so the NIF benchmarks run the same compute as the reference's demo.
Each asset directory holds the Keras ``model.h5`` and its NumPy twin
``weights.npz``; the renderer reads the npz.
"""

import os

import numpy as np
import pytest

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "nif",
                     "synthetic_urban_4k")



def test_asset_matches_reference_architecture():
    from ipu_ray_lib_tpu.nif.hdf5 import load_keras_h5
    from ipu_ray_lib_tpu.nif.metadata import NifMetadata

    meta = NifMetadata.load(os.path.join(ASSET, "nif_metadata.txt"))
    assert meta.embedding_dimension == 12
    assert meta.hidden_size == 320
    assert meta.log_tone_map
    w = load_keras_h5(os.path.join(ASSET, "model.h5"))
    assert len(w.layers) == 6
    assert w.layers[0].kernel.dtype == np.float16      # fp16, as reference
    assert w.layers[0].kernel.shape == (48, 320)       # 4*E inputs
    # Skip-concat at the midpoint widens one layer's input by 4*E:
    in_dims = [l.kernel.shape[0] for l in w.layers]
    assert 320 + 48 in in_dims
    assert w.layers[-1].kernel.shape[1] == 3


def test_asset_reconstructs_training_hdri():
    """Log-domain PSNR vs the exact (deterministic) training image —
    the reconstruction-quality gate."""
    from ipu_ray_lib_tpu.nif.hdf5 import load_keras_h5
    from ipu_ray_lib_tpu.nif.metadata import NifMetadata
    from ipu_ray_lib_tpu.nif.model import NifModel
    from ipu_ray_lib_tpu.nif.synth import synth_hdri

    meta = NifMetadata.load(os.path.join(ASSET, "nif_metadata.txt"))
    model = NifModel.from_weights(
        load_keras_h5(os.path.join(ASSET, "model.h5")), meta)
    rec = model.reconstruct_image(height=128, width=256)
    ref = synth_hdri(2048, 4096)[::16, ::16]
    le_rec = np.log(np.clip(rec[..., ::-1], 1e-5, None))
    le_ref = np.log(np.clip(ref, 1e-5, None))
    mse = float(np.mean((le_rec - le_ref) ** 2))
    rng = float(le_ref.max() - le_ref.min())
    psnr = 10 * np.log10(rng * rng / mse)
    assert psnr > 30.0, f"PSNR {psnr:.2f} dB"


def test_asset_env_radiance_sane():
    """The env hook the renderer uses: finite, non-negative, HDR (the
    sun direction must be orders of magnitude brighter than the mean)."""
    import jax.numpy as jnp

    from ipu_ray_lib_tpu.nif.model import load_nif_env

    env_fn, env_params = load_nif_env(ASSET)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = np.asarray(env_fn(env_params, jnp.asarray(d)))
    assert np.isfinite(rgb).all()
    assert rgb.min() >= 0.0
    assert rgb.max() > 20.0 * rgb.mean()


@pytest.mark.parametrize("asset", [
    "synthetic_urban_4k", os.path.join("synthetic_sky", "assets.extra")])
def test_npz_equals_h5_bitwise(asset):
    """The committed weights.npz holds exactly the H5's layers: same
    names, activations, dtypes and bits."""
    pytest.importorskip("h5py")
    from ipu_ray_lib_tpu.nif.hdf5 import load_keras_h5, load_nif_npz

    d = os.path.join(os.path.dirname(ASSET), asset)
    a = load_keras_h5(os.path.join(d, "model.h5"))
    b = load_nif_npz(os.path.join(d, "weights.npz"))
    assert [l.name for l in a.layers] == [l.name for l in b.layers]
    for la, lb in zip(a.layers, b.layers):
        assert la.activation == lb.activation
        for x, y in ((la.kernel, lb.kernel), (la.bias, lb.bias)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def test_load_nif_env_needs_no_h5py(monkeypatch):
    """With a weights.npz present the renderer's loader never imports
    h5py (None in sys.modules makes any import of it fail)."""
    import sys

    import jax.numpy as jnp

    from ipu_ray_lib_tpu.nif.model import load_nif_env

    monkeypatch.setitem(sys.modules, "h5py", None)
    env_fn, env_params = load_nif_env(ASSET)
    d = jnp.asarray([[0.0, 1.0, 0.0], [0.6, 0.0, 0.8]], jnp.float32)
    assert np.isfinite(np.asarray(env_fn(env_params, d))).all()


def test_h5_only_directory_without_h5py_fails_clearly(tmp_path, monkeypatch):
    """A directory holding nothing but a Keras .h5 is read through h5py;
    without it the error says what to do instead."""
    import shutil
    import sys

    from ipu_ray_lib_tpu.nif.model import load_nif_env

    for f in ("nif_metadata.txt", "model.h5"):
        shutil.copy(os.path.join(ASSET, f), tmp_path / f)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="weights.npz"):
        load_nif_env(str(tmp_path))
