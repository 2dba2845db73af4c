"""NIF training: fit the Fourier-feature MLP to an HDRI.

The reference ships only trained assets (its train_nif.py lives outside
the repo; src/keras/model_to_hdf5.py converts its output). Here training
is a first-class part of the framework: a small optax/Adam loop over
random pixel batches, producing models directly loadable by
:mod:`ipu_ray_lib_tpu.nif.model` and exportable to the
reference-compatible Keras H5 layout.

Encoding matches the reference decode contract (NifModel.cpp:222-246 /
NifMetaData.cpp:49-53): images are log-tone-mapped with eps, per-channel
mean-centred and scaled by the max absolute value, and stored in BGR
channel order.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp
import optax

from .hdf5 import DenseLayer, NifWeights, save_keras_h5, save_nif_npz
from .metadata import NifMetadata
from .model import NifConfig, NifModel


def make_nif(
    key,
    embedding_dimension: int = 12,
    layer_count: int = 6,
    layer_size: int = 320,
    log_tone_map: bool = True,
) -> NifModel:
    """Fresh random NIF with the reference family's architecture: dense
    stack with one skip-concat of the encoded input at the midpoint."""
    e4 = 4 * embedding_dimension
    concat_at = layer_count // 2
    dims_in, dims_out, concat, acts = [], [], [], []
    cur = e4
    for i in range(layer_count):
        cat = i == concat_at and layer_count > 1
        d_in = cur + (e4 if cat else 0)
        d_out = 3 if i == layer_count - 1 else layer_size
        dims_in.append(d_in)
        dims_out.append(d_out)
        concat.append(cat)
        acts.append("none" if i == layer_count - 1 else "relu")
        cur = d_out

    kernels, biases = [], []
    for d_in, d_out in zip(dims_in, dims_out):
        key, k1 = jax.random.split(key)
        scale = jnp.sqrt(2.0 / d_in)
        kernels.append(jax.random.normal(k1, (d_in, d_out), jnp.float32) * scale)
        biases.append(jnp.zeros(d_out, jnp.float32))

    config = NifConfig(
        embedding_dimension=embedding_dimension,
        activations=tuple(acts),
        concat_before=tuple(concat),
        log_tone_map=log_tone_map,
        compute_dtype="float32",  # train at f32; inference may use bf16
    )
    params = {
        "kernels": tuple(kernels),
        "biases": tuple(biases),
        "max": jnp.float32(1.0),
        "mean": jnp.zeros(3, jnp.float32),
    }
    return NifModel(config, params)


def encode_targets(image_rgb: np.ndarray, eps: float = 1e-8, log_tone_map: bool = True):
    """RGB HDR image -> (targets_bgr, max, mean): the training-space encode
    whose inverse is the model's device decode."""
    bgr = np.asarray(image_rgb, np.float32)[..., ::-1]
    if log_tone_map:
        enc = np.log(bgr + eps)
    else:
        enc = bgr
    mean = enc.reshape(-1, 3).mean(axis=0)
    centred = enc - mean
    mx = float(np.abs(centred).max()) or 1.0
    return (centred / mx).astype(np.float32), np.float32(mx), mean.astype(np.float32)


def train_nif(
    image_rgb: np.ndarray,
    embedding_dimension: int = 12,
    layer_count: int = 6,
    layer_size: int = 320,
    steps: int = 2000,
    batch_size: int = 4096,
    learning_rate: float = 1e-3,
    eps: float = 1e-8,
    log_tone_map: bool = True,
    seed: int = 0,
) -> tuple[NifModel, NifMetadata]:
    h, w = image_rgb.shape[:2]
    targets, mx, mean = encode_targets(image_rgb, eps, log_tone_map)
    targets = jnp.asarray(targets.reshape(-1, 3))

    key = jax.random.PRNGKey(seed)
    key, mkey = jax.random.split(key)
    model = make_nif(mkey, embedding_dimension, layer_count, layer_size, log_tone_map)
    config = model.config

    # Train the normalised (pre-decode) output directly:
    def raw_apply(params, uv):
        cfg = NifConfig(
            embedding_dimension=config.embedding_dimension,
            activations=config.activations,
            concat_before=config.concat_before,
            log_tone_map=False,
            compute_dtype="float32",
        )
        x = NifModel.apply(cfg, {**params, "max": jnp.float32(1.0),
                                 "mean": jnp.zeros(3, jnp.float32)}, uv)
        return x

    trainable = {"kernels": model.params["kernels"], "biases": model.params["biases"]}
    opt = optax.adam(learning_rate)
    opt_state = opt.init(trainable)

    def loss_fn(tr, uv, y):
        pred = raw_apply(tr, uv)
        return jnp.mean((pred - y) ** 2)

    @jax.jit
    def step(tr, opt_state, key):
        kr, kc = jax.random.split(key)
        rows = jax.random.randint(kr, (batch_size,), 0, h)
        cols = jax.random.randint(kc, (batch_size,), 0, w)
        uv = jnp.stack([rows / h, cols / w], axis=-1).astype(jnp.float32)
        y = targets[rows * w + cols]
        loss, grads = jax.value_and_grad(loss_fn)(tr, uv, y)
        updates, opt_state = opt.update(grads, opt_state)
        tr = optax.apply_updates(tr, updates)
        return tr, opt_state, loss

    loss = None
    for i in range(steps):
        key, sk = jax.random.split(key)
        trainable, opt_state, loss = step(trainable, opt_state, sk)

    params = {
        "kernels": trainable["kernels"],
        "biases": trainable["biases"],
        "max": jnp.float32(mx),
        "mean": jnp.asarray(mean - (np.float32(eps) if log_tone_map else 0.0)),
    }
    meta = NifMetadata(
        embedding_dimension=embedding_dimension,
        name="trained",
        image_shape=[h, w, 3],
        eps=eps,
        log_tone_map=log_tone_map,
        max=mx,
        mean=np.asarray(params["mean"]),
        hidden_size=layer_size,
    )
    return NifModel(model.config, params), meta


def save_nif_assets(model: NifModel, meta: NifMetadata, out_dir: str,
                    fp16: bool = True) -> None:
    """Write an assets.extra-style directory: nif_metadata.txt, the Keras
    model.h5 and its NumPy twin weights.npz."""
    os.makedirs(out_dir, exist_ok=True)
    meta.save(
        os.path.join(out_dir, "nif_metadata.txt"),
        train_command=[
            "train_nif.py", "--layer-size", str(meta.hidden_size),
            "--embedding-dimension", str(meta.embedding_dimension),
        ],
    )
    dtype = np.float16 if fp16 else np.float32
    layers = []
    for i, (k, b) in enumerate(zip(model.params["kernels"], model.params["biases"])):
        layers.append(
            DenseLayer(
                name=f"dense_{i}",
                activation="relu" if model.config.activations[i] == "relu" else "linear",
                kernel=np.asarray(k, dtype),
                bias=np.asarray(b, dtype),
                dtype=str(np.dtype(dtype)),
            )
        )
    weights = NifWeights(layers=layers)
    save_nif_npz(os.path.join(out_dir, "weights.npz"), weights)
    save_keras_h5(os.path.join(out_dir, "model.h5"), weights,
                  meta.embedding_dimension)
