"""Neural Image Field (NIF) environment light — JAX implementation.

The reference evaluates a small Fourier-feature MLP on-device for escaped
rays to light them from an HDRI (ref: src/neural_networks/NifModel.cpp,
src/IpuScene.cpp:506-537). Behavioural contract reproduced here:

* equirectangular direction->UV with azimuth rotation
  (ref codelets/TraceCodelets.cpp:321-358 PreProcessEscapedRays);
* input encoding: uvn = 2*(uv - 1); features
  [sin(u*c), sin(v*c), cos(u*c), cos(v*c)] with c = powers of two
  (ref NifModel.cpp:186-219, 404-433 — powers computed on the host);
* Dense stack with the skip-concat point auto-detected by input-shape
  mismatch (ref NifModel.cpp:300-327);
* output decode: x*max + mean, exp when log-tone-mapped, channels BGR
  (ref NifModel.cpp:222-246; PostProcessEscapedRays reverses to RGB).

Differences from the reference: the whole escaped-ray batch is one bf16
matmul chain with f32 accumulation (no batch serialisation needed — ref
IpuScene.cpp:266-295 exists only because of IPU SRAM limits), and sin/cos
run in f32 (the reference drops to fp16 because IPU fp32 transcendentals
are slow).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

import jax.numpy as jnp

from ..utils.constants import INV_2PI, INV_PI, TWO_PI
from .hdf5 import NifWeights, load_keras_h5, load_nif_npz
from .metadata import NifMetadata


def direction_to_equirect_uv(dirs: jnp.ndarray, azimuth_rotation) -> jnp.ndarray:
    """Equirectangular projection of (normalised) directions -> [.., 2] uv."""
    theta = jnp.arccos(jnp.clip(dirs[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(dirs[..., 2], dirs[..., 0]) + azimuth_rotation
    phi = jnp.where(phi < 0.0, phi + TWO_PI, phi)
    phi = jnp.where(phi > TWO_PI, phi - TWO_PI, phi)
    return jnp.stack([theta * INV_PI, phi * INV_2PI], axis=-1)


@dataclass(frozen=True)
class NifConfig:
    """Static model structure (hashable, safe to close over under jit)."""

    embedding_dimension: int
    activations: Tuple[str, ...]
    concat_before: Tuple[bool, ...]  # concat encoded input before layer i
    log_tone_map: bool
    compute_dtype: str = "bfloat16"


class NifModel:
    """Bundles static config with pure apply functions. Params are a dict
    pytree: {"kernels": (...), "biases": (...), "max": f32, "mean": [3]}."""

    def __init__(self, config: NifConfig, params: dict):
        self.config = config
        self.params = params

    # ---- Construction ---------------------------------------------------

    @classmethod
    def from_weights(cls, weights: NifWeights, meta: NifMetadata) -> "NifModel":
        e4 = 4 * meta.embedding_dimension
        acts, concat, kernels, biases = [], [], [], []
        cur = e4
        for l in weights.layers:
            k_in = int(l.kernel.shape[0])
            if k_in != cur:
                if k_in != cur + e4:
                    raise ValueError(
                        f"Layer '{l.name}' input {k_in} matches neither {cur} nor {cur + e4}"
                    )
                concat.append(True)
            else:
                concat.append(False)
            acts.append(l.activation)
            kernels.append(jnp.asarray(np.asarray(l.kernel, np.float32)))
            biases.append(
                jnp.asarray(np.asarray(l.bias, np.float32))
                if l.bias is not None
                else jnp.zeros(l.kernel.shape[1], jnp.float32)
            )
            cur = int(l.kernel.shape[1])
        config = NifConfig(
            embedding_dimension=meta.embedding_dimension,
            activations=tuple(acts),
            concat_before=tuple(concat),
            log_tone_map=meta.log_tone_map,
        )
        params = {
            "kernels": tuple(kernels),
            "biases": tuple(biases),
            "max": jnp.float32(meta.max),
            "mean": jnp.asarray(meta.mean, jnp.float32),
        }
        return cls(config, params)

    # ---- Pure functions -------------------------------------------------

    @staticmethod
    def encode_input(uv: jnp.ndarray, embedding_dimension: int) -> jnp.ndarray:
        """Fourier features [sin(u c), sin(v c), cos(u c), cos(v c)]."""
        coeffs = jnp.asarray(2.0 ** np.arange(embedding_dimension), jnp.float32)
        uvn = 2.0 * (uv - 1.0)
        pu = uvn[..., 0:1] * coeffs
        pv = uvn[..., 1:2] * coeffs
        return jnp.concatenate(
            [jnp.sin(pu), jnp.sin(pv), jnp.cos(pu), jnp.cos(pv)], axis=-1
        )

    @staticmethod
    def apply(config: NifConfig, params: dict, uv: jnp.ndarray) -> jnp.ndarray:
        """Full inference: uv [..,2] -> decoded BGR [..,3] (f32)."""
        cdt = jnp.dtype(config.compute_dtype)
        feats = NifModel.encode_input(uv, config.embedding_dimension).astype(cdt)
        x = feats
        for i, (k, b) in enumerate(zip(params["kernels"], params["biases"])):
            if config.concat_before[i]:
                x = jnp.concatenate([x, feats], axis=-1)
            x = jnp.dot(x, k.astype(cdt), preferred_element_type=jnp.float32)
            x = x + b
            if config.activations[i] == "relu":
                x = jnp.maximum(x, 0.0)
            if i + 1 < len(params["kernels"]):
                x = x.astype(cdt)
        # Decode at f32 (ref NifModel.cpp:222-246):
        x = x.astype(jnp.float32) * params["max"] + params["mean"]
        if config.log_tone_map:
            x = jnp.exp(x)
        return x

    @staticmethod
    def env_radiance(config: NifConfig, params: dict, dirs: jnp.ndarray) -> jnp.ndarray:
        """Environment radiance (RGB) for escaped-ray directions."""
        uv = direction_to_equirect_uv(dirs, params.get("rotation", jnp.float32(0.0)))
        bgr = NifModel.apply(config, params, uv)
        return bgr[..., ::-1]

    def reconstruct_image(self, height: int | None = None, width: int | None = None,
                          meta: NifMetadata | None = None, batch: int = 1 << 16) -> np.ndarray:
        """Decode the full image grid (the standalone streaming-inference
        mode of ref NifModel.cpp:339-352 / generateInputSamples)."""
        import jax

        if meta is not None:
            height = height or meta.image_shape[0]
            width = width or meta.image_shape[1]
        rr, cc = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        uv = np.stack([rr / height, cc / width], axis=-1).reshape(-1, 2).astype(np.float32)
        fn = jax.jit(lambda p, u: NifModel.apply(self.config, p, u))
        out = np.empty((height * width, 3), np.float32)
        for s in range(0, len(uv), batch):
            sl = uv[s : s + batch]
            pad = batch - len(sl)
            if pad:
                sl = np.pad(sl, ((0, pad), (0, 0)))
            out[s : s + batch - pad] = np.asarray(fn(self.params, jnp.asarray(sl)))[: batch - pad]
        return out.reshape(height, width, 3)


def load_nif_env(assets_dir: str, rotation_degrees: float = 0.0):
    """Load a NIF from an assets.extra-style directory and return
    ``(env_fn, env_params)`` for the renderer: env_fn(params, dirs)->rgb.

    Weights come from ``weights.npz`` when the directory has one (NumPy
    only); a directory with nothing but a Keras .h5 is read through h5py."""
    meta_path = os.path.join(assets_dir, "nif_metadata.txt")
    meta = NifMetadata.load(meta_path)
    npz = os.path.join(assets_dir, "weights.npz")
    if os.path.exists(npz):
        weights = load_nif_npz(npz)
    else:
        h5 = None
        for cand in sorted(os.listdir(assets_dir)):
            if cand.endswith(".h5"):
                h5 = os.path.join(assets_dir, cand)
        if h5 is None:
            raise FileNotFoundError(
                f"No weights.npz or .h5 weights found in '{assets_dir}'. "
                "Save the model with ipu_ray_lib_tpu.nif.train.save_nif_assets "
                "or train one with ipu_ray_lib_tpu.nif.train.")
        weights = load_keras_h5(h5)
    model = NifModel.from_weights(weights, meta)
    params = dict(model.params)
    params["rotation"] = jnp.float32(np.deg2rad(rotation_degrees))
    config = model.config

    def env_fn(env_params, dirs):
        return NifModel.env_radiance(config, env_params, dirs)

    return env_fn, params
