"""NIF weight I/O: Keras HDF5 (h5py) and a NumPy ``weights.npz`` twin.

Reads the converted Keras .h5 format the reference consumes
(format contract of ref src/keras/Hdf5Model.cpp): a ``model_config``
JSON attribute describing a Functional model whose layers are Dense
(InputLayer/Concatenate are structural and skipped), with weights at
``/model_weights/<name>/<name>/kernel:0`` and ``bias:0`` in float32 or
float16. Also *writes* the same format so NIFs trained with
:mod:`ipu_ray_lib_tpu.nif.train` are interchangeable with the reference
assets (replacing the reference's model_to_hdf5.py converter step).

``weights.npz`` holds the same content without HDF5: the ``model_config``
JSON string and the raw fp16/fp32 arrays under ``<name>/kernel`` and
``<name>/bias``. The renderer loads it with NumPy alone, so h5py is needed
only to read or write the .h5 form.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class DenseLayer:
    name: str
    activation: str  # "relu" | "linear"/"none"
    kernel: np.ndarray  # [in, out]
    bias: np.ndarray | None
    dtype: str = "float32"


@dataclass
class NifWeights:
    layers: List[DenseLayer] = field(default_factory=list)

    @property
    def hidden_size(self) -> int:
        return int(self.layers[0].kernel.shape[1]) if self.layers else 0

    @property
    def input_size(self) -> int:
        return int(self.layers[0].kernel.shape[0]) if self.layers else 0


def _weights_from_config(config, read) -> NifWeights:
    """Dense layers of a Keras ``model_config`` JSON; ``read(name, key)``
    returns the layer's "kernel" or "bias" array."""
    if isinstance(config, bytes):
        config = config.decode()
    cfg = json.loads(str(config))
    if cfg.get("class_name") != "Functional":
        raise ValueError("Expected a Keras 'Functional' model")
    weights = NifWeights()
    for layer in cfg["config"]["layers"]:
        cn = layer["class_name"]
        if cn in ("InputLayer", "Concatenate"):
            continue
        if cn != "Dense":
            raise ValueError(f"Layer class '{cn}' not supported by NIF loader")
        lc = layer["config"]
        name = lc["name"]
        kernel = read(name, "kernel")
        bias = read(name, "bias") if lc.get("use_bias", True) else None
        act = lc.get("activation", "linear")
        weights.layers.append(
            DenseLayer(
                name=name,
                activation="none" if act == "linear" else act,
                kernel=kernel,
                bias=bias,
                dtype=str(kernel.dtype),
            )
        )
    return weights


def load_keras_h5(path: str) -> NifWeights:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading '{path}' needs h5py, which is not installed; load a "
            "directory with a weights.npz instead (see save_nif_npz)") from e

    with h5py.File(path, "r") as f:
        return _weights_from_config(
            f.attrs["model_config"],
            lambda name, key: np.asarray(
                f[f"/model_weights/{name}/{name}/{key}:0"]))


def load_nif_npz(path: str) -> NifWeights:
    """Read a ``weights.npz`` written by :func:`save_nif_npz`."""
    with np.load(path, allow_pickle=False) as z:
        return _weights_from_config(
            z["model_config"][()],
            lambda name, key: np.asarray(z[f"{name}/{key}"]))


def _model_config(weights: NifWeights) -> dict:
    in_dim = weights.input_size
    layers_cfg = [
        {
            "class_name": "InputLayer",
            "config": {"name": "input_1", "batch_input_shape": [None, in_dim]},
        }
    ]
    for l in weights.layers:
        layers_cfg.append(
            {
                "class_name": "Dense",
                "config": {
                    "name": l.name,
                    "activation": "linear" if l.activation in ("none", "linear") else l.activation,
                    "dtype": l.dtype,
                    "units": int(l.kernel.shape[1]),
                    "use_bias": l.bias is not None,
                },
            }
        )
    return {"class_name": "Functional", "config": {"layers": layers_cfg}}


def save_nif_npz(path: str, weights: NifWeights, config: str | None = None) -> None:
    """Write ``weights.npz``: the ``model_config`` JSON (``config``, or one
    made from ``weights``) and the raw kernel/bias arrays."""
    if config is None:
        config = json.dumps(_model_config(weights))
    arrays = {"model_config": np.array(config)}
    for l in weights.layers:
        arrays[f"{l.name}/kernel"] = l.kernel
        if l.bias is not None:
            arrays[f"{l.name}/bias"] = l.bias
    np.savez(path, **arrays)


def save_keras_h5(path: str, weights: NifWeights, embedding_dimension: int) -> None:
    """Write weights in the reference-compatible Keras H5 layout."""
    import h5py

    config = _model_config(weights)
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(config)
        f.attrs["keras_version"] = "2.x-ipu_ray_lib_tpu"
        f.attrs["backend"] = "jax"
        for l in weights.layers:
            grp = f.create_group(f"/model_weights/{l.name}/{l.name}")
            grp.create_dataset("kernel:0", data=l.kernel)
            if l.bias is not None:
                grp.create_dataset("bias:0", data=l.bias)
