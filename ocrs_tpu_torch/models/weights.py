"""Model weight files and the JAX-to-PyTorch layout map.

Port of ``ocrs_tpu.models.weights`` in numpy (no download branch): a weight
file is a flat ``.npz`` of the JAX parameter pytree, keys joined with ``/``,
plus a ``__meta__`` record of UTF-8 JSON.

:func:`params_from_jax` carries JAX-layout parameters across to the port's
``nn.Module`` state dicts:

  * HWIO conv kernels -> OIHW (``F.conv2d``'s layout);
  * ConvCTC's depthwise kernels ``dw/w [k, 1, dim]`` (WIO) -> ``[dim, 1, k]``
    (``F.conv1d``'s layout with ``groups=dim``);
  * dense ``w [in, out]`` is KEPT as ``[in, out]``: the port's ``Dense``
    computes ``x @ w`` as the JAX package does, so no transpose is needed;
  * GRU ``wx [C, 3H]``, ``wh [H, 3H]``, ``bx``, ``bh`` are kept as they are,
    gate order r, z, n;
  * biases and LayerNorm ``g``/``b`` are kept.

The map goes by key as well as by rank: only a leaf named ``w`` is a kernel.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_SEP = "/"
_META_KEY = "__meta__"


def _unflatten(flat: Mapping[str, np.ndarray]) -> Any:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def load_params(path: str | Path) -> tuple[Any, dict]:
    """Load a JAX-layout parameter pytree (numpy leaves) and its metadata."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta_arr = flat.pop(_META_KEY, None)
    meta = (
        json.loads(bytes(meta_arr.tobytes()).decode("utf-8"))
        if meta_arr is not None
        else {}
    )
    return _unflatten(flat), meta


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def params_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """JAX-layout parameters -> a PyTorch state dict (``.``-joined keys).

    `params` is either the nested pytree (as :func:`load_params` returns it,
    or as ``jax.device_get`` gives it) or a flat mapping with ``/``-joined
    keys (the ``.npz`` layout). Leaves may be numpy arrays or anything
    ``np.asarray`` takes."""
    if isinstance(params, Mapping) and all(
        not isinstance(v, (Mapping, list, tuple)) for v in params.values()
    ):
        flat = {k.replace(_SEP, "."): np.asarray(v) for k, v in params.items()}
    else:
        flat = _flatten(params)
    state = {}
    for key, arr in flat.items():
        arr = np.asarray(arr, dtype=np.float32)
        path = key.split(".")
        if path[-1] == "w" and arr.ndim == 4:  # HWIO -> OIHW
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif path[-2:] == ["dw", "w"] and arr.ndim == 3:  # WIO -> [dim, 1, k]
            arr = np.transpose(arr, (2, 1, 0))
        state[key] = torch.tensor(np.ascontiguousarray(arr))
    return state


def load_detection_model(source: str | Path):
    """Construct a DetectionModel from a weight file (input size from meta)."""
    from .detection_net import DetectionModel

    params, meta = load_params(source)
    return DetectionModel(params, tuple(meta.get("input_hw", (800, 608))))


def load_recognition_model(source: str | Path):
    """Construct a RecognitionModel from a weight file, honouring the
    architecture recorded in the file's metadata ("arch")."""
    from .recognition_net import RecognitionModel

    params, meta = load_params(source)
    return RecognitionModel(params, arch=meta.get("arch", "crnn"))
