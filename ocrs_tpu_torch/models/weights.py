"""Model weight files and the JAX-to-PyTorch layout map.

Port of ``ocrs_tpu.models.weights`` in numpy: a weight file is a flat
``.npz`` of the JAX parameter pytree, keys joined with ``/``, plus a
``__meta__`` record of UTF-8 JSON. :func:`fetch_model` resolves a model
source as the JAX package does: local paths pass through, and an
``http(s)://`` URL is downloaded once into the per-user cache
(``~/.cache/ocrs-tpu``, or ``$OCRS_TPU_CACHE``), keyed by its file name
(upstream ocrs-cli/src/models.rs:17-64).

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
:func:`params_to_jax` is its inverse, and :func:`save_params` writes a tree
in the JAX package's layout, so a model (or a training checkpoint) the port
writes loads in ``ocrs_tpu.models.weights.load_params`` and back here.
"""

from __future__ import annotations

import json
import os
import sys
import urllib.request
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

_SEP = "/"
_META_KEY = "__meta__"


def cache_dir() -> Path:
    """Per-user model cache (models.rs:17-42)."""
    root = os.environ.get("OCRS_TPU_CACHE", os.path.join(Path.home(), ".cache", "ocrs-tpu"))
    p = Path(root)
    p.mkdir(parents=True, exist_ok=True)
    return p


def fetch_model(source: str | Path) -> Path:
    """Resolve a model source to a local file.

    Local paths pass through; ``http(s)://`` URLs download once into the
    cache, keyed by filename, and are read from there when already present
    (models.rs:44-64)."""
    source = str(source)
    if not source.startswith(("http://", "https://")):
        return Path(source)
    target = cache_dir() / source.rsplit("/", 1)[-1]
    if target.exists():
        return target
    print(f"Downloading {source}...", file=sys.stderr)
    tmp = target.with_suffix(target.suffix + ".part")
    urllib.request.urlretrieve(source, tmp)
    tmp.rename(target)
    return target


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


def load_flat(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """A weight file's leaves by their ``/``-joined keys, and its metadata."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta_arr = flat.pop(_META_KEY, None)
    meta = (
        json.loads(bytes(meta_arr.tobytes()).decode("utf-8"))
        if meta_arr is not None
        else {}
    )
    return flat, meta


def load_params(path: str | Path) -> tuple[Any, dict]:
    """Load a JAX-layout parameter pytree (numpy leaves) and its metadata."""
    flat, meta = load_flat(path)
    return _unflatten(flat), meta


def save_params(path: str | Path, params: Any, meta: dict | None = None) -> None:
    """Save a JAX-layout tree (nested dicts and lists of arrays, e.g. from
    :func:`params_to_jax`) and its JSON metadata as a flat ``.npz`` with
    ``/``-joined keys: ``ocrs_tpu.models.weights.save_params``'s layout."""
    flat = {k.replace(".", _SEP): v for k, v in _flatten(params).items()}
    flat[_META_KEY] = np.frombuffer(json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **flat)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
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


def params_to_jax(state: Mapping[str, Any]) -> Any:
    """A PyTorch state dict (``.``-joined keys; tensors or arrays) -> the JAX
    package's parameter tree with numpy float32 leaves: the inverse of
    :func:`params_from_jax` (OIHW -> HWIO, depthwise ``[dim, 1, k]`` -> WIO,
    the rest as it is; numbered keys become lists). Tensors shaped like the
    parameters (Adam's moments) map the same way. Leaves are float32
    (float64 ones stay float64)."""
    flat = {}
    for key, value in state.items():
        arr = value.detach().cpu() if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        arr = (arr if arr.dtype == torch.float64 else arr.to(torch.float32)).numpy()
        path = key.split(".")
        if path[-1] == "w" and arr.ndim == 4:  # OIHW -> HWIO
            arr = np.transpose(arr, (2, 3, 1, 0))
        elif path[-2:] == ["dw", "w"] and arr.ndim == 3:  # [dim, 1, k] -> WIO
            arr = np.transpose(arr, (2, 1, 0))
        flat[_SEP.join(path)] = np.ascontiguousarray(arr)
    return _unflatten(flat)


def load_detection_model(source: str | Path):
    """Construct a DetectionModel from a weight file or URL (input size from meta)."""
    from .detection_net import DetectionModel

    params, meta = load_params(fetch_model(source))
    return DetectionModel(params, tuple(meta.get("input_hw", (800, 608))))


def load_recognition_model(source: str | Path):
    """Construct a RecognitionModel from a weight file or URL, honouring the
    architecture recorded in the file's metadata ("arch")."""
    from .recognition_net import RecognitionModel

    params, meta = load_params(fetch_model(source))
    return RecognitionModel(params, arch=meta.get("arch", "crnn"))
