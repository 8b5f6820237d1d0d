"""Data meshes and batch sharding over several devices in one process.

Port of ``ocrs_tpu.parallel.sharding``. The JAX package puts the page batch
on a ``("data",)`` mesh axis and lets XLA partition every stage. PyTorch has
no single-process SPMD compiler, so the port's mesh is a list of devices, and
a sharded batch is one contiguous slice of the leading dimension per entry,
in order, each on its device. :class:`..pipeline.PagePipeline` (``mesh=``)
runs one single-device pipeline per entry, in a thread of its own. Training
over several devices uses process groups instead
(:mod:`.distributed`), one process per device.

An entry may name a device that another entry names too
(``make_data_mesh(devices=["cuda:0", "cuda:0"])``): two shards then share
one card, each on a CUDA stream of its own.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh: the devices of the ``"data"`` axis, one per shard."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        """``{"data": n}``, as ``jax.sharding.Mesh.shape`` gives it."""
        return {"data": self.size}


def make_data_mesh(
    n_devices: Optional[int] = None,
    device_type: str = "cuda",
    devices: Optional[Sequence[torch.device | str]] = None,
) -> DataMesh:
    """A ``("data",)`` mesh.

    * By default: the first `n_devices` visible CUDA devices (all of them
      when None). Raises ``RuntimeError`` when there is no CUDA device or
      fewer than `n_devices`.
    * ``device_type="cpu"``: `n_devices` CPU entries (one when None).
    * ``devices=[...]``: those devices, in order; a device may appear more
      than once (shards that share it). `n_devices` then takes the first n.
    """
    if devices is not None:
        chosen = tuple(torch.device(d) for d in devices)
        if n_devices is not None:
            chosen = chosen[:n_devices]
    elif device_type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_data_mesh takes CUDA devices by default and none is visible; "
                "pass device_type='cpu' for a mesh of CPU entries"
            )
        n = count if n_devices is None else n_devices
        if n > count:
            raise RuntimeError(f"make_data_mesh: {n} CUDA devices asked for, {count} visible")
        chosen = tuple(torch.device("cuda", i) for i in range(n))
    elif device_type == "cpu":
        chosen = (torch.device("cpu"),) * (1 if n_devices is None else n_devices)
    else:
        raise ValueError(f"unknown device_type {device_type!r}")
    if not chosen:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(chosen)


def shard_bounds(rows: int, parts: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of each of `parts` equal contiguous slices of
    `rows`. Raises ``ValueError`` where `rows` does not divide by `parts`:
    JAX's ``device_put`` refuses such a sharding, and the port refuses it too
    (a per-shard mean is the global mean only over equal shards)."""
    if parts < 1 or rows % parts != 0:
        raise ValueError(f"a dimension of {rows} does not split evenly over {parts} shards")
    k = rows // parts
    return [(i * k, (i + 1) * k) for i in range(parts)]


def split_batch_dim(mesh: DataMesh, array):
    """The slices of `array`'s leading dimension, one per mesh entry, in
    order, where they are (views of a numpy array or of a tensor)."""
    return [array[a:b] for a, b in shard_bounds(len(array), mesh.size)]


def shard_batch_dim(mesh: DataMesh, array) -> list[torch.Tensor]:
    """Shard the leading (batch) dimension over the mesh: one contiguous
    slice per entry, in order, each on its device. Raises ``ValueError``
    where the batch does not divide by the mesh size."""
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.ascontiguousarray(array))
    return [part.to(dev) for part, dev in zip(split_batch_dim(mesh, array), mesh.devices)]


def _on_device(module: nn.Module, device: torch.device) -> bool:
    tensors = [*module.parameters(), *module.buffers()]
    return all(t.device == device for t in tensors)


def _place(leaf: Any, device: torch.device) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf).to(device)
    if isinstance(leaf, nn.Module):
        return leaf if _on_device(leaf, device) else copy.deepcopy(leaf).to(device)
    if isinstance(leaf, dict):
        return {k: _place(v, device) for k, v in leaf.items()}
    if isinstance(leaf, (list, tuple)):
        return type(leaf)(_place(v, device) for v in leaf)
    return leaf


def replicate(mesh: DataMesh, tree: Any) -> list[Any]:
    """`tree` on every mesh entry: one copy per distinct device, shared by
    the entries that name it. Leaves may be tensors, numpy arrays (made
    tensors) or modules; a leaf already on a device is used there as it is,
    so a module is copied only to the devices it is not on. Containers
    (dict, list, tuple) are rebuilt; other leaves pass through."""
    per_device: dict[torch.device, Any] = {}
    for dev in mesh.devices:
        if dev not in per_device:
            per_device[dev] = _place(tree, dev)
    return [per_device[dev] for dev in mesh.devices]
