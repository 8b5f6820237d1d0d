"""Process groups for training over several devices.

The JAX package trains over a ``("data", "model")`` mesh and lets XLA insert
the collectives (``ocrs_tpu/train/train.py``). The port runs one process per
device, as PyTorch does, and writes the collectives out:

* :func:`init_process_group`: ``nccl`` for CUDA, ``gloo`` for the CPU (or
  the backend the caller names), from ``torchrun``'s environment or from a
  ``file://`` store, with a timeout.
* :func:`make_mesh`: the ``("data", "model")`` mesh over the world, through
  ``torch.distributed.device_mesh.init_device_mesh``, as a :class:`Mesh`
  that holds its two process groups and this rank's place in them.
* :func:`copy_to_model` and :func:`gather_from_model`: the two
  ``autograd.Function`` s of the column split (Megatron's pattern), used by
  the layers of :mod:`..models.nn` that hold a slice of their columns.
* :func:`spawn`: run a function in n processes with a store of their own,
  a deadline and every process stopped on the way out.

The data split itself is ``DistributedDataParallel`` over the ``"data"``
group (:mod:`..train.train`).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .sharding import shard_bounds

#: Stores of spawned groups go under the checkout's ``build/``.
STORE_DIR = Path(__file__).resolve().parents[2] / "build" / "dist_stores"


def default_backend(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (modulo the visible
    devices) for CUDA, the CPU otherwise. Raises where CUDA is asked for and
    there is none."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device 'cpu' for a group on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_process_group(
    device: torch.device | str,
    backend: Optional[str] = None,
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout: Optional[timedelta] = None,
) -> torch.device:
    """Join the default process group and return this rank's device.

    `backend` defaults to :func:`default_backend` of `device`. Without
    `init_method` the group is read from the environment ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); spawned
    ranks pass a ``file://`` store, their `rank` and `world_size`. A CUDA
    `device` becomes the process's current device. `timeout` bounds every
    collective (PyTorch's default where None)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device 'cpu' for a group on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    kwargs: dict[str, Any] = {"backend": backend or default_backend(device)}
    if kwargs["backend"] == "nccl":
        kwargs["device_id"] = device  # binds the rank to its card (collectives and barriers)
    if init_method is not None:
        kwargs.update(init_method=init_method, rank=rank, world_size=world_size)
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(**kwargs)
    return device


@dataclass(frozen=True)
class Mesh:
    """The ``("data", "model")`` mesh of this rank: its two groups, this
    rank's coordinates on them and its device. Ranks are laid out as
    ``make_mesh`` in ``ocrs_tpu/train/train.py`` lays out devices: rank
    ``d * model_size + m`` sits at data ``d``, model ``m``."""

    device: torch.device
    data_group: Any
    model_group: Any
    data_size: int
    model_size: int
    data_rank: int
    model_rank: int

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data_size, "model": self.model_size}


def make_mesh(
    n_devices: Optional[int] = None, model_parallel: int = 1, device: torch.device | str | None = None
) -> Mesh:
    """The ``("data", "model")`` mesh over the world of the default process
    group (which :func:`init_process_group` made). `n_devices`, where given,
    must be the world size (one process per device). Raises ``ValueError``
    where the world does not divide by `model_parallel`. `device` is this
    rank's device: the current CUDA device under ``nccl``, the CPU under
    ``gloo``, unless given (two ``gloo`` ranks may share one card)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_process_group first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the world has {world} processes (one each)")
    if model_parallel < 1 or world % model_parallel != 0:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    backend = dist.get_backend()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    device = torch.device(device)
    mesh = init_device_mesh(
        "cuda" if backend == "nccl" else "cpu",
        (world // model_parallel, model_parallel),
        mesh_dim_names=("data", "model"),
    )
    return Mesh(
        device=device,
        data_group=mesh.get_group("data"),
        model_group=mesh.get_group("model"),
        data_size=world // model_parallel,
        model_size=model_parallel,
        data_rank=mesh.get_local_rank("data"),
        model_rank=mesh.get_local_rank("model"),
    )


def is_main_rank() -> bool:
    """True outside a process group and on its rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group backward:
    each model rank's slice of the columns contributes a part of the input's
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # bf16 parts are summed in float32 and rounded once, as one
        # device's product of the whole columns would round.
        total = grad.to(torch.promote_types(grad.dtype, torch.float32), copy=True).contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last dimension forward; this rank's slice of the
    gradient backward. Every model rank computes the same loss from the
    gathered output, so its gradient is already the whole one: a
    reduce-scatter (``torch.distributed.nn.functional.all_gather``'s
    backward) would count it once per model rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.slice = (dist.get_rank(group) * x.shape[-1], x.shape[-1])
        return gather_columns(x, group)

    @staticmethod
    def backward(ctx, grad):
        start, width = ctx.slice
        return grad.narrow(-1, start, width).contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromModel.apply(x, group)


def column_slice(columns: int, group) -> slice:
    """This model rank's slice of `columns` output columns. Raises
    ``ValueError`` where they do not split evenly (JAX refuses such a
    sharding too)."""
    start, stop = shard_bounds(columns, dist.get_world_size(group))[dist.get_rank(group)]
    return slice(start, stop)


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """The model group's slices of `x` side by side along the last
    dimension, in rank order: a column-split array whole (a collective, not
    differentiated)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def mean_over(group, value: torch.Tensor) -> torch.Tensor:
    """The mean of `value` over `group` (a new tensor)."""
    out = value.detach().to(torch.float32, copy=True)
    dist.all_reduce(out, group=group)
    return (out / dist.get_world_size(group)).to(value.dtype)


def _rank_entry(rank: int, fn: Callable, *args) -> None:
    # One CPU thread a rank: ranks share the host's cores (with each other
    # and with their parent), and the CPU kernels' thread pools would
    # otherwise spin against each other.
    torch.set_num_threads(1)
    fn(rank, *args)


def spawn(
    fn: Callable, nprocs: int, args: tuple = (), timeout: float = 600.0, store_dir: Path | str | None = None
) -> None:
    """Run ``fn(rank, nprocs, store, *args)`` in `nprocs` new processes
    (``spawn`` start method, one CPU thread each) and wait for all of them.
    `store` is a ``file://`` URL of a store made for this group (under
    `store_dir`, :data:`STORE_DIR` by default), for
    :func:`init_process_group`. Raises where a process fails, and
    ``TimeoutError`` after `timeout` seconds; every process is stopped
    before this returns or raises."""
    import torch.multiprocessing as mp

    base = Path(store_dir) if store_dir is not None else STORE_DIR
    base.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="group-", dir=base)
    store = f"file://{os.path.join(tmp, 'store')}"
    ctx = mp.spawn(_rank_entry, args=(fn, nprocs, store, *args), nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} spawned ranks did not finish within {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
