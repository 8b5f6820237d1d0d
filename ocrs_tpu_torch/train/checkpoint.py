"""Training checkpoints (port of ``ocrs_tpu.train.checkpoint``).

A checkpoint is ``step-%08d.npz`` in the JAX package's flat layout
(:func:`..models.weights.save_params`): ``params/<path>`` in the JAX
parameter layout, ``opt_state/...`` where optax keeps the recipe's state
(:meth:`.optim.Optimizer.state_tree`; the moments in the parameters'
layout) and ``{"step": N}`` as metadata. So a checkpoint written by either
package restores in the other, and its ``params`` load as model weights.

:func:`restore_checkpoint` reads the flat keys directly: a chain's
``opt_state`` has gaps where optax's empty states are (``opt_state/1/...``
with no ``opt_state/0``), which a nested list cannot hold.

A state over a mesh (:mod:`.train`) is saved whole: the split leaves and
their moments are gathered over the model group, and the main rank alone
writes the file, which has the keys and layout of the one-device state's.
Restoring it into a sharded state gives each rank its slices.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch.distributed as dist

from ..models.weights import load_flat, params_from_jax, params_to_jax, save_params
from ..parallel.distributed import is_main_rank
from .train import TrainState, gathered_state_dict


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, keep: int = 3) -> Path:
    """Write ``step-N.npz`` into `ckpt_dir`, keeping the newest `keep`.
    Under a mesh every rank calls it (the gathers are collectives); rank 0
    writes, and every rank returns once the file is there."""
    ckpt_dir = Path(ckpt_dir)
    step = int(state.step)
    path = ckpt_dir / f"step-{step:08d}.npz"
    tree = {"params": params_to_jax(gathered_state_dict(state)), "opt_state": state.optimizer.state_tree()}
    if is_main_rank():
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        save_params(path, tree, meta={"step": step})
        existing = sorted(ckpt_dir.glob("step-*.npz"))
        for old in existing[:-keep]:
            old.unlink()
    if state.mesh is not None:
        dist.barrier()
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Optional[Path]:
    ckpts = sorted(Path(ckpt_dir).glob("step-*.npz"))
    return ckpts[-1] if ckpts else None


def restore_checkpoint(path: str | Path, like: TrainState) -> TrainState:
    """Load a checkpoint into `like` (a state made with the same model
    family and optimizer recipe; its parameter shapes must match) and return
    it: parameters and optimizer state are replaced in place. Raises
    ``ValueError`` where the file's ``step`` is not its optimizer count (the
    two packages count updates in both). A sharded `like` takes its slices
    of the split leaves and their moments."""
    flat, meta = load_flat(path)
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    state = params_from_jax(params)
    device = like.device
    like.model.net.load_state_dict({k: like.optimizer.part(k, v).to(device) for k, v in state.items()})
    like.optimizer.load_state_flat({k[len("opt_state/"):]: v for k, v in flat.items() if k.startswith("opt_state/")})
    if int(meta["step"]) != like.step:
        raise ValueError(f"the checkpoint's step {meta['step']} is not its optimizer count {like.step}")
    return like
