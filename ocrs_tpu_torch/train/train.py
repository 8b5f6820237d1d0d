"""Training states and steps for the OCR models (port of ``ocrs_tpu.train.train``).

On one device by default: one GPU, or the CPU asked for with
``device="cpu"``. Over several devices with ``mesh=`` (a
:class:`..parallel.distributed.Mesh` from :func:`make_mesh`, one process
per device, as the JAX package's ``("data", "model")`` mesh is one
device each):

  * ``"data"``: each rank steps on its rows of the global batch
    (:func:`shard_batch`), and the model is wrapped in
    ``DistributedDataParallel`` over the data group, which averages the
    gradients. Shards of equal size make that average of per-shard means the
    global mean, for the CTC mean and for BCE plus per-sample Dice alike; so
    a batch that does not split evenly raises ``ValueError``, as JAX's
    ``device_put`` refuses it. A step returns the global batch's loss.
  * ``"model"``: the recognizers' 2-D leaves whose path holds ``head``,
    ``proj``, ``wx``, ``ff1`` or ``ff2`` are split by their output columns
    over the model group (``_shard_leaf_specs_recognition``'s rule,
    :func:`is_split_leaf`), the rest replicated; the layers gather their
    output (:mod:`..models.nn`). The global norm of the clip is that of the
    whole arrays (:mod:`.optim`); Adam's moments live on each rank's slice.
    The detector is replicated over ``"model"``, as JAX replicates it.

Parameters are made on every rank from the same seed (or ``init_params``)
and then sliced, so the gathered state is the one-device state.

As in the JAX steps, a ``uint8`` batch is normalized on
the device (``/ 255 - 0.5``), the forward runs in bf16 activations with
float32 parameters, the loss is float32, and a step returns
``(state, loss)``. Unlike JAX's, the state is updated in place (the
parameters and the optimizer's moments and count) and returned; ``loss`` is a
0-d tensor on the device (``float(loss)`` waits for it).

The recognizers' GRU runs in the CUDA sequence kernel on the card, through
``ops.gru.BiGRUSequence``, whose backward recomputes through the plain loop
(``models.nn.bigru_apply``); ``state.model.net.plain_gru = True`` runs the
plain loop forward as well.

The models are initialized from a seeded ``torch.Generator`` (He-normal,
as the JAX package's init draws them; the numbers differ from
``jax.random``'s). ``init_params=`` takes a JAX-layout tree instead (e.g.
``models.weights.load_params`` of a weight file, or a JAX state's
``params``) and refuses one whose structure differs from the model's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from ..engine import resolve_device
from ..models import recognition_net
from ..models.detection_net import DetectionModel
from ..models.recognition_net import RecognitionModel
from ..models.weights import params_from_jax
from ..parallel.distributed import Mesh, make_mesh, mean_over  # noqa: F401 - make_mesh as JAX's train module has it
from ..parallel.sharding import shard_bounds
from .losses import ctc_loss, detection_loss
from .optim import Optimizer, Recipe

#: Path tags of the recognizers' leaves split over ``"model"``
#: (``ocrs_tpu/train/train.py::_shard_leaf_specs_recognition``).
SPLIT_TAGS = ("head", "proj", "wx", "ff1", "ff2")


def is_split_leaf(path: str, ndim: int) -> bool:
    """Whether a recognizer's leaf at `path` (``.``- or ``/``-joined) of
    `ndim` dimensions is split by its last dimension over ``"model"``: the
    2-D leaves whose path holds a tag of :data:`SPLIT_TAGS`."""
    return ndim == 2 and any(tag in path for tag in SPLIT_TAGS)


@dataclass
class TrainState:
    """A model (:class:`RecognitionModel` or :class:`DetectionModel`, its
    parameters requiring grad) and the optimizer bound to them. ``step``,
    the number of steps taken, is the optimizer's update count. Under a
    `mesh`, `net` is ``model.net`` wrapped in ``DistributedDataParallel``
    over the data group (the steps run their forward through it), and the
    model holds this rank's slices of the split leaves; otherwise `net` is
    ``model.net``."""

    model: Any
    optimizer: Optimizer
    mesh: Optional[Mesh] = None
    net: Optional[nn.Module] = None

    def __post_init__(self):
        if self.net is None:
            self.net = self.model.net

    @property
    def step(self) -> int:
        return self.optimizer.count

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def _check_structure(model: torch.nn.Module, init_params: Any) -> None:
    """``init_params`` must hold the leaves of `model`'s tree, no more and no
    fewer (``train.py``'s ``jax.tree.structure`` check); shapes may differ."""
    want = set(model.state_dict())
    given = set(params_from_jax(init_params))
    if want != given:
        raise ValueError(
            f"init_params tree mismatch: missing {sorted(want - given)}, unexpected {sorted(given - want)}"
        )


def _split_model_(net: nn.Module, group) -> frozenset[str]:
    """Split `net`'s leaves of :func:`is_split_leaf` over the model `group`
    (each owning layer keeps its slice); returns their names."""
    names = [name for name, p in net.named_parameters() if is_split_leaf(name, p.ndim)]
    for name in names:
        owner, leaf = name.rsplit(".", 1)
        layer = net.get_submodule(owner)
        if not hasattr(layer, "split_columns_") or leaf not in ("w", "wx"):
            raise ValueError(f"{name}: no layer of the port splits this leaf")
        layer.split_columns_(group)
    return frozenset(names)


def _trainable(model: nn.Module, optimizer: Recipe, device, mesh: Optional[Mesh] = None, split: bool = False) -> TrainState:
    """`model` made trainable on `device`, bound to `optimizer`. Under a
    `mesh`: on the mesh's device, its split leaves sliced (where `split`
    and the model group has more than one rank) and wrapped in DDP."""
    if mesh is None:
        model = model.to(resolve_device(device)).requires_grad_(True)
        return TrainState(model=model, optimizer=optimizer.init(model.net))
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"the state's device {device} is not the mesh's {mesh.device}")
    group = mesh.model_group if split and mesh.model_size > 1 else None
    names = _split_model_(model.net, group) if group is not None else frozenset()
    model = model.to(resolve_device(mesh.device)).requires_grad_(True)
    net = nn.parallel.DistributedDataParallel(
        model.net,
        device_ids=[mesh.device] if mesh.device.type == "cuda" else None,
        process_group=mesh.data_group,
    )
    return TrainState(model=model, optimizer=optimizer.init(model.net, split=names, model_group=group), mesh=mesh, net=net)


def shard_batch(mesh: Optional[Mesh], *arrays):
    """This rank's rows of each global batch array: the ``data_rank``-th of
    ``data_size`` equal contiguous slices of the leading dimension (numpy
    views or tensor slices). Raises ``ValueError`` where a batch does not
    split evenly. Without a mesh the arrays come back as they are. One
    array comes back alone, several as a tuple (as JAX's ``shard_batch``)."""
    out = []
    for a in arrays:
        if mesh is not None:
            start, stop = shard_bounds(len(a), mesh.data_size)[mesh.data_rank]
            a = a[start:stop]
        out.append(a)
    return tuple(out) if len(out) != 1 else out[0]


def gathered_state_dict(state: TrainState) -> dict[str, torch.Tensor]:
    """The model's state dict with the split leaves gathered whole over the
    model group (a collective: every rank of the group calls it)."""
    return {name: state.optimizer.whole(name, t) for name, t in state.model.net.state_dict().items()}


def global_loss(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """The global batch's loss: the mean over the data group of the ranks'
    losses (equal shards), or `loss` itself on one device."""
    loss = loss.detach()
    if state.mesh is None or state.mesh.data_size == 1:
        return loss
    return mean_over(state.mesh.data_group, loss)


def _on(x, device: torch.device) -> torch.Tensor:
    """An array or tensor on `device`."""
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device, non_blocking=True)


def _batch(x, device: torch.device) -> torch.Tensor:
    """An image batch on the device; ``uint8`` images normalized there to
    [-0.5, 0.5] (a quarter of the bytes cross to the card)."""
    x = _on(x, device)
    return x.to(torch.float32) / 255.0 - 0.5 if x.dtype == torch.uint8 else x.to(torch.float32)


def _check_state(state: TrainState, optimizer: Recipe, mesh: Optional[Mesh]) -> None:
    if state.optimizer.recipe != optimizer:
        raise ValueError("the train state's optimizer was made from another recipe than this step's")
    if state.mesh is not mesh:
        raise ValueError("the train state was made over another mesh than this step's")


def init_recognition_state(
    optimizer: Recipe,
    n_classes: int = 97,
    hidden: int = recognition_net.DEFAULT_HIDDEN,
    seed: int = 0,
    arch: str = "crnn",
    init_params: Any = None,
    device: torch.device | str | None = None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """A recognizer of `arch` ("crnn" at GRU size `hidden`, or "convctc")
    and `optimizer` bound to it, on `device` (CUDA by default).
    ``init_params``: a JAX-layout tree for a warm start (fine-tuning); its
    tree must be the arch's. `mesh`: this rank's slice of the state over a
    ``("data", "model")`` mesh, on the mesh's device (see the module
    docstring); raises ``ValueError`` where a split leaf's columns do not
    divide by the model group's size."""
    model = RecognitionModel.create(seed=seed, n_classes=n_classes, hidden=hidden, arch=arch)
    if init_params is not None:
        _check_structure(model.net, init_params)
        model = RecognitionModel(init_params, arch=arch)
    return _trainable(model, optimizer, device, mesh, split=True)


def recognition_loss(
    model: RecognitionModel, images, labels, label_lengths, dtype: torch.dtype = torch.bfloat16,
    net: Optional[nn.Module] = None,
) -> torch.Tensor:
    """Mean CTC loss of `model` on a batch (differentiable): images
    [N, 1, 64, W] (``uint8`` or normalized float), labels [N, L] (0 pads),
    label_lengths [N]. `dtype` is the activation dtype (bf16 as in training;
    float32 for equivalence checks). `net` runs the forward: a sharded
    state's ``net`` (its DDP wrapper); ``model.net`` by default."""
    device = next(model.parameters()).device
    logprobs = (net or model.net)(_batch(images, device), dtype)  # [T, N, C]
    return ctc_loss(logprobs, labels, label_lengths)


def apply_gradients(state: TrainState, loss: torch.Tensor) -> TrainState:
    """Differentiate `loss` into the model's parameters and take one
    optimizer update: ``value_and_grad``, ``optimizer.update`` and
    ``apply_updates`` of the JAX steps. Returns `state`, one step on."""
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    return state


def make_recognition_train_step(
    optimizer: Recipe, arch: str = "crnn", mesh: Optional[Mesh] = None
) -> Callable[[TrainState, Any, Any, Any], tuple[TrainState, torch.Tensor]]:
    """``step(state, images, labels, label_lengths) -> (state, loss)``: one
    bf16 update of a recognizer made by :func:`init_recognition_state` with
    the same `optimizer`, `arch` and `mesh`. Under a mesh the arrays are
    this rank's rows (:func:`shard_batch`) and `loss` is the global batch's."""

    def step(state: TrainState, images, labels, label_lengths):
        _check_state(state, optimizer, mesh)
        if state.model.arch != arch:
            raise ValueError(f"the train state holds a {state.model.arch} recognizer, this step trains {arch}")
        loss = recognition_loss(state.model, images, labels, label_lengths, net=state.net)
        return apply_gradients(state, loss), global_loss(state, loss)

    return step


def init_detection_state(
    optimizer: Recipe,
    seed: int = 0,
    init_params: Any = None,
    device: torch.device | str | None = None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """The U-Net and `optimizer` bound to it, on `device` (CUDA by default).
    ``init_params``: a JAX-layout tree for a warm start; its tree must be the
    U-Net's (channel widths may differ). `mesh`: replicated over the mesh,
    on its device, the data split in DDP."""
    model = DetectionModel.create(seed=seed)
    if init_params is not None:
        _check_structure(model.net, init_params)
        model = DetectionModel(init_params)
    return _trainable(model, optimizer, device, mesh)


def detection_loss_of(model: DetectionModel, images, targets, net: Optional[nn.Module] = None) -> torch.Tensor:
    """BCE + Dice of `model` on a batch (differentiable): images
    [N, 1, H, W] (``uint8`` or normalized float), targets [N, 1, H, W] in
    {0, 1} (``uint8`` or float). `net` runs the forward (see
    :func:`recognition_loss`)."""
    device = next(model.parameters()).device
    return detection_loss((net or model.net)(_batch(images, device)), _on(targets, device).to(torch.float32))


def make_detection_train_step(
    optimizer: Recipe, mesh: Optional[Mesh] = None
) -> Callable[[TrainState, Any, Any], tuple[TrainState, torch.Tensor]]:
    """``step(state, images, targets) -> (state, loss)``: one update of a
    detector made by :func:`init_detection_state` with the same `optimizer`
    and `mesh` (under which the arrays are this rank's rows and `loss` is
    the global batch's)."""

    def step(state: TrainState, images, targets):
        _check_state(state, optimizer, mesh)
        loss = detection_loss_of(state.model, images, targets, net=state.net)
        return apply_gradients(state, loss), global_loss(state, loss)

    return step
