"""Training states and steps for the OCR models on one device.

Port of ``ocrs_tpu.train.train`` without the mesh: one GPU (or the CPU,
asked for with ``device="cpu"``) and no batch sharding; more than one device
is a later slice. As in the JAX steps, a ``uint8`` batch is normalized on
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
from typing import Any, Callable

import numpy as np
import torch

from ..engine import resolve_device
from ..models import recognition_net
from ..models.detection_net import DetectionModel
from ..models.recognition_net import RecognitionModel
from ..models.weights import params_from_jax
from .losses import ctc_loss, detection_loss
from .optim import Optimizer, Recipe


@dataclass
class TrainState:
    """A model (:class:`RecognitionModel` or :class:`DetectionModel`, its
    parameters requiring grad) and the optimizer bound to them. ``step``,
    the number of steps taken, is the optimizer's update count."""

    model: Any
    optimizer: Optimizer

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


def _trainable(model: torch.nn.Module, optimizer: Recipe, device) -> TrainState:
    model = model.to(resolve_device(device)).requires_grad_(True)
    return TrainState(model=model, optimizer=optimizer.init(model.net))


def _on(x, device: torch.device) -> torch.Tensor:
    """An array or tensor on `device`."""
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device, non_blocking=True)


def _batch(x, device: torch.device) -> torch.Tensor:
    """An image batch on the device; ``uint8`` images normalized there to
    [-0.5, 0.5] (a quarter of the bytes cross to the card)."""
    x = _on(x, device)
    return x.to(torch.float32) / 255.0 - 0.5 if x.dtype == torch.uint8 else x.to(torch.float32)


def _check_state(state: TrainState, optimizer: Recipe) -> None:
    if state.optimizer.recipe != optimizer:
        raise ValueError("the train state's optimizer was made from another recipe than this step's")


def init_recognition_state(
    optimizer: Recipe,
    n_classes: int = 97,
    hidden: int = recognition_net.DEFAULT_HIDDEN,
    seed: int = 0,
    arch: str = "crnn",
    init_params: Any = None,
    device: torch.device | str | None = None,
) -> TrainState:
    """A recognizer of `arch` ("crnn" at GRU size `hidden`, or "convctc")
    and `optimizer` bound to it, on `device` (CUDA by default).
    ``init_params``: a JAX-layout tree for a warm start (fine-tuning); its
    tree must be the arch's."""
    model = RecognitionModel.create(seed=seed, n_classes=n_classes, hidden=hidden, arch=arch)
    if init_params is not None:
        _check_structure(model.net, init_params)
        model = RecognitionModel(init_params, arch=arch)
    return _trainable(model, optimizer, device)


def recognition_loss(
    model: RecognitionModel, images, labels, label_lengths, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Mean CTC loss of `model` on a batch (differentiable): images
    [N, 1, 64, W] (``uint8`` or normalized float), labels [N, L] (0 pads),
    label_lengths [N]. `dtype` is the activation dtype (bf16 as in training;
    float32 for equivalence checks)."""
    device = next(model.parameters()).device
    logprobs = model.net(_batch(images, device), dtype)  # [T, N, C]
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
    optimizer: Recipe, arch: str = "crnn"
) -> Callable[[TrainState, Any, Any, Any], tuple[TrainState, torch.Tensor]]:
    """``step(state, images, labels, label_lengths) -> (state, loss)``: one
    bf16 update of a recognizer made by :func:`init_recognition_state` with
    the same `optimizer` and `arch`."""

    def step(state: TrainState, images, labels, label_lengths):
        _check_state(state, optimizer)
        if state.model.arch != arch:
            raise ValueError(f"the train state holds a {state.model.arch} recognizer, this step trains {arch}")
        loss = recognition_loss(state.model, images, labels, label_lengths)
        return apply_gradients(state, loss), loss.detach()

    return step


def init_detection_state(
    optimizer: Recipe,
    seed: int = 0,
    init_params: Any = None,
    device: torch.device | str | None = None,
) -> TrainState:
    """The U-Net and `optimizer` bound to it, on `device` (CUDA by default).
    ``init_params``: a JAX-layout tree for a warm start; its tree must be the
    U-Net's (channel widths may differ)."""
    model = DetectionModel.create(seed=seed)
    if init_params is not None:
        _check_structure(model.net, init_params)
        model = DetectionModel(init_params)
    return _trainable(model, optimizer, device)


def detection_loss_of(model: DetectionModel, images, targets) -> torch.Tensor:
    """BCE + Dice of `model` on a batch (differentiable): images
    [N, 1, H, W] (``uint8`` or normalized float), targets [N, 1, H, W] in
    {0, 1} (``uint8`` or float)."""
    device = next(model.parameters()).device
    return detection_loss(model.net(_batch(images, device)), _on(targets, device).to(torch.float32))


def make_detection_train_step(
    optimizer: Recipe,
) -> Callable[[TrainState, Any, Any], tuple[TrainState, torch.Tensor]]:
    """``step(state, images, targets) -> (state, loss)``: one update of a
    detector made by :func:`init_detection_state` with the same
    `optimizer`."""

    def step(state: TrainState, images, targets):
        _check_state(state, optimizer)
        loss = detection_loss_of(state.model, images, targets)
        return apply_gradients(state, loss), loss.detach()

    return step
