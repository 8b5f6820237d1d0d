"""The optax recipes the repository trains with, on ``torch.optim``.

``ocrs_tpu`` trains with ``optax.adam(lr)`` / ``optax.adamw(lr)`` (the
demo, the tests) and with ``optax.chain(optax.clip_by_global_norm(1.0),
optax.adamw(warmup_cosine_decay_schedule(...), weight_decay=1e-4))``
(``tools/train_models.py``). This module gives those recipes with optax's
numbers:

  * :func:`adam` / :func:`adamw`: optax's b1 0.9, b2 0.999 and eps 1e-8
    (outside the root of the bias-corrected second moment), fixed; ``adamw``'s ``weight_decay``
    defaults to optax's 1e-4 (``torch.optim.AdamW``'s is 1e-2) and is
    applied to the parameters before the update, scaled by the learning
    rate, as both libraries do.
  * :func:`clip_by_global_norm`: ``g * max_norm / norm`` where the global
    norm is at least `max_norm`, as optax clips (``clip_grad_norm_`` adds
    1e-6 to the norm).
  * :func:`warmup_cosine_decay_schedule`: optax's schedule (decaying to 0,
    as the repository uses it), evaluated at the
    number of updates made before this one, as optax evaluates it: with
    ``init_value=0.0`` the first update is zero (the moments still move).
  * :func:`chain` takes ``(clip_by_global_norm(...), adam|adamw(...))``
    only: the one chain the repository uses.

A recipe is bound to a model's parameters by :meth:`Recipe.init`, as
``optimizer.init(params)`` makes optax's state; the bound :class:`Optimizer`
steps ``torch.optim.Adam`` / ``AdamW`` on the gradients autograd left in
``.grad``. :meth:`Optimizer.state_tree` and :meth:`Optimizer.load_state_flat`
read and write the state where optax keeps it (the update count, ``mu`` and
``nu``; the schedule's count), so that a checkpoint crosses between the two
packages (:mod:`.checkpoint`).

Over a ``"model"`` group (:mod:`.train`'s column split) an optimizer is
bound to this rank's slices of the split parameters: Adam's moments live on
the slices, the clip's global norm is that of the whole arrays (the split
leaves' squares summed over the group, the replicated ones counted once, as
optax takes it under XLA), and the state tree holds the moments whole.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.distributed import column_slice, gather_columns

Schedule = Callable[[int], float]

# optax's Adam constants (the repository never sets others).
B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` with its defaults
    (``end_value=0``, ``exponent=1``): linear from `init_value` to
    `peak_value` over `warmup_steps`, then cosine decay to 0 at
    `decay_steps` (which counts the warmup), held there after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps}, {warmup_steps}")
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * max(count, 0) / warmup_steps
        t = min(count - warmup_steps, cosine_steps)
        return peak_value * 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))

    return schedule


@dataclass(frozen=True)
class ClipByGlobalNorm:
    """``optax.clip_by_global_norm(max_norm)``; only as the first link of
    :func:`chain`."""

    max_norm: float


@dataclass(frozen=True)
class Recipe:
    """Adam or AdamW (``weight_decay`` not None), optionally behind a global
    norm clip: the optax transformations this package reproduces."""

    learning_rate: float | Schedule
    weight_decay: float | None = None
    clip_norm: float | None = None

    def init(self, module: nn.Module, split: frozenset[str] = frozenset(), model_group=None) -> "Optimizer":
        """Bind the recipe to `module`'s parameters (zero moments, count 0).
        `split`: the names of the parameters that are this rank's column
        slice over `model_group`."""
        return Optimizer(self, dict(module.named_parameters()), split, model_group)

    # Where optax keeps the state of this recipe, under ``opt_state/``: the
    # Adam state (count, mu, nu), and the schedule's count where the
    # learning rate is a schedule (adam: second link; adamw: third, after
    # the weight decay). A chain puts both under its second link.
    def _prefix(self) -> str:
        return "1/" if self.clip_norm is not None else ""

    def _schedule_link(self) -> str | None:
        if not callable(self.learning_rate):
            return None
        return "1" if self.weight_decay is None else "2"


def adam(learning_rate: float | Schedule) -> Recipe:
    """``optax.adam`` with its default betas and eps."""
    return Recipe(learning_rate)


def adamw(learning_rate: float | Schedule, weight_decay: float = 1e-4) -> Recipe:
    """``optax.adamw`` with its default betas and eps, and its default
    ``weight_decay`` of 1e-4."""
    return Recipe(learning_rate, weight_decay=weight_decay)


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    """``optax.clip_by_global_norm``."""
    return ClipByGlobalNorm(float(max_norm))


def chain(*transforms) -> Recipe:
    """``optax.chain(clip_by_global_norm(m), adam|adamw(...))``: the one
    chain the repository trains with. Other chains raise ``ValueError``."""
    if (
        len(transforms) == 2
        and isinstance(transforms[0], ClipByGlobalNorm)
        and isinstance(transforms[1], Recipe)
        and transforms[1].clip_norm is None
    ):
        return replace(transforms[1], clip_norm=transforms[0].max_norm)
    raise ValueError("chain takes (clip_by_global_norm(...), adam(...) or adamw(...)) only")


def clip_grads_by_global_norm_(
    grads: list[torch.Tensor], max_norm: float, split: list[bool] | None = None, model_group=None
) -> torch.Tensor:
    """Scale `grads` in place by ``max_norm / norm`` where their global norm
    is at least `max_norm` (optax's rule, on the device, no host read).
    With a `model_group`, the grads marked in `split` are slices of arrays
    split over it: their squares are summed over the group, so that the
    norm is that of the whole arrays. Returns the norm."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if model_group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(split, device=norms.device)
        squares = norms.square()
        split_sq = squares[mask].sum()
        dist.all_reduce(split_sq, group=model_group)
        norm = torch.sqrt(squares[~mask].sum() + split_sq)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class Optimizer:
    """A :class:`Recipe` bound to named parameters: ``zero_grad``, then
    ``loss.backward()``, then :meth:`step`, as optax's ``update`` and
    ``apply_updates`` follow ``value_and_grad``. ``count`` is optax's update
    count; ``grad_norm`` the global norm the last clipped update measured."""

    def __init__(
        self,
        recipe: Recipe,
        named_params: Mapping[str, nn.Parameter],
        split: frozenset[str] = frozenset(),
        model_group=None,
    ):
        self.recipe = recipe
        self.named_params = dict(named_params)
        self.split = frozenset(split) if model_group is not None else frozenset()
        self.model_group = model_group
        self.grad_norm: torch.Tensor | None = None
        params = list(self.named_params.values())
        common = {"lr": self.learning_rate(0), "betas": (B1, B2), "eps": EPS}
        if recipe.weight_decay is None:
            self.torch = torch.optim.Adam(params, **common)
        else:
            self.torch = torch.optim.AdamW(params, weight_decay=recipe.weight_decay, **common)
        self.count = 0

    def learning_rate(self, count: int | None = None) -> float:
        """The learning rate of the update after `count` updates (default:
        the next one)."""
        lr = self.recipe.learning_rate
        return float(lr(self.count if count is None else count)) if callable(lr) else float(lr)

    def zero_grad(self) -> None:
        self.torch.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the gradients in ``.grad``. A parameter without a
        gradient takes a zero one, so that its moments decay as optax's do."""
        params = list(self.named_params.values())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.recipe.clip_norm is not None:
            self.grad_norm = clip_grads_by_global_norm_(
                [p.grad for p in params], self.recipe.clip_norm,
                [name in self.split for name in self.named_params], self.model_group,
            )
        lr = self.learning_rate()
        for group in self.torch.param_groups:
            group["lr"] = lr
        self.torch.step()
        self.count += 1

    def whole(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """`tensor` (parameter `name`, or a tensor in its layout) whole: the
        model group's slices gathered where `name` is split (a collective),
        else `tensor` itself."""
        if name not in self.split:
            return tensor
        with torch.no_grad():
            return gather_columns(tensor.detach(), self.model_group)

    def part(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole `tensor` in parameter `name`'s
        layout (`tensor` itself where `name` is not split)."""
        if name not in self.split:
            return tensor
        return tensor[..., column_slice(tensor.shape[-1], self.model_group)]

    def _moments(self, key: str) -> dict[str, torch.Tensor]:
        """Adam's moment `key` of every parameter, whole."""
        return {
            name: self.whole(name, self.torch.state[p][key] if p in self.torch.state else torch.zeros_like(p))
            for name, p in self.named_params.items()
        }

    def state_tree(self) -> dict:
        """optax's ``opt_state`` of this recipe as a tree of string-keyed
        dicts (optax's empty states left out, as the flat file leaves them
        out), the moments whole in the JAX layout, numpy leaves. A
        collective where parameters are split: every rank of the model group
        calls it."""
        from ..models.weights import params_to_jax

        count = np.asarray(self.count, dtype=np.int32)
        tree = {"0": {"0": count, "1": params_to_jax(self._moments("exp_avg")),
                      "2": params_to_jax(self._moments("exp_avg_sq"))}}
        link = self.recipe._schedule_link()
        if link is not None:
            tree[link] = {"0": count}
        return {"1": tree} if self.recipe.clip_norm is not None else tree

    def load_state_flat(self, flat: Mapping[str, np.ndarray]) -> None:
        """Load the state from a checkpoint's ``opt_state/...`` entries (keys
        without that prefix, ``/``-joined): count, ``mu`` and ``nu`` where
        optax keeps them for this recipe. Raises ``ValueError`` when they
        are not there or do not cover the parameters. The moments are whole
        in the file; a rank keeps its slices of the split ones."""
        from ..models.weights import params_from_jax

        pre = self.recipe._prefix()
        try:
            count = int(flat[f"{pre}0/0"])
            moments = [
                params_from_jax({k[len(f"{pre}0/{i}/"):]: v for k, v in flat.items() if k.startswith(f"{pre}0/{i}/")})
                for i in (1, 2)
            ]
        except KeyError as exc:
            raise ValueError(f"the checkpoint has no optimizer state of this recipe ({exc})") from None
        link = self.recipe._schedule_link()
        if link is not None and int(flat.get(f"{pre}{link}/0", count)) != count:
            raise ValueError("the checkpoint's schedule count differs from its Adam count")
        for mom in moments:
            if set(mom) != set(self.named_params):
                raise ValueError("the checkpoint's optimizer moments do not match the parameters")
        step = torch.tensor(float(count), dtype=torch.get_default_dtype())
        for name, p in self.named_params.items():
            self.torch.state[p] = {
                "step": step.clone(),
                "exp_avg": self.part(name, moments[0][name]).to(device=p.device, dtype=p.dtype).contiguous(),
                "exp_avg_sq": self.part(name, moments[1][name]).to(device=p.device, dtype=p.dtype).contiguous(),
            }
        self.count = count
