"""Training over a ``("data", "model")`` mesh: the port's sharded steps in
spawned ``gloo`` ranks on the CPU against its one-device steps and against
the JAX package's sharded steps on ``make_mesh(2, model_parallel=2)`` (the 8
virtual JAX CPU devices of tests/conftest.py).

Meshes data 2 x model 1 and data 1 x model 2 (two ranks) and data 2 x
model 2 (four ranks), each spawned once for the module (a store under
``tmp_path``, a 60 s collective timeout and a join deadline), on:

  * the CRNN at n_classes 12, hidden 32 (tests/test_parallel.py's shapes);
  * ConvCTC at n_classes 24 (dim 32);
  * a narrow U-Net, data split only.

Each case takes two updates of one batch of 4 from the same parameters
under ``adam(1e-3)`` and under ``tools/train_models.py``'s chain:

  * float32 (the recognizers): the loss, the clip's global norm and the
    first update's gathered gradients (by relative norm) equal the
    one-device step's within 1e-5 relative, and so do the gathered
    parameters (+ 1e-6, the float32 parameter bound of
    tests/test_torch_train_step.py) wherever the one-device gradient is
    clear of float32 noise: above a thousandth of its leaf's root mean
    square. Below that the two sums, taken in other orders, differ by a
    large part of the gradient, and Adam's normalized update carries that
    up to its rate: those entries (a few in 10,000; their gradients at
    1e-6 to 1.4e-4 of the root mean square) are held within the rates
    summed + 1e-6. A sharded checkpoint's file equals the one-device
    state's key for key by the same rule, and the state restored from it
    into a fresh sharded state takes one more step to the one-device
    state's.
  * bf16 (the real train steps): loss and gathered parameters against the
    JAX package's sharded step by the bf16 criteria of
    tests/test_torch_train_step.py (loss 1e-2 relative; parameters within
    2 * the summed rates + 1e-6; the recognizers' updates take JAX's sign
    where its gradient is clear of bf16 noise); the U-Net also against the
    port's one-device step by the same bounds.

Uneven worlds, batches and splits raise ``ValueError`` in the ranks.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocrs_tpu.models import detection_net as jdet
from ocrs_tpu.models import recognition_net as jrec
from ocrs_tpu.train import train as jtrain
from ocrs_tpu_torch.models.detection_net import DetectionModel
from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from ocrs_tpu_torch.models.weights import params_to_jax
from ocrs_tpu_torch.parallel.dryrun import TrainCase, run_train_case, run_train_cases
from ocrs_tpu_torch.train import train as ttrain
from tests.test_torch_train_detection import NARROW_UNET
from tests.test_torch_train_models import _zeros_like_init
from tests.test_torch_train_step import (
    BF16_LOSS_RTOL,
    F32_PARAM_ATOL,
    _jax_rec_loss,
    _leaves,
)

LR = 1e-3
STEPS = 2
RECIPES = {"adam": ("adam", LR), "chain": ("chain", LR, 2, 11)}
# The rates of the two updates: adam's, and the chain's schedule (0 at the
# first update, LR / 2 at the second, warmup over 2 updates).
LR_TOTAL = {"adam": 2 * LR, "chain": LR / 2}
# The rate of the extra step after a restore (the chain's third update is
# at the schedule's peak).
LR_EXTRA = {"adam": LR, "chain": LR}
# Gradient entries below this share of their leaf's root mean square are
# float32 noise for Adam's normalized update.
F32_NOISE_FLOOR = 1e-3
F32_RTOL = 1e-5
N_CLASSES = {"crnn": 12, "convctc": 24}
MESHES = {2: (1, 2), 4: (2,)}  # world -> model splits (data = world / split)


def _optax(name):
    if name == "adam":
        return optax.adam(LR)
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=2, decay_steps=11)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(schedule, weight_decay=1e-4))


def _rec_params(arch, seed=1):
    gen = torch.Generator().manual_seed(seed)
    model = RecognitionModel(None, arch, n_classes=N_CLASSES[arch], hidden=32, generator=gen)
    tree = params_to_jax(model.net.state_dict())
    rng = np.random.default_rng(seed)
    # Non-zero biases and norm scales, so that they are held too.
    return jax.tree.map(lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim == 1 else a, tree)


def _rec_batch(arch, seed=0, n=4, width=32):
    rng = np.random.default_rng(seed)
    images = (rng.normal(size=(n, 1, 64, width)) * 0.3).astype(np.float32)
    lengths = rng.integers(1, 4, size=n).astype(np.int32)
    labels = np.zeros((n, 3), np.int32)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.integers(1, N_CLASSES[arch], size=k)
    return images, labels, lengths


def _unet_params(seed=2):
    model = DetectionModel(None, channels=NARROW_UNET, generator=torch.Generator().manual_seed(seed))
    return params_to_jax(model.net.state_dict())


def _det_batch(seed=3, n=4, hw=64):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, 1, hw, hw), dtype=np.uint8)
    targets = np.zeros((n, 1, hw, hw), np.uint8)
    targets[:, :, 20:30, 8:50] = 1
    targets[1::2, :, 40:48, 16:40] = 1
    return images, targets


def _cases(world):
    """The cases of a world of `world` ranks, by name."""
    cases = []
    for split in MESHES[world]:
        for arch in ("crnn", "convctc"):
            params, b = _rec_params(arch), _rec_batch(arch)
            for recipe in RECIPES:
                common = dict(kind="recognition", params=params, batches=[b] * STEPS, recipe=RECIPES[recipe],
                              arch=arch, model_parallel=split)
                cases.append(TrainCase(f"{arch}-m{split}-{recipe}-float32", dtype="float32", checkpoint=True,
                                       extra_batch=_rec_batch(arch, seed=5), **common))
                cases.append(TrainCase(f"{arch}-m{split}-{recipe}-bfloat16", dtype="bfloat16",
                                       gru_check=arch == "crnn", **common))
    if world == 2:
        for recipe in RECIPES:
            cases.append(TrainCase(f"unet-m1-{recipe}-bfloat16", "detection", _unet_params(), [_det_batch()] * STEPS,
                                   RECIPES[recipe], model_parallel=1))
    return cases


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case of both worlds in spawned gloo ranks (rank 0's results),
    and the same cases on one device in this process. The two worlds run
    beside each other while this process computes the one-device and the
    JAX references."""
    works = {world: tmp_path_factory.mktemp(f"world{world}") for world in MESHES}

    def run_worlds():
        return {world: run_train_cases(_cases(world), world, device="cpu", refusals=True, timeout=300,
                                       work_dir=works[world]) for world in MESHES}

    with ThreadPoolExecutor(max_workers=1) as pool:
        worlds = pool.submit(run_worlds)
        # One device's run does not depend on the mesh: one per model, recipe
        # and dtype, where a test reads it (float32, and the U-Net's bf16).
        single = {}
        for world in MESHES:
            for case in _cases(world):
                key = _single_key(case.name)
                if key not in single and (case.dtype == "float32" or case.kind == "detection"):
                    single[key] = run_train_case(case, None, device="cpu", ckpt_dir=works[world] / "single" / key)
        for model in ("crnn", "convctc", "unet"):
            for recipe in RECIPES:
                _jax_sharded_run(model, recipe)
                if model != "unet":
                    _jax_bf16_grads(model, recipe)
        out = worlds.result()
    return out, single


def _single_key(name):
    """A case's name without its mesh ("crnn-m2-adam-float32" ->
    "crnn-adam-float32")."""
    model, _, recipe, dtype = name.split("-")
    return f"{model}-{recipe}-{dtype}"


def _case_names(world, dtype):
    return [(world, c.name) for c in _cases(world) if c.name.endswith(dtype)]


def _clear(g):
    """Entries of a gradient leaf clear of float32 noise; exact zeros (units
    a ReLU shut) are exact on both sides."""
    return (np.abs(g) > F32_NOISE_FLOOR * np.sqrt(np.mean(np.square(g, dtype=np.float64)))) | (g == 0)


def _f32_close(got, want, grads, lr_total, what):
    """`got` within F32_RTOL (+ F32_PARAM_ATOL) of `want` where each of
    `grads` (the one-device gradients of the updates, keyed as the
    parameters; the optimizer state's leaves end in a parameter's key) is
    clear of float32 noise, and within `lr_total` + 1e-6 elsewhere."""
    for k in want:
        gs = [next((v for name, v in g.items() if k == name or k.endswith("/" + name)), None) for g in grads]
        if gs[0] is None or gs[0].shape != want[k].shape:
            np.testing.assert_allclose(got[k], want[k], rtol=F32_RTOL, atol=F32_PARAM_ATOL, err_msg=f"{what} {k}")
            continue
        clear = np.logical_and.reduce([_clear(g) for g in gs])
        assert clear.mean() > 0.5, f"{what} {k}: {clear.mean()} of the entries are clear of noise"
        np.testing.assert_allclose(got[k][clear], want[k][clear], rtol=F32_RTOL, atol=F32_PARAM_ATOL,
                                   err_msg=f"{what} {k}")
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=lr_total + 1e-6, err_msg=f"{what} {k}")


@pytest.mark.parametrize("world, name", [(w, n) for w, n in _case_names(2, "bfloat16") + _case_names(4, "bfloat16")
                                          if n.startswith("crnn")])
def test_the_rank_holds_the_gru_kernel_against_its_plain_version(spawned, world, name):
    """Each rank keeps its first step's input to ``gru1`` (its rows of the
    batch; the whole width under a model split, whose projections it
    gathers) and holds the kernel against the plain version on it: on the
    CPU both are the plain version, so they agree exactly."""
    results, _ = spawned
    got = results[world][name]
    data = got["mesh"]["data"]
    n, _, _, width = _rec_batch("crnn")[0].shape
    assert got["gru_check"] == {"input_shape": [n // data, width // 4, 32], "max_abs_err": 0.0}


@pytest.mark.parametrize("world, name", _case_names(2, "float32") + _case_names(4, "float32"))
def test_float32_steps_equal_the_one_device_steps(spawned, world, name):
    results, single = spawned
    got, want = results[world][name], single[_single_key(name)]
    data, model = world // int(name.split("-")[1][1:]), int(name.split("-")[1][1:])
    assert got["mesh"] == {"data": data, "model": model} and got["device"] == "cpu"
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_RTOL)
    if "chain" in name:
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=F32_RTOL)
        assert all(n > 1.0 for n in want["grad_norms"])  # the clip scaled the updates
    assert got["params"].keys() == want["params"].keys() == got["grads"][0].keys()
    grads = want["grads"][0]
    for k, g in grads.items():
        assert np.linalg.norm(got["grads"][0][k] - g) <= F32_RTOL * np.linalg.norm(g), k
    recipe = name.split("-")[2]
    _f32_close(got["params"], want["params"], [grads], LR_TOTAL[recipe], "params")
    # The split leaves are JAX's (tests/test_torch_sharding.py), all of them.
    if model > 1:
        assert got["split"] and all(ttrain.is_split_leaf(n, 2) for n in got["split"])
    else:
        assert got["split"] == []
    # The checkpoint: the one-device state's file, key for key; restored
    # into a fresh sharded state, one more step to the one-device state's.
    assert got["checkpoint"].keys() == want["checkpoint"].keys()
    _f32_close(got["checkpoint"], want["checkpoint"], [grads], LR_TOTAL[recipe], "checkpoint")
    _f32_close(got["after_restore_step"], want["after_restore_step"], [grads, want["extra_grads"]],
               LR_TOTAL[recipe] + LR_EXTRA[recipe], "restored + 1 step")
    # DDP averaged the GRU's gradients too (its autograd.Function returns
    # them): every rank of a data split holds the same recurrent weights.
    assert got["gru_launches_by_rank"] == [0] * world  # the plain GRU on the CPU


def _jax_sharded(name):
    """The JAX package's sharded steps of case `name` (world 2 or 4's) on
    make_mesh(2, model_parallel=2): the first loss, the parameters after
    the first update (a tree) and after the last (leaves); the same for
    every mesh of the port."""
    model, _, recipe, _ = name.split("-")
    return _jax_sharded_run(model, recipe)


@functools.lru_cache(maxsize=None)
def _jax_sharded_run(model, recipe):
    case = next(c for c in _cases(2) if c.name == f"{model}-m1-{recipe}-bfloat16")
    jopt = _optax(recipe)
    mesh = jtrain.make_mesh(2, model_parallel=2)
    with pytest.MonkeyPatch.context() as mp, mesh:
        # The JAX init only fixes the tree that init_params replaces (its
        # eager random draws cost seconds here).
        mp.setattr(jrec, "init_params", _zeros_like_init(jrec.init_params))
        for arch, (init, apply) in list(jrec.ARCHS.items()):
            mp.setitem(jrec.ARCHS, arch, (_zeros_like_init(init), apply))
        mp.setattr(jdet, "init_params", _zeros_like_init(jdet.init_params))
        if case.kind == "recognition":
            state = jtrain.init_recognition_state(mesh, jopt, n_classes=N_CLASSES[case.arch], hidden=32,
                                                  arch=case.arch, init_params=case.params)
            step = jtrain.make_recognition_train_step(mesh, jopt, arch=case.arch)
        else:
            state = jtrain.init_detection_state(mesh, jopt, init_params=case.params)
            step = jtrain.make_detection_train_step(mesh, jopt)
        losses, after = [], []
        for batch in case.batches:
            state, loss = step(state, *jtrain.shard_batch(mesh, *map(jnp.asarray, batch)))
            losses.append(float(loss))
            after.append(jax.device_get(state.params))
        return losses[0], after[0], _leaves(after[-1])


@functools.lru_cache(maxsize=None)
def _jax_bf16_grads(arch, recipe):
    """JAX's bf16 gradients of its two updates on the case's batch: at the
    initial parameters and at its parameters after one update."""
    params, batch = _rec_params(arch), _rec_batch(arch)
    _, jax_after1, _ = _jax_sharded_run(arch, recipe)
    jgrad = jax.jit(jax.grad(_jax_rec_loss(arch, jnp.bfloat16, *batch)))
    return [_leaves(jgrad(jax.tree.map(jnp.asarray, p))) for p in (params, jax_after1)]


def _assert_updates_follow_jax(p0, tp, jp, jgrads, tgrads, lr_total, keys):
    """tests/test_torch_train_models.py's rule for two updates: where both
    of JAX's gradients are clear of bf16 noise (above a tenth of their
    leaf's root mean square, and within half of themselves of the port's)
    and agree in sign, so that Adam's moment cannot cancel, each update of
    the port takes the JAX update's sign and lies within `lr_total` / 2 of
    it. A zero, doubled or sign-flipped update fails."""
    for k in keys:
        held = np.sign(jgrads[0][k]) == np.sign(jgrads[1][k])
        for jg, tg in zip(jgrads, tgrads):
            g = jg[k]
            held &= (np.abs(g) > 0.1 * np.sqrt(np.mean(np.square(g, dtype=np.float64)))) & (
                np.abs(tg[k] - g) < 0.5 * np.abs(g))
        assert held.mean() >= 0.1, f"{k}: {held.mean()} of the entries are clear of noise"
        dt, dj = (tp[k] - p0[k])[held], (jp[k] - p0[k])[held]
        assert np.all(np.abs(dj) > 0.25 * lr_total), k  # the JAX step moved them
        np.testing.assert_array_equal(np.sign(dt), np.sign(dj), err_msg=k)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=lr_total / 2, err_msg=k)


def _as_leaves(flat):
    return {"".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in k.split("/")): v for k, v in flat.items()}


@pytest.mark.parametrize("world, name", _case_names(2, "bfloat16") + _case_names(4, "bfloat16"))
def test_bf16_steps_follow_the_jax_sharded_steps(spawned, world, name):
    results, single = spawned
    got = results[world][name]
    jloss, _, jp = _jax_sharded(name)
    recipe = name.split("-")[2]
    lr_total = LR_TOTAL[recipe]
    np.testing.assert_allclose(got["losses"][0], jloss, rtol=BF16_LOSS_RTOL)
    tp = _as_leaves(got["params"])
    assert tp.keys() == jp.keys()
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2 * lr_total + 1e-6, err_msg=k)
    case = next(c for c in _cases(world) if c.name == name)
    p0 = _leaves(case.params)
    if case.kind == "recognition":
        # The sharded run's own gradients (gathered) beside JAX's.
        tgrads = [_as_leaves(g) for g in got["grads"]]
        keys = [k for k in p0 if k.endswith(("['w']", "['wx']", "['wh']"))]
        _assert_updates_follow_jax(p0, tp, jp, _jax_bf16_grads(case.arch, recipe), tgrads, lr_total, keys)
    else:
        # The U-Net also against the port's one-device step.
        want = single[_single_key(name)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=BF16_LOSS_RTOL)
        sp = _as_leaves(want["params"])
        for k in sp:
            np.testing.assert_allclose(tp[k], sp[k], rtol=0, atol=2 * lr_total + 1e-6, err_msg=k)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("what", ["world_not_divisible_by_model_parallel", "uneven_batch", "head_97_over_model_2"])
def test_uneven_worlds_batches_and_splits_raise(spawned, world, what):
    assert spawned[0][world]["refusals"][what] is True
