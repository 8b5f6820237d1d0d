"""The port's training steps (ocrs_tpu_torch.train) against the JAX package's.

One step of the CRNN, of ConvCTC and of a narrow U-Net from the same
parameters (made by the JAX package's init and carried across by
``params_from_jax``) and the same batch, made with numpy from a seed: the
loss, every parameter's gradient and the updated parameters, under
``adam(1e-3)`` and under ``tools/train_models.py``'s chain
(``clip_by_global_norm(1.0)`` then ``adamw(warmup_cosine_decay_schedule,
weight_decay=1e-4)``). The JAX side runs on the CPU as its own tests run
it: its GRU takes the ``lax.scan`` route there.

Tolerances:
  * float64 (CRNN; the JAX side under ``jax.enable_x64``): the same
    algorithm in double precision, summed in other orders: 1e-9 relative.
  * float32 (CRNN): loss 1e-5 relative, gradients 1e-4 by relative norm. A
    ReLU whose input lies within float32 rounding of zero can take the
    other side in the two frameworks' sums; that changes the gradient of
    every layer below it (a conv2 input at 1.2e-7 moved conv1's and conv2's
    gradients by 9e-3 against float64, where XLA's stayed at 4e-7). The
    test finds such near-ties in the float64 forward and gives the layers
    below the first one the bf16 bound.
  * bf16 through the real steps (the JAX steps are its jitted
    ``make_*_train_step``; tests/test_torch_train_crnn_bf16.py, _convctc_bf16.py and
    tests/test_torch_train_detection.py): loss 1e-2 relative, gradients 0.1 by relative
    norm (bf16 keeps 8 bits; the two frameworks round at other places), and
    updated parameters within 2 * lr + 1e-6: Adam's first step moves a
    weight by about lr * sign(g), and where g is near 0 bf16 noise can flip
    that sign. That bound alone would pass any update, so the direction is
    held too (:func:`assert_updates_follow_jax`): where the JAX gradient is
    clearly above bf16 noise (more than a tenth of its leaf's root mean
    square), each parameter moves the way JAX moves it, by the same amount
    within half the learning rates summed over the updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ocrs_tpu.models import recognition_net as jrec
from ocrs_tpu.train import losses as jlosses
from ocrs_tpu.train import train as jtrain
from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from ocrs_tpu_torch.models.weights import params_to_jax
from ocrs_tpu_torch.ops import gru
from ocrs_tpu_torch.train import optim as toptim
from ocrs_tpu_torch.train import train as ttrain

LR = 1e-3
N_CLASSES = 12
BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_PARAM_ATOL = 1e-2, 0.1, 2 * LR + 1e-6
F32_LOSS_RTOL, F32_GRAD_RTOL, F32_PARAM_ATOL = 1e-5, 1e-4, 1e-6
F64_RTOL = 1e-9


def _schedule(lib):
    # train_models.py's schedule at a short run: warmup over 2 updates.
    return lib.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=2, decay_steps=11)


def _recipes(name):
    """(optax transformation, the port's recipe) of the same name."""
    if name == "adam":
        return optax.adam(LR), toptim.adam(LR)
    return (
        optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(_schedule(optax), weight_decay=1e-4)),
        toptim.chain(toptim.clip_by_global_norm(1.0), toptim.adamw(_schedule(toptim), weight_decay=1e-4)),
    )


def _rec_batch(seed=0, n=3, width=32):
    """Images [n, 1, 64, width], labels of 1-3 classes (T = width / 4 = 8
    frames >= 2 * 3 + 1)."""
    rng = np.random.default_rng(seed)
    images = (rng.normal(size=(n, 1, 64, width)) * 0.3).astype(np.float32)
    lengths = rng.integers(1, 4, size=n).astype(np.int32)
    labels = np.zeros((n, 3), np.int32)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.integers(1, N_CLASSES, size=k)
    return images, labels, lengths


def _params(arch, seed=1):
    """JAX-layout parameters (numpy): a narrow recognizer (CRNN hidden 16,
    ConvCTC dim 32) from a seeded init, drawn by the port and written out
    with params_to_jax; both packages start from this tree (the port
    through params_from_jax). The JAX package's own init is not used: its
    eager random draws cost seconds on the CPU."""
    model = RecognitionModel.create(seed=seed, n_classes=N_CLASSES, hidden=16, arch=arch)
    if arch == "convctc":
        model = RecognitionModel(None, "convctc", n_classes=N_CLASSES, hidden=32,
                                 generator=torch.Generator().manual_seed(seed))
    tree = params_to_jax(model.net.state_dict())
    rng = np.random.default_rng(seed)
    # Non-zero biases and norm scales, so that their gradients are held too.
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if jax.tree_util.keystr(path).endswith(("['b']", "['bx']", "['bh']", "['g']")) else a,
        tree,
    )


def _jax_state(params, jopt):
    """A JAX TrainState over (a device copy of) `params`, as
    init_*_state(init_params=...) makes it, without its random init."""
    p = jax.tree.map(jnp.asarray, params)
    return jtrain.TrainState(params=p, opt_state=jopt.init(p), step=jnp.zeros((), jnp.int32))


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(state, loss):
    named = dict(state.model.net.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return _leaves(params_to_jax(dict(zip(named, grads))))


def _port_params(state):
    return _leaves(params_to_jax(state.model.net.state_dict()))


def assert_updates_follow_jax(p0, tp, jp, jgrads, tgrads, lr_total, keys):
    """The port's updates (`tp` - `p0`) take the JAX updates' (`jp` - `p0`)
    sign, and lie within `lr_total` / 2 of them, on the entries of each
    leaf in `keys` whose JAX gradient is clear of bf16 noise: above a tenth
    of the leaf's root mean square, and more than twice its difference from
    the port's first gradient (`tgrads`); at least a fifth of every leaf
    (0.28 and up in these tests). A zero, doubled or sign-flipped update
    fails."""
    for k in keys:
        g = jgrads[k]
        held = (np.abs(g) > 0.1 * np.sqrt(np.mean(np.square(g, dtype=np.float64)))) & (
            np.abs(tgrads[k] - g) < 0.5 * np.abs(g)
        )
        assert held.mean() >= 0.2, f"{k}: {held.mean()} of the entries are clear of noise"
        dt, dj = (tp[k] - p0[k])[held], (jp[k] - p0[k])[held]
        np.testing.assert_array_equal(np.sign(dt), np.sign(dj), err_msg=k)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=lr_total / 2, err_msg=k)


def _jax_rec_loss(arch, dtype, images, labels, lengths):
    apply = jrec.ARCHS[arch][1]

    def loss_fn(params):
        lp = apply(params, jnp.asarray(images), dtype=dtype) if arch == "crnn" else apply(params, jnp.asarray(images))
        return jlosses.ctc_loss(lp, jnp.asarray(labels), jnp.asarray(lengths))

    return loss_fn


def _relu_near_ties(params, images, eps):
    """Conv layers of the CRNN at or below the first one whose ReLU input has
    an element within `eps` of zero, in a float64 forward (the port's, on
    the same parameters)."""
    state = ttrain.init_recognition_state(toptim.adam(LR), arch="crnn", init_params=params, device="cpu")
    net = state.model.net.to(torch.float64)
    h = torch.from_numpy(images).double()
    below = []
    with torch.no_grad():
        for name in ("conv1", "conv2", "conv3", "conv4"):
            pre = getattr(net, name)(h)
            below.append(name)
            if float(pre.abs().min()) < eps:
                return below
            h = F.relu(pre)
    return []


def _run_recognition(arch, recipe_name, dtype, steps=2):
    """The same `steps` updates of a recognizer in both packages at `dtype`
    (jnp dtype): losses, the first step's gradients, the final parameters."""
    images, labels, lengths = _rec_batch()
    jopt, topt = _recipes(recipe_name)
    params = _params(arch)
    loss_fn = _jax_rec_loss(arch, dtype, images, labels, lengths)
    if dtype == jnp.float64:
        params = jax.tree.map(lambda a: a.astype(np.float64), params)

    @jax.jit
    def jstep(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = jopt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, grads

    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    jlosses_, jgrads = [], None
    for k in range(steps):
        jp, js, loss, grads = jstep(jp, js)
        jlosses_.append(float(loss))
        jgrads = _leaves(grads) if k == 0 else jgrads

    tdtype = {jnp.float64: torch.float64, jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    state = ttrain.init_recognition_state(topt, n_classes=N_CLASSES, arch=arch, init_params=params, device="cpu")
    if tdtype == torch.float64:
        state.model.to(torch.float64)
    tgrads = _port_grads(state, ttrain.recognition_loss(state.model, images, labels, lengths, tdtype))
    # The recognition step at `dtype` (make_recognition_train_step's is bf16).
    tlosses = []
    for _ in range(steps):
        loss = ttrain.recognition_loss(state.model, images, labels, lengths, tdtype)
        state = ttrain.apply_gradients(state, loss)
        tlosses.append(float(loss.detach()))
    assert state.step == steps and state.optimizer.count == steps
    return (jlosses_, jgrads, _leaves(jp)), (tlosses, tgrads, _port_params(state)), params, images


@pytest.mark.parametrize("recipe", ["chain"])
def test_crnn_steps_match_jax_in_float64(recipe):
    with jax.enable_x64(True):
        (jl, jg, jp), (tl, tg, tp), _, _ = _run_recognition("crnn", recipe, jnp.float64)
    np.testing.assert_allclose(tl, jl, rtol=F64_RTOL)
    assert set(tg) == set(jg) == set(tp) == set(jp)
    for k in jg:
        assert _relnorm(tg[k], jg[k]) <= F64_RTOL, k
        # Adam divides by sqrt(nu) + 1e-8: where |g| is near 1e-8 the update
        # carries the gradient's relative error times lr, ~1e-11 here.
        np.testing.assert_allclose(tp[k], jp[k], rtol=F64_RTOL, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("recipe", ["adam"])
def test_crnn_steps_match_jax_in_float32(recipe):
    (jl, jg, jp), (tl, tg, tp), params, images = _run_recognition("crnn", recipe, jnp.float32)
    np.testing.assert_allclose(tl, jl, rtol=F32_LOSS_RTOL)
    near_tie = _relu_near_ties(params, images, eps=1e-5)
    for k in jg:
        loose = any(f"['{name}']" in k for name in near_tie)
        assert _relnorm(tg[k], jg[k]) <= (BF16_GRAD_RTOL if loose else F32_GRAD_RTOL), k
        atol = BF16_PARAM_ATOL if loose else F32_PARAM_ATOL
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=atol, err_msg=k)


def check_recognition_bf16_step(arch):
    """The JAX package's jitted make_recognition_train_step (bf16) against
    the port's, one step under adam; gradients by value_and_grad beside it.
    (Run by tests/test_torch_train_crnn_bf16.py and _convctc_bf16.py.)"""
    images, labels, lengths = _rec_batch(1)
    jopt, topt = _recipes("adam")
    params = _params(arch, seed=2)
    mesh = jtrain.make_mesh(1)
    with mesh:
        jstate = _jax_state(params, jopt)
        jgrads = _leaves(jax.jit(jax.grad(_jax_rec_loss(arch, jnp.bfloat16, images, labels, lengths)))(jstate.params))
        jstep = jtrain.make_recognition_train_step(mesh, jopt, arch=arch)
        jstate, jloss = jstep(jstate, *map(jnp.asarray, (images, labels, lengths)))
        jp = _leaves(jstate.params)
    state = ttrain.init_recognition_state(topt, n_classes=N_CLASSES, arch=arch, init_params=params, device="cpu")
    tgrads = _port_grads(state, ttrain.recognition_loss(state.model, images, labels, lengths))
    state, loss = ttrain.make_recognition_train_step(topt, arch=arch)(state, images, labels, lengths)
    assert loss.dtype == torch.float32 and state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)
    tp = _port_params(state)
    for k in jgrads:
        assert _relnorm(tgrads[k], jgrads[k]) <= BF16_GRAD_RTOL, k
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=BF16_PARAM_ATOL, err_msg=k)
    assert_updates_follow_jax(_leaves(params), tp, jp, jgrads, tgrads, LR, jgrads)


def check_two_steps_lower_the_loss(arch):
    opt = toptim.adam(1e-3)
    images, labels, lengths = _rec_batch(4, n=4)
    state = ttrain.init_recognition_state(opt, n_classes=N_CLASSES, hidden=32, arch=arch, device="cpu")
    step = ttrain.make_recognition_train_step(opt, arch=arch)
    state, loss1 = step(state, images, labels, lengths)
    state, loss2 = step(state, images, labels, lengths)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert float(loss2) < float(loss1)


def test_uint8_images_normalize_as_float_ones():
    images, labels, lengths = _rec_batch(5)
    u8 = np.clip(np.round((images + 0.5) * 255.0), 0, 255).astype(np.uint8)
    state = ttrain.init_recognition_state(toptim.adam(LR), n_classes=N_CLASSES, hidden=16, device="cpu")
    a = ttrain.recognition_loss(state.model, u8, labels, lengths, torch.float32)
    b = ttrain.recognition_loss(state.model, u8.astype(np.float32) / 255.0 - 0.5, labels, lengths, torch.float32)
    assert float(a.detach()) == float(b.detach())


def test_init_params_of_another_tree_is_refused():
    params = _params("convctc")
    with pytest.raises(ValueError, match="init_params tree mismatch"):
        ttrain.init_recognition_state(toptim.adam(LR), arch="crnn", init_params=params, device="cpu")
    state = ttrain.init_recognition_state(toptim.adam(LR), arch="convctc", init_params=params, device="cpu")
    with pytest.raises(ValueError, match="convctc recognizer"):
        ttrain.make_recognition_train_step(toptim.adam(LR), arch="crnn")(state, *_rec_batch())
    with pytest.raises(ValueError, match="another recipe"):
        ttrain.make_recognition_train_step(toptim.adam(2 * LR), arch="convctc")(state, *_rec_batch())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.init_recognition_state(toptim.adam(LR), n_classes=N_CLASSES, hidden=16)


# The GRU kernel's autograd.Function: on the CPU its forward is the plain
# loop, so its backward (the recompute) is what is checked here.
def _bigru_operands(seed, t, n, h, dtype):
    g = torch.Generator().manual_seed(seed)
    xps = [torch.randn(n, t, 3 * h, generator=g, dtype=dtype).transpose(0, 1) for _ in range(2)]
    rec = []
    for _ in range(2):
        rec.append(torch.randn(h, 3 * h, generator=g, dtype=dtype) * (2.0 / h) ** 0.5)
        rec.append(torch.randn(3 * h, generator=g, dtype=dtype) * 0.1)
    return [x.detach().requires_grad_() for x in (*xps, *rec)]


def test_bigru_function_gradients_equal_autograd_through_the_plain_loop():
    ops = _bigru_operands(7, 9, 3, 8, torch.float32)
    w = torch.randn(3, 9, 16, generator=torch.Generator().manual_seed(8))
    out = gru.BiGRUSequence.apply(*ops)
    assert out.shape == (3, 9, 16) and out.grad_fn is not None
    got = torch.autograd.grad((out * w).sum(), ops)
    want = torch.autograd.grad((gru.bigru_sequence_reference(*ops).transpose(0, 1) * w).sum(), ops)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_function_gradients_equal_autograd_through_the_plain_loop(reverse):
    g = torch.Generator().manual_seed(9)
    ops = [torch.randn(6, 2, 5, generator=g).requires_grad_() for _ in range(3)]
    ops += [torch.randn(5, 15, generator=g).requires_grad_(), torch.randn(15, generator=g).requires_grad_()]
    out = gru.GRUSequence.apply(*ops, reverse)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out.square().sum(), ops)
    want = torch.autograd.grad(gru.gru_sequence_reference(*ops, reverse=reverse).square().sum(), ops)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gru_functions_pass_gradcheck_in_float64():
    assert torch.autograd.gradcheck(gru.BiGRUSequence.apply, tuple(_bigru_operands(10, 3, 2, 3, torch.float64)))
    g = torch.Generator().manual_seed(11)
    ops = [torch.randn(4, 2, 3, generator=g, dtype=torch.float64).requires_grad_() for _ in range(3)]
    ops += [torch.randn(3, 9, generator=g, dtype=torch.float64).requires_grad_(),
            torch.randn(9, generator=g, dtype=torch.float64).requires_grad_()]
    assert torch.autograd.gradcheck(lambda *a: gru.GRUSequence.apply(*a, True), tuple(ops))


def test_the_crnn_trains_through_the_kernel_route():
    # The layer under training takes the Function (not the plain loop) and
    # gives the plain route's gradients.
    state = ttrain.init_recognition_state(toptim.adam(LR), n_classes=N_CLASSES, hidden=16, device="cpu")
    images, labels, lengths = _rec_batch(12)
    grads = {}
    for plain in (False, True):
        state.model.net.plain_gru = plain
        loss = ttrain.recognition_loss(state.model, images, labels, lengths, torch.float32)
        grads[plain] = _port_grads(state, loss)
    for k in grads[True]:
        np.testing.assert_allclose(grads[False][k], grads[True][k], rtol=1e-6, atol=1e-7, err_msg=k)
