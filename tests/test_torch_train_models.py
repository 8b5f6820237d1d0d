"""The port's trainer (python -m ocrs_tpu_torch.train.train_models) against
tools/train_models.py, the JAX package's.

Both read one tiny shared cache and warm-start from one ``--init-from``
file: a CRNN (hidden 32) at width 128 here, ConvCTC (dim 32) and a narrow
U-Net (channels 4-8) in the two files beside this one. Batch 8, because
tests/conftest.py gives JAX 8 CPU devices and its script shards the batch
over them. Equal exactly: the flags and their defaults, the batches each
script draws, the schedule's shape (where it peaks and where it ends; its
values to float32 rounding of the peak rate: optax computes in float32,
the port in float64), and the exported file's keys, shapes, dtypes and ``meta`` (but
``trained_on``, which names each package's renderer). Within the bf16
criteria of tests/test_torch_train_step.py: the step-1 loss (1e-2
relative) and the parameters after 2 steps (2 * the summed rates + 1e-6,
and each update's sign and size where the JAX update direction is clear of
bf16 noise, see :func:`check_two_steps`).
"""

import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ocrs_tpu.train import data as jdata
from ocrs_tpu_torch.models.weights import load_flat, load_params, params_to_jax, save_params
from ocrs_tpu_torch.train import data as tdata
from ocrs_tpu_torch.train import train as ttrain
from ocrs_tpu_torch.train import train_models
from ocrs_tpu.models import recognition_net as jrec
from ocrs_tpu.train import losses as jlosses
from tests.test_torch_train_step import BF16_LOSS_RTOL, _leaves, _port_grads

REPO = Path(__file__).resolve().parent.parent
BATCH, STEPS, LR = 8, 2, 1e-3


def jax_script():
    """tools/train_models.py as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location("jax_train_models", REPO / "tools" / "train_models.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_args(monkeypatch, argv):
    """The namespace tools/train_models.py's own parser makes of `argv`."""
    mod = jax_script()
    seen = []
    monkeypatch.setattr(mod, "train_recognition", seen.append)
    monkeypatch.setattr(mod, "train_detection", seen.append)
    monkeypatch.setattr(sys, "argv", ["train_models.py", *argv])
    mod.main()
    return seen[0]


@pytest.mark.parametrize(
    "argv",
    [
        ["recognition", "-o", "x.npz"],
        ["detection", "-o", "x.npz"],
        ["detection", "--batch", "8", "-o", "x.npz"],
        ["recognition", "--arch", "crnn", "--steps", "5", "--batch", "4", "--width", "256", "--hidden", "64",
         "--lr", "3e-4", "--samples", "9", "--max-label-len", "20", "--val-size", "3", "--val-every", "2",
         "--data-seed", "4", "--blockify-prob", "0.2", "--pixelfont-prob", "0.1", "--graphics-prob", "0.3",
         "--empty-prob", "0.05", "--figure-prob", "0.5", "--render-only", "--cache", "c.npz",
         "--extra-cache", "a.npz", "--extra-cache", "b.npz", "--init-from", "i.npz", "-o", "y.npz"],
    ],
    ids=["recognition-defaults", "detection-defaults", "detection-batch", "every-flag"],
)
def test_flags_and_defaults_are_the_jax_scripts(monkeypatch, argv):
    port = vars(train_models.parse_args(argv))
    assert port.pop("device") is None
    assert port == vars(_jax_args(monkeypatch, argv))


@pytest.mark.parametrize("steps, warmup_cap", [(2, 300), (7, 300), (700, 300), (40, 150), (2000, 150)])
def test_schedule_is_the_jax_scripts(steps, warmup_cap):
    args = train_models.parse_args(["recognition", "--steps", str(steps), "-o", "x.npz"])
    port = train_models.recipe(args, warmup_cap)
    warmup = min(warmup_cap, steps // 2 + 1)
    want = optax.warmup_cosine_decay_schedule(0.0, args.lr, warmup_steps=warmup, decay_steps=steps + 1)
    assert port.clip_norm == 1.0 and port.weight_decay == 1e-4
    counts = np.unique(np.r_[np.arange(min(steps + 3, 60)), warmup - 1, warmup, warmup + 1, steps, steps + 1, steps + 5])
    got = np.array([port.learning_rate(int(c)) for c in counts])
    ref = np.array([float(want(int(c))) for c in counts])
    # optax interpolates in float32: its values are off by float32 rounding
    # of the peak rate (up to 6.7e-11 at lr 1e-3).
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * args.lr)
    assert int(counts[np.argmax(got)]) == int(counts[np.argmax(ref)]) == warmup
    assert got[0] == ref[0] == 0.0 and port.learning_rate(steps + 1) == 0.0 == float(want(steps + 1))


# -- both scripts on one cache and one init file ------------------------------------


def rec_cache(tmp_path, width=128):
    path = tmp_path / "rec.npz"
    tdata.RecognitionDataset(12, width=width, seed=0, cache_path=path)
    return path


def _zeros_like_init(init):
    """`init` (a JAX init function) made to return zeros of its tree's
    shapes: what the JAX script's fresh init is for under ``--init-from``
    (it fixes the tree the warm start must match, then every leaf is
    replaced), without its eager random draws, which cost seconds here."""

    def zeros(*args, **kwargs):
        shapes = jax.eval_shape(lambda: init(*args, **kwargs))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    return zeros


@pytest.fixture()
def cheap_jax_init(monkeypatch):
    from ocrs_tpu.models import detection_net as jdet

    monkeypatch.setattr(jrec, "init_params", _zeros_like_init(jrec.init_params))
    for arch, (init, apply) in list(jrec.ARCHS.items()):
        monkeypatch.setitem(jrec.ARCHS, arch, (_zeros_like_init(init), apply))
    monkeypatch.setattr(jdet, "init_params", _zeros_like_init(jdet.init_params))


def run_both(tmp_path, capsys, argv, init_tree, init_meta, cache, val_batch=None):
    """Save `init_tree` as the shared ``--init-from`` file, run each script
    on `argv` (which names `cache`), and return ({"jax"|"port": (exported
    flat, meta, step-1 loss)}, the port's record)."""
    init = tmp_path / "init.npz"
    save_params(init, init_tree, meta=init_meta)
    common = [*argv, "--cache", str(cache), "--init-from", str(init), "--steps", str(STEPS), "--batch", str(BATCH),
              "--lr", str(LR)]
    out = {}
    capsys.readouterr()
    mod = jax_script()
    jns = train_models.parse_args([*common, "-o", str(tmp_path / "jax.npz")])
    del jns.device
    (mod.train_recognition if argv[0] == "recognition" else mod.train_detection)(jns)
    printed = capsys.readouterr().out
    step1 = float(re.search(r"step\s+1\s+loss\s+([-\d.]+)", printed).group(1))
    out["jax"] = (*load_flat(tmp_path / "jax.npz"), step1)
    targs = train_models.parse_args([*common, "-o", str(tmp_path / "port.npz"), "--device", "cpu"])
    if argv[0] == "recognition":
        record = train_models.train_recognition(targs, val_batch=val_batch)
    else:
        record = train_models.train_detection(targs)
    out["port"] = (*load_flat(tmp_path / "port.npz"), record["losses"][0])
    return out, record


def check_export(out, kind):
    (jflat, jmeta, _), (tflat, tmeta, _) = out["jax"], out["port"]
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert jflat[k].shape == tflat[k].shape and jflat[k].dtype == tflat[k].dtype, k
    assert jmeta.pop("trained_on").endswith("(ocrs_tpu.train.render)")
    assert tmeta.pop("trained_on").endswith("(ocrs_tpu_torch.train.render)")
    assert jmeta == tmeta and jmeta["kind"] == kind and jmeta["steps"] == STEPS


def check_batches(cache, kind, seed=1, page_hw=(800, 608)):
    """The batches each script draws (``ds.batches(batch, seed=data_seed +
    1, as_u8=True)``), equal."""
    if kind == "recognition":
        t, j = tdata.RecognitionDataset(0, width=128, cache_path=cache), jdata.RecognitionDataset(0, width=128, cache_path=cache)
    else:
        t, j = tdata.DetectionDataset(0, page_hw, cache_path=cache), jdata.DetectionDataset(0, page_hw, cache_path=cache)
    gt, gj = t.batches(BATCH, seed=seed, as_u8=True), j.batches(BATCH, seed=seed, as_u8=True)
    batches = []
    for _ in range(STEPS):
        bt, bj = next(gt), next(gj)
        for a, b in zip(bt, bj):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        batches.append(bt)
    return batches


def check_two_steps(out, p0, jgrads, tgrads, keys):
    """The step-1 losses within 1e-2 relative; the parameters after two
    steps within 2 * (the rates summed) + 1e-6 of each other. The schedule
    gives the first update rate 0 and the second LR / 2, so both gradients
    are taken at the initial parameters and the second update runs along
    Adam's first moment, 0.9 * 0.1 * g1 + 0.1 * g2. `jgrads` / `tgrads`
    hold each package's bf16 gradients (g1, g2) on the two batches: where
    both of JAX's are clear of bf16 noise (above a tenth of their leaf's
    root mean square, and within half of themselves of the port's) and
    agree in sign, so that the moment cannot cancel, each port update takes
    the JAX update's sign and lies within the summed rates / 2 of it. A
    zero, doubled or sign-flipped update fails."""
    (jflat, _, jloss), (tflat, _, tloss) = out["jax"], out["port"]
    np.testing.assert_allclose(tloss, jloss, rtol=BF16_LOSS_RTOL)
    lr_total = 0.0 + LR / 2
    jp, tp = _flat_leaves(jflat), _flat_leaves(tflat)
    assert jp.keys() == tp.keys() == p0.keys()
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2 * lr_total + 1e-6, err_msg=k)
    for k in keys:
        held = np.sign(jgrads[0][k]) == np.sign(jgrads[1][k])
        for jg, tg in zip(jgrads, tgrads):
            g = jg[k]
            held &= (np.abs(g) > 0.1 * np.sqrt(np.mean(np.square(g, dtype=np.float64)))) & (np.abs(tg[k] - g) < 0.5 * np.abs(g))
        assert held.mean() >= 0.1, f"{k}: {held.mean()} of the entries are clear of noise"
        dt, dj = (tp[k] - p0[k])[held], (jp[k] - p0[k])[held]
        assert np.all(np.abs(dj) > 0.25 * lr_total), k  # the JAX script moved them
        np.testing.assert_array_equal(np.sign(dt), np.sign(dj), err_msg=k)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=lr_total / 2, err_msg=k)


def _flat_leaves(flat):
    """A weight file's leaves keyed as _leaves keys a tree."""
    return {"".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in k.split("/")): v for k, v in flat.items()}


@functools.lru_cache(maxsize=None)
def _jax_rec_grad_fn(arch):
    apply = jrec.ARCHS[arch][1]

    def loss_fn(params, x, labels, lengths):
        lp = apply(params, x, dtype=jnp.bfloat16) if arch == "crnn" else apply(params, x)
        return jlosses.ctc_loss(lp, labels, lengths)

    return jax.jit(jax.grad(loss_fn))


def jax_rec_grads(arch, params, batches):
    p = jax.tree.map(jnp.asarray, params)
    return [_leaves(_jax_rec_grad_fn(arch)(p, jnp.asarray(images.astype(np.float32) / 255.0 - 0.5), labels, lengths))
            for images, labels, lengths in batches]


def port_rec_grads(arch, params, batches):
    from ocrs_tpu_torch.train import optim

    state = ttrain.init_recognition_state(optim.adam(LR), arch=arch, init_params=params, device="cpu")
    return [_port_grads(state, ttrain.recognition_loss(state.model, *b)) for b in batches]


def check_recognition_scripts(tmp_path, capsys, arch, init_model):
    """Both scripts on one cache from one init file: batches, export,
    step-1 loss and parameters after two steps, and the port's validation."""
    cache = rec_cache(tmp_path)
    tree = params_to_jax(init_model.net.state_dict())
    argv = ["recognition", "--arch", arch, "--width", "128", "--hidden", "32", "--val-size", "4", "--val-every", "1"]
    out, record = run_both(tmp_path, capsys, argv, tree, {"arch": arch}, cache)
    check_export(out, "recognition")
    assert out["port"][1]["arch"] == arch and out["port"][1]["n_classes"] == 97 and out["port"][1]["hidden"] == 32
    assert [s for s, _ in record["val_cer"]] == [1, 2] and all(0.0 <= c for _, c in record["val_cer"])
    assert len(record["losses"]) == STEPS and np.all(np.isfinite(record["losses"]))
    batches = check_batches(cache, "recognition")
    params = load_params(tmp_path / "init.npz")[0]
    p0 = _leaves(params)
    keys = [k for k in p0 if k.endswith("['w']") or k.endswith("['wx']") or k.endswith("['wh']")]
    check_two_steps(out, p0, jax_rec_grads(arch, params, batches), port_rec_grads(arch, params, batches), keys)
    # The exported file loads in the port as its kind.
    from ocrs_tpu_torch.models.weights import load_recognition_model

    assert load_recognition_model(tmp_path / "port.npz").arch == arch


def test_crnn_scripts_agree(tmp_path, capsys, cheap_jax_init):
    from ocrs_tpu_torch.models.recognition_net import RecognitionModel

    check_recognition_scripts(tmp_path, capsys, "crnn", RecognitionModel.create(seed=3, hidden=32, arch="crnn"))


def test_validation_batch_of_a_cache_is_the_streaming_set_in_uint8(tmp_path):
    # A cache rendered with seed s holds the lines recognition_batches(seed=s)
    # draws, quantized to uint8: the held-out set where nothing can be drawn.
    path = tmp_path / "val.npz"
    ds = tdata.RecognitionDataset(5, width=128, seed=7919, cache_path=path)
    images, labels, lengths = train_models.validation_batch(tdata.RecognitionDataset(0, width=128, cache_path=path))
    s_images, s_labels, s_lengths = next(tdata.recognition_batches(5, width=128, seed=7919))
    np.testing.assert_array_equal(labels, s_labels)
    np.testing.assert_array_equal(lengths, s_lengths)
    # The cache truncates to uint8 (astype), so each pixel lies within 1/255.
    np.testing.assert_allclose(images, s_images, rtol=0, atol=1 / 255 + 1e-6)
    assert images.shape == (5, 1, 64, 128) and len(ds) == 5
