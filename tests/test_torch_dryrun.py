"""Several devices end to end on the CPU: the port's ``dryrun_multichip``
(the counterpart of ``__graft_entry__.dryrun_multichip``) and its trainer
under ``torchrun``.

``dryrun_multichip(4, device="cpu")`` runs its three parts in four ``gloo``
ranks and on a mesh of four CPU entries. Without ``device="cpu"`` it takes
CUDA devices, and here, where there is none, it raises: it does not re-run
itself on the CPU as the JAX version does.

``torchrun --standalone --nproc-per-node=2 -m
ocrs_tpu_torch.train.train_models --device cpu`` trains ConvCTC,
warm-started from the shipped weights, 2 steps of batch 8 from the
committed cache, validating on rank 0: it writes one export, with the
keys, shapes, dtypes and ``meta`` of the one-process run's, and within the
bf16 criteria of tests/test_torch_train_models_convctc.py of it (step-1
loss 1e-2 relative; parameters within 2 * the summed rates + 1e-6, and
each update's sign where the one-process update is clear of bf16 noise).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ocrs_tpu_torch.models.weights import load_flat, load_recognition_model
from ocrs_tpu_torch.parallel.dryrun import dryrun_multichip
from ocrs_tpu_torch.train import train_models
from tests.test_torch_train_step import BF16_LOSS_RTOL

REPO = Path(__file__).resolve().parent.parent
LR, STEPS = 1e-3, 2
# The chain's schedule over 2 steps: rate 0 at the first update, LR / 2 at
# the second.
LR_TOTAL = LR / 2


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    report = dryrun_multichip(4, device="cpu", timeout=300)
    printed = capsys.readouterr().out
    assert "dryrun_multichip OK: 4 devices" in printed
    train = report["train"]
    assert train["mesh"] == {"data": 2, "model": 2} and np.isfinite(train["loss"])
    assert abs(train["loss"] - train["single_loss"]) <= BF16_LOSS_RTOL * abs(train["single_loss"])
    assert report["fake_pages"] == 8 and report["real_pages"] == 4 and report["real_nonempty"] >= 3


def test_dryrun_multichip_raises_without_cuda_and_does_not_fall_back():
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def _argv(out):
    return ["recognition", "--arch", "convctc", "--init-from", str(REPO / "weights" / "text-recognition.npz"),
            "--cache", str(REPO / "test-data" / "train" / "rec_64_768_s0.npz"), "--batch", "8",
            "--steps", str(STEPS), "--lr", str(LR), "--val-size", "4", "--val-every", "1", "--device", "cpu",
            "-o", str(out)]


def test_torchrun_trainer_on_two_cpu_ranks_writes_the_one_process_export(tmp_path, capsys):
    out_dir = tmp_path / "torchrun"
    out_dir.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "ocrs_tpu_torch.train.train_models", *_argv(out_dir / "convctc.npz")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    # Rank 0 alone printed, validated and exported.
    assert proc.stdout.count("saved ") == 1 and proc.stdout.count("step      1  loss") == 1
    assert [s for s, in re.findall(r"step\s+(\d+)\s+val CER", proc.stdout)] == ["1", "2"]
    assert sorted(p.name for p in out_dir.iterdir()) == ["convctc.npz"]
    torchrun_loss = float(re.search(r"step\s+1\s+loss\s+([-\d.]+)", proc.stdout).group(1))

    record = train_models.main(_argv(tmp_path / "single.npz"))
    capsys.readouterr()
    got, got_meta = load_flat(out_dir / "convctc.npz")
    want, want_meta = load_flat(tmp_path / "single.npz")
    assert got_meta == want_meta and got_meta["steps"] == STEPS and got_meta["arch"] == "convctc"
    assert got.keys() == want.keys()
    np.testing.assert_allclose(torchrun_loss, record["losses"][0], rtol=BF16_LOSS_RTOL)
    p0, _ = load_flat(REPO / "weights" / "text-recognition.npz")
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR_TOTAL + 1e-6, err_msg=k)
        moved = np.abs(want[k] - p0[k]) > 0.5 * LR_TOTAL
        np.testing.assert_array_equal(np.sign(got[k] - p0[k])[moved], np.sign(want[k] - p0[k])[moved], err_msg=k)
    assert load_recognition_model(out_dir / "convctc.npz").arch == "convctc"
