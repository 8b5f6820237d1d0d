#!/usr/bin/env python3
"""Probe what the card's machine offers the port's multi-device paths.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_parallel_probe.py

It prints one JSON line per probe: the PyTorch, CUDA and NCCL versions and
the card; two ``gloo`` ranks on the one card (all-reduce and all-gather of
CUDA tensors in float32 and bf16, DDP on the card); one ``nccl`` rank; the
sharded train cases of :mod:`ocrs_tpu_torch.parallel.dryrun` on the card
under each; ``dryrun_multichip(1)``; ``PagePipeline`` with two shards on the
one card (GRU launches by thread); and the trainer under ``torchrun``. Unlike
``chip_smoke.py`` it records a failure and goes on: it is how the
``parallel`` phase's choices were made.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def emit(obj):
    print(json.dumps(obj), flush=True)


def _collectives_rank(rank, world, store, out_dir):
    import torch
    import torch.distributed as dist

    from ocrs_tpu_torch.parallel import distributed

    distributed.init_process_group("cuda:0", "gloo", init_method=store, rank=rank, world_size=world)
    report = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = torch.full((4, 3), float(rank + 1), device="cuda:0", dtype=dtype)
        try:
            y = x.clone()
            dist.all_reduce(y)
            report[f"all_reduce_{name}"] = float(y[0, 0])
        except Exception as e:  # the probe's purpose: record and go on
            report[f"all_reduce_{name}"] = f"{type(e).__name__}: {e}"
        try:
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            report[f"all_gather_{name}"] = [float(p[0, 0]) for p in parts]
        except Exception as e:
            report[f"all_gather_{name}"] = f"{type(e).__name__}: {e}"
    try:
        net = torch.nn.Linear(8, 4).to("cuda:0")
        ddp = torch.nn.parallel.DistributedDataParallel(net, device_ids=[0])
        ddp(torch.ones(2, 8, device="cuda:0") * (rank + 1)).sum().backward()
        report["ddp_grad"] = float(net.weight.grad[0, 0])
    except Exception as e:
        report["ddp_grad"] = f"{type(e).__name__}: {e}"
    if rank == 0:
        Path(out_dir, "collectives.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def probe(name, fn):
    t0 = time.perf_counter()
    try:
        out = fn()
        emit({"probe": name, "ok": True, "seconds": time.perf_counter() - t0, **(out or {})})
    except Exception as e:
        emit({"probe": name, "ok": False, "seconds": time.perf_counter() - t0, "error": f"{type(e).__name__}: {e}",
              "traceback": traceback.format_exc()[-3000:]})


def main():
    import numpy as np
    import torch

    from ocrs_tpu_torch import cuda_build
    from ocrs_tpu_torch.models.recognition_net import RecognitionModel
    from ocrs_tpu_torch.models.weights import params_to_jax
    from ocrs_tpu_torch.parallel import distributed
    from ocrs_tpu_torch.parallel.dryrun import TrainCase, dryrun_multichip, run_train_cases

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"probe": "versions", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nccl": ".".join(map(str, torch.cuda.nccl.version())), "card": smi,
          "gloo": torch.distributed.is_gloo_available(), "nccl_available": torch.distributed.is_nccl_available()})
    probe("build", lambda: {"built": sorted(cuda_build.build())})

    out_dir = REPO / "build" / "parallel_probe"
    out_dir.mkdir(parents=True, exist_ok=True)

    def collectives():
        distributed.spawn(_collectives_rank, 2, args=(str(out_dir),), timeout=120)
        return json.loads((out_dir / "collectives.json").read_text())

    probe("gloo_two_ranks_one_card", collectives)

    rng = np.random.default_rng(0)
    tree = params_to_jax(RecognitionModel.create(seed=1, n_classes=24, hidden=64, arch="crnn").net.state_dict())
    images = (rng.normal(size=(8, 1, 64, 64)) * 0.3).astype(np.float32)
    labels = np.ones((8, 4), np.int32)
    lengths = np.full((8,), 4, np.int32)

    def cases(split):
        return [TrainCase(f"crnn-m{split}", "recognition", tree, [(images, labels, lengths)] * 2, ("adamw", 1e-3),
                          "crnn", split)]

    def summary(res, name):
        r = res[name]
        return {"mesh": r["mesh"], "losses": r["losses"], "gru_launches_by_rank": r["gru_launches_by_rank"],
                "library_existed": res.get("library_existed"), "built_in_rank": res.get("built_in_rank"),
                "step_ms": r["step_ms"]}

    probe("gloo_data_split", lambda: summary(run_train_cases(cases(1), 2, device="cuda:0", backend="gloo",
                                                             timeout=300), "crnn-m1"))
    probe("gloo_model_split", lambda: summary(run_train_cases(cases(2), 2, device="cuda:0", backend="gloo",
                                                              timeout=300), "crnn-m2"))
    probe("nccl_one_rank", lambda: summary(run_train_cases(cases(1), 1, device="cuda:0", timeout=300), "crnn-m1"))
    probe("dryrun_multichip_1", lambda: {"report": {k: v for k, v in dryrun_multichip(1).items()}})

    def two_shards():
        from ocrs_tpu_torch import PagePipeline
        from ocrs_tpu_torch.engine import DEFAULT_ALPHABET
        from ocrs_tpu_torch.models.fakes import FakeDetectionModel
        from ocrs_tpu_torch.ops import gru
        from ocrs_tpu_torch.parallel.sharding import make_data_mesh

        alphabet = DEFAULT_ALPHABET[:63]
        rec = RecognitionModel.create(seed=0, n_classes=64, hidden=192, arch="crnn")
        pages = np.zeros((8, 100, 200), np.float32)
        for i in range(8):
            pages[i, 30:50, 20 + 5 * i: 90 + 5 * i] = 1.0
        mesh = make_data_mesh(devices=["cuda:0", "cuda:0"])
        pipe = PagePipeline(FakeDetectionModel(), rec, alphabet, max_lines_per_batch=8, mesh=mesh)
        single = PagePipeline(FakeDetectionModel(), rec, alphabet, max_lines_per_batch=8)
        gru.bigru_sequence.launches_by_thread.clear()
        got = [r.text for r in pipe.process(pages)]
        torch.cuda.synchronize()
        by_thread = dict(gru.bigru_sequence.launches_by_thread)
        want = [r.text for r in single.process(pages[:4])] + [r.text for r in single.process(pages[4:])]
        return {"launches_by_thread": by_thread, "equal_per_shard": got == want}

    probe("pipeline_two_shards_one_card", two_shards)

    def trainer():
        out = out_dir / "trainer.npz"
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
             "-m", "ocrs_tpu_torch.train.train_models", "recognition", "--arch", "convctc",
             "--init-from", str(REPO / "weights" / "text-recognition.npz"),
             "--cache", str(REPO / "test-data" / "train" / "rec_64_768_s0.npz"),
             "--batch", "64", "--steps", "4", "--lr", "1e-4", "--val-size", "0", "--val-every", "4", "-o", str(out)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        return {"rc": proc.returncode, "stdout": proc.stdout[-2000:], "stderr": proc.stderr[-2000:],
                "exported": out.exists()}

    probe("torchrun_trainer", trainer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
