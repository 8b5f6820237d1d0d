"""Several devices end to end: ``dryrun_multichip`` and the ranks it spawns.

Counterpart of ``__graft_entry__.dryrun_multichip``. On n devices it runs the
JAX version's three parts at its shapes:

  1. one sharded CRNN train step (n_classes 24, hidden 64, AdamW 1e-3,
     batch ``max(n, 8)`` of 64 x 64, model split 2 where n is even), in n
     ranks spawned here, one per device; its loss is finite and within bf16
     rounding of the one-device step on the same batch;
  2. the fake-model :class:`.pipeline.PagePipeline` on ``max(n, 8)`` pages
     of 100 x 200 under a ``("data",)`` mesh of n entries, its text equal to
     the unsharded pipeline's;
  3. the shipped U-Net and ConvCTC on n pages of 800 x 608 drawn with
     Pillow's built-in face, sharded text equal to unsharded text, and text
     found on at least n - 1 pages.

Unlike the JAX version, it does not re-run itself on the CPU when fewer
than n devices are visible: it raises, and the caller asks for
``device="cpu"`` (n ranks on the CPU, ``gloo``; n CPU mesh entries).

The module also holds the rank side of training cases over a mesh
(:class:`TrainCase`, :func:`run_train_cases`): spawned processes import
their functions from here.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from . import distributed

#: The collectives of a spawned group give up after this long.
GROUP_TIMEOUT = timedelta(seconds=60)


def make_recipe(spec: tuple):
    """An optimizer recipe from a picklable spec: ``("adam", lr)``,
    ``("adamw", lr)`` or ``("chain", lr, warmup_steps, decay_steps)``
    (``tools/train_models.py``'s chain: clip 1.0, AdamW with weight decay
    1e-4 on a warmup-cosine schedule from 0)."""
    from ..train import optim

    name, lr = spec[0], spec[1]
    if name == "adam":
        return optim.adam(lr)
    if name == "adamw":
        return optim.adamw(lr)
    if name == "chain":
        schedule = optim.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=spec[2], decay_steps=spec[3])
        return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(schedule, weight_decay=1e-4))
    raise ValueError(f"unknown recipe {spec!r}")


@dataclass
class TrainCase:
    """Steps of one model over a mesh of ``world / model_parallel`` x
    `model_parallel`, from JAX-layout `params` (numpy), one global batch a
    step (numpy arrays). `dtype` "bfloat16" runs the real train step;
    "float32" the same update with float32 activations and TF32 off
    (recognizers only). With `checkpoint`, the state is saved after the
    steps, restored into a fresh sharded state, and that state takes one
    more step on `extra_batch`. With `gru_check` (the CRNN), the first
    step's input to ``gru1`` is kept, and after the steps the GRU kernel is
    held against its plain version on the operands the layer makes of it."""

    name: str
    kind: str  # "recognition" | "detection"
    params: Any
    batches: list
    recipe: tuple = ("adam", 1e-3)
    arch: Optional[str] = None
    model_parallel: int = 1
    dtype: str = "bfloat16"
    checkpoint: bool = False
    extra_batch: Optional[tuple] = None
    gru_check: bool = False


def flat_params(tree) -> dict[str, np.ndarray]:
    """A JAX-layout tree as a weight file's flat mapping (``/``-joined)."""
    from ..models.weights import _flatten

    return {k.replace(".", "/"): v for k, v in _flatten(tree).items()}


def gru_launches() -> int:
    from ..ops import gru

    return gru.bigru_sequence.launches + gru.gru_sequence.launches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _init_state(case: TrainCase, mesh, device):
    from ..train import train

    recipe = make_recipe(case.recipe)
    if case.kind == "recognition":
        state = train.init_recognition_state(recipe, arch=case.arch, init_params=case.params, device=device, mesh=mesh)
    else:
        state = train.init_detection_state(recipe, init_params=case.params, device=device, mesh=mesh)
    return recipe, state


def _step(case: TrainCase, recipe, state, mesh, batch):
    """One update of `case` on this rank's rows of `batch`; the global loss."""
    from ..train import train

    local = train.shard_batch(mesh, *batch)
    if case.dtype == "bfloat16":
        if case.kind == "recognition":
            step = train.make_recognition_train_step(recipe, arch=case.arch, mesh=mesh)
        else:
            step = train.make_detection_train_step(recipe, mesh=mesh)
        return step(state, *local)[1]
    if case.kind != "recognition":
        raise ValueError("float32 steps are the recognizers' (the U-Net computes in bf16)")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss = train.recognition_loss(state.model, *local, dtype=torch.float32, net=state.net)
        train.apply_gradients(state, loss)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return train.global_loss(state, loss)


def bigru_kernel_vs_plain(layer, x: torch.Tensor) -> dict:
    """The GRU kernel (:func:`..ops.gru.bigru_sequence`) against its plain
    version on the operands that the BiGRU `layer` makes of its input `x`
    [N, T, C], as :func:`..models.nn.bigru_apply` makes them. Where the
    layer's projections are split over a model group this gathers them:
    every rank of the group calls it. On the CPU both sides are the plain
    version."""
    from ..models.nn import project
    from ..ops import gru

    f32 = torch.float32
    with torch.no_grad():
        dirs = (layer.fwd.params(), layer.bwd.params())
        xps = [
            (project(x, p["wx"].to(x.dtype), p.get("model_group")).to(f32) + p["bx"].to(f32)).transpose(0, 1)
            for p in dirs
        ]
        rec = [t for p in dirs for t in (p["wh"].to(f32).contiguous(), p["bh"].to(f32).contiguous())]
        err = (gru.bigru_sequence(*xps, *rec) - gru.bigru_sequence_reference(*xps, *rec)).abs().max()
    return {"input_shape": list(x.shape), "max_abs_err": float(err)}


def _whole_grads(state) -> dict[str, np.ndarray]:
    """The last update's gradients of the loss, whole, as the data group
    averaged them (the clip's scale taken out again); flat JAX layout."""
    from ..models.weights import params_to_jax

    opt = state.optimizer
    scale = 1.0
    if opt.grad_norm is not None:
        scale = max(1.0, float(opt.grad_norm) / opt.recipe.clip_norm)
    return flat_params(params_to_jax({n: opt.whole(n, p.grad) * scale for n, p in opt.named_params.items()}))


def run_train_case(case: TrainCase, mesh, device=None, ckpt_dir: Optional[Path] = None) -> dict:
    """Run `case` on this rank (under `mesh`, or on one `device` without
    one). Returns the global losses, the clip's norms, each update's
    gradients, ms a step (fenced), the GRU launches, and the whole
    parameters after the steps (JAX layout, flat); with ``case.checkpoint``
    also the checkpoint file's flat content, and the parameters and
    gradients of the restored state's extra step."""
    from ..models.weights import load_flat, params_to_jax
    from ..train import checkpoint, train

    recipe, state = _init_state(case, mesh, device)
    dev = state.device
    gru_inputs: list = []
    hook = None
    if case.gru_check:
        hook = state.model.net.gru1.register_forward_hook(
            lambda m, inp, out: gru_inputs.append(inp[0].detach()) if not gru_inputs else None
        )
    launches0 = gru_launches()
    losses, norms, step_ms, grads = [], [], [], []
    for batch in case.batches:
        _sync(dev)
        t0 = time.perf_counter()
        loss = _step(case, recipe, state, mesh, batch)
        losses.append(float(loss))
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norm = state.optimizer.grad_norm
        norms.append(None if norm is None else float(norm))
        grads.append(_whole_grads(state))
    out = {
        "losses": losses,
        "grad_norms": norms,
        "grads": grads,
        "step_ms": step_ms,
        "gru_launches": gru_launches() - launches0,
        "params": flat_params(params_to_jax(train.gathered_state_dict(state))),
        "split": sorted(state.optimizer.split),
        "device": str(dev),
    }
    if hook is not None:
        hook.remove()
        out["gru_check"] = bigru_kernel_vs_plain(state.model.net.gru1, gru_inputs[0])
    if case.checkpoint:
        path = checkpoint.save_checkpoint(ckpt_dir, state)
        out["checkpoint"] = load_flat(path)[0]
        _, fresh = _init_state(case, mesh, device)
        checkpoint.restore_checkpoint(path, fresh)
        _step(case, recipe, fresh, mesh, case.extra_batch)
        out["after_restore_step"] = flat_params(params_to_jax(train.gathered_state_dict(fresh)))
        out["extra_grads"] = _whole_grads(fresh)
    return out


def _refusals(mesh_world: int) -> dict[str, bool]:
    """Whether uneven worlds, batches and splits raise ``ValueError`` on
    this rank (collective: every rank calls it)."""
    from ..models.weights import params_to_jax
    from ..models.recognition_net import RecognitionModel
    from ..train import optim, train

    out = {}
    try:
        train.make_mesh(model_parallel=mesh_world + 1)
        out["world_not_divisible_by_model_parallel"] = False
    except ValueError:
        out["world_not_divisible_by_model_parallel"] = True
    mesh = train.make_mesh(model_parallel=1)
    try:
        train.shard_batch(mesh, np.zeros((mesh.data_size + 1, 2)))  # data_size = mesh_world >= 2
        out["uneven_batch"] = False
    except ValueError:
        out["uneven_batch"] = True
    if mesh_world % 2 == 0:
        mesh2 = train.make_mesh(model_parallel=2)
        tree = params_to_jax(RecognitionModel.create(seed=0, n_classes=97, hidden=8, arch="crnn").net.state_dict())
        try:
            train.init_recognition_state(optim.adam(1e-3), arch="crnn", init_params=tree, mesh=mesh2)
            out["head_97_over_model_2"] = False
        except ValueError:
            out["head_97_over_model_2"] = True
    return out


def train_cases_rank(rank: int, world: int, store: str, device: str, backend: Optional[str], cases: list,
                     out_path: str, refusals: bool = False) -> None:
    """A spawned rank: join the group, run every case under its mesh, and
    (rank 0) save the results to `out_path` with ``torch.save``."""
    from ..train import train

    dev = distributed.init_process_group(
        device, backend, init_method=store, rank=rank, world_size=world, timeout=GROUP_TIMEOUT
    )
    try:
        from .. import cuda_build

        results: dict[str, Any] = {"world": world, "backend": torch.distributed.get_backend()}
        if dev.type == "cuda":
            # Built by the parent: loaded, not compiled again.
            results["library_existed"] = cuda_build.library_path("gru_seq").exists()
            results["built_in_rank"] = sorted(cuda_build.build(["gru_seq"]))
        ckpt_root = Path(out_path).with_suffix(".ckpt")
        for case in cases:
            mesh = train.make_mesh(model_parallel=case.model_parallel, device=dev)
            results[case.name] = run_train_case(case, mesh, ckpt_dir=ckpt_root / case.name)
            results[case.name]["mesh"] = mesh.shape
            # On the rank's device: NCCL gathers nothing else.
            launches = torch.tensor([results[case.name]["gru_launches"]], dtype=torch.int64, device=dev)
            gathered = [torch.zeros_like(launches) for _ in range(world)]
            torch.distributed.all_gather(gathered, launches)
            results[case.name]["gru_launches_by_rank"] = [int(t.item()) for t in gathered]
        if refusals:
            results["refusals"] = _refusals(world)
        if rank == 0:
            torch.save(results, out_path)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def run_train_cases(cases: list, world: int, device: str = "cuda", backend: Optional[str] = None,
                    refusals: bool = False, timeout: float = 600.0, work_dir: Path | str | None = None) -> dict:
    """Run `cases` in `world` spawned ranks on `device` (every rank on that
    device: ``"cuda:0"`` twice shares one card) and return rank 0's
    results, keyed by case name."""
    base = Path(work_dir) if work_dir is not None else distributed.STORE_DIR
    base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cases-", dir=base))
    try:
        out = tmp / "results.pt"
        distributed.spawn(
            train_cases_rank, world, args=(device, backend, cases, str(out), refusals), timeout=timeout,
            store_dir=base,
        )
        return torch.load(out, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- dryrun_multichip ---------------------------------------------------------------


def _dryrun_rank(rank: int, world: int, store: str, device_type: str, model_parallel: int, out_path: str) -> None:
    """Part 1 on one rank, on its own device (``cuda:rank`` or the CPU):
    the sharded CRNN step (rank 0 also takes the one-device step on the same
    batch and saves both losses)."""
    from ..train import optim, train

    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    dev = distributed.init_process_group(device, init_method=store, rank=rank, world_size=world,
                                         timeout=GROUP_TIMEOUT)
    try:
        mesh = train.make_mesh(world, model_parallel=model_parallel, device=dev)
        optimizer = optim.adamw(1e-3)
        state = train.init_recognition_state(optimizer, n_classes=24, hidden=64, mesh=mesh)
        step = train.make_recognition_train_step(optimizer, mesh=mesh)
        batch = max(world, 8)
        images = np.zeros((batch, 1, 64, 64), np.float32)
        labels = np.ones((batch, 4), np.int32)
        lengths = np.full((batch,), 4, np.int32)
        launches0 = gru_launches()
        _, loss = step(state, *train.shard_batch(mesh, images, labels, lengths))
        loss = float(loss)
        launches = gru_launches() - launches0
        if rank == 0:
            single = train.init_recognition_state(optimizer, n_classes=24, hidden=64, device=dev)
            _, single_loss = train.make_recognition_train_step(optimizer)(single, images, labels, lengths)
            torch.save({"loss": loss, "single_loss": float(single_loss), "mesh": mesh.shape,
                        "gru_launches_rank0": launches}, out_path)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _dryrun_pages(n: int) -> tuple[np.ndarray, list[str]]:
    """`n` pages of 800 x 608 u8, a line of text each, drawn as the JAX
    dryrun draws them: Pillow's built-in face at 152 x 200, scaled up 4x by
    nearest neighbour to a text height the recognizer reads."""
    from PIL import Image, ImageDraw

    texts = [f"PAGE {i} ocr test {100 + i}" for i in range(n)]
    pages = np.empty((n, 800, 608), dtype=np.uint8)
    for i, line in enumerate(texts):
        tiny = Image.new("L", (152, 200), 255)
        ImageDraw.Draw(tiny).text((6, 40 + 10 * (i % 3)), line, font=None, fill=0)
        pages[i] = np.asarray(tiny.resize((608, 800), Image.NEAREST))
    return pages, texts


def _pipeline_parts(n: int, device_type: str) -> dict:
    """Parts 2 and 3: the sharded pipeline against the unsharded one."""
    from ..engine import DEFAULT_ALPHABET
    from ..models.fakes import FakeDetectionModel, FakeRecognitionModel
    from ..models.weights import load_detection_model, load_recognition_model
    from .pipeline import PagePipeline
    from .sharding import make_data_mesh

    mesh = make_data_mesh(n, device_type=device_type)
    first = mesh.devices[0]
    batch = max(n, 8)
    pages = np.zeros((batch, 100, 200), dtype=np.float32)
    for i in range(batch):
        pages[i, 30:50, 20 + (5 * i) % 80 : 90 + (5 * i) % 80] = 1.0
    alphabet = DEFAULT_ALPHABET[:63]

    def fake(m):
        return PagePipeline(FakeDetectionModel(), FakeRecognitionModel(), alphabet, max_lines_per_batch=8,
                            mesh=m, device=None if m is not None else first)

    plain, sharded = fake(None).process(pages), fake(mesh).process(pages)
    if not len(plain) == len(sharded) == batch:
        raise AssertionError(f"fake pipeline: {len(plain)} / {len(sharded)} results for {batch} pages")
    for a, b in zip(plain, sharded):
        if a.text != b.text or len(a.words) != len(b.words):
            raise AssertionError(f"fake pipeline: sharded {b.text!r} ({len(b.words)} words) != {a.text!r} ({len(a.words)})")
    print(f"dryrun_multichip: sharded inference pipeline OK ({batch} pages, sharded == unsharded text)", flush=True)

    weights = Path(__file__).resolve().parents[2] / "weights"
    det = load_detection_model(weights / "text-detection.npz")
    rec = load_recognition_model(weights / "text-recognition.npz")
    pages, _ = _dryrun_pages(n)
    plain = PagePipeline(det, rec, DEFAULT_ALPHABET, device=first).process(pages)
    sharded = PagePipeline(det, rec, DEFAULT_ALPHABET, mesh=mesh).process(pages)
    if not len(plain) == len(sharded) == n:
        raise AssertionError(f"real pipeline: {len(plain)} / {len(sharded)} results for {n} pages")
    n_nonempty = 0
    for i, (a, b) in enumerate(zip(plain, sharded)):
        if a.text != b.text:
            raise AssertionError(f"real pipeline page {i}: sharded {b.text!r} != unsharded {a.text!r}")
        n_nonempty += bool(a.text.strip())
    if n_nonempty < n - 1:
        raise AssertionError(f"only {n_nonempty}/{n} pages decoded text: {[p.text for p in plain]}")
    print(f"dryrun_multichip: REAL-arch sharded pipeline OK ({n} pages 800x608, trained U-Net + ConvCTC, "
          f"sharded == unsharded text, {n_nonempty}/{n} non-empty, e.g. {plain[0].text!r})", flush=True)
    return {"fake_pages": batch, "real_pages": n, "real_nonempty": n_nonempty, "real_texts": [p.text for p in plain]}


def dryrun_multichip(n_devices: int, device: Optional[str] = None, timeout: float = 600.0) -> dict:
    """The JAX package's ``dryrun_multichip`` on `n_devices` devices of the
    port (see the module docstring). `device`: "cuda" (the default; n
    visible cards, one rank each, ``nccl``) or "cpu" (n ranks, ``gloo``).
    Raises ``RuntimeError`` where fewer than n cards are visible: there is
    no quiet re-run on the CPU. Returns what it measured."""
    device_type = torch.device(device or "cuda").type
    if device_type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices and {visible} are visible; "
                "pass device='cpu' to run its ranks on the CPU"
            )
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    base = distributed.STORE_DIR
    base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="dryrun-", dir=base))
    try:
        out = tmp / "train.pt"
        distributed.spawn(_dryrun_rank, n_devices, args=(device_type, model_parallel, str(out)), timeout=timeout)
        train = torch.load(out, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not np.isfinite(train["loss"]):
        raise AssertionError(f"non-finite loss: {train['loss']}")
    if abs(train["loss"] - train["single_loss"]) > 1e-2 * abs(train["single_loss"]):
        raise AssertionError(f"sharded loss {train['loss']} is not the one-device loss {train['single_loss']}")
    print(f"dryrun_multichip: train step OK ({n_devices} devices, mesh {train['mesh']}, loss {train['loss']:.4f})",
          flush=True)
    report = {"train": train, **_pipeline_parts(n_devices, device_type)}
    print(f"dryrun_multichip OK: {n_devices} devices, train step + sharded pipeline", flush=True)
    return report

