"""Rules the port keeps: it imports neither JAX nor the JAX package, its
entry points default to CUDA and raise without it, and its kernel modules
import and run their plain versions on a CPU-only machine without nvcc."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ocrs_tpu_torch
from ocrs_tpu_torch import engine as tengine

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ocrs_tpu_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "ocrs_tpu")


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax_or_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, ocrs_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(ocrs_tpu_torch.__path__, 'ocrs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ocrs_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('ocrs_tpu_torch')]), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 26 and bad.strip() == "[]"


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ocrs_tpu_torch.OcrEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        ocrs_tpu_torch.OcrEngine(device="cuda:0")
    assert ocrs_tpu_torch.OcrEngine(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tengine.resolve_device(None) == torch.device("cuda")


def test_pipeline_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from ocrs_tpu_torch.models.fakes import FakeDetectionModel, FakeRecognitionModel

    make = lambda **kw: ocrs_tpu_torch.PagePipeline(FakeDetectionModel(), FakeRecognitionModel(), "abc", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    with pytest.raises(RuntimeError, match="CUDA"):
        make(device="cuda:0")
    pipe = make(device="cpu")
    assert pipe.device == torch.device("cpu") and pipe._copy_stream is None


def test_lowbw_transport_raises_with_the_builds_reason_when_the_library_cannot_be_built(tmp_path):
    # A compiler that fails: the loader keeps its output, available() is
    # false, the numpy routes still run, and asking for "lowbw" raises it.
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'ocrs_native.cpp:1: error: no such toolchain' >&2\nexit 1\n")
    cxx.chmod(0o755)
    code = (
        "import numpy as np, pathlib, ocrs_tpu_torch\n"
        "from ocrs_tpu_torch import native\n"
        "from ocrs_tpu_torch.models.fakes import FakeDetectionModel, FakeRecognitionModel\n"
        f"native._BUILD_DIR = pathlib.Path({str(tmp_path / 'build')!r})\n"
        "assert not native.available() and 'no such toolchain' in native.build_error()\n"
        "make = lambda **kw: ocrs_tpu_torch.PagePipeline(FakeDetectionModel(), FakeRecognitionModel(), "
        "ocrs_tpu_torch.DEFAULT_ALPHABET[:63], device='cpu', **kw)\n"
        "pages = np.zeros((1, 100, 200), np.uint8); pages[0, 30:50, 20:90] = 255\n"
        "assert len(make().process(pages)[0].words) == 1\n"
        "for call in (native.require, lambda: make(transport='lowbw')):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        print(e)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(CXX=str(cxx)), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert sum("no such toolchain" in line for line in lines) == 2
    assert any("transport='lowbw'" in line for line in lines)


def test_kernel_module_runs_plain_version_without_nvcc(tmp_path):
    code = (
        "import torch\n"
        "from ocrs_tpu_torch import cuda_build\n"
        "from ocrs_tpu_torch.ops import gru\n"
        "x = torch.randn(5, 3, 8)\n"
        "out = gru.gru_sequence(x, x, x, torch.randn(8, 24), torch.zeros(24))\n"
        "assert out.shape == (5, 3, 8) and gru.gru_sequence.launches == 0 and not cuda_build._loaded\n"
        "try:\n"
        "    cuda_build.nvcc_path()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n"
    )
    env = _clean_env(PATH=os.path.dirname(sys.executable) + ":/usr/bin:/bin", CUDA_HOME=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no nvcc"


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    # Pretend a card is present, so the script reaches its imports.
    code = (
        "import runpy, torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=_clean_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "checkout" in out.stderr


@pytest.mark.parametrize("module", ["cli", "serve", "output", "png"])
def test_entry_point_modules_import_neither_jax_nor_pillow(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module('ocrs_tpu_torch.{module}')\n"
        "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ocrs_tpu', 'PIL')])\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


TRAINING_DATA_MODULES = [
    "train.render", "train.data", "train.hiertext", "train.train_models", "train.demo", "models.convert", "testing",
]


@pytest.fixture(scope="module")
def imported_without_pillow():
    """One process with Pillow blocked imports each module in turn: {module:
    "ok" or its error}, and the JAX modules loaded after all of them (none
    of them may load one, so one process answers for each)."""
    code = (
        "import sys, importlib, json\n"
        "sys.modules['PIL'] = None\n"
        "result = {}\n"
        f"for m in {TRAINING_DATA_MODULES!r}:\n"
        "    try:\n"
        "        importlib.import_module('ocrs_tpu_torch.' + m)\n"
        "        result[m] = 'ok'\n"
        "    except Exception as e:\n"
        "        result[m] = repr(e)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ocrs_tpu')]\n"
        "print(json.dumps({'modules': result, 'jax': bad}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    return __import__("json").loads(out.stdout)


@pytest.mark.parametrize("module", TRAINING_DATA_MODULES)
def test_training_data_modules_import_without_pillow_jax_or_the_jax_package(module, imported_without_pillow):
    assert imported_without_pillow["modules"][module] == "ok"
    assert imported_without_pillow["jax"] == []


def test_without_pillow_drawing_raises_and_the_committed_caches_still_train():
    # Drawing names Pillow; loading a committed cache draws nothing, so its
    # batches come as they do with Pillow.
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from ocrs_tpu_torch.train import data, render\n"
        "for call in (lambda: render.render_recognition_sample(np.random.default_rng(0), 256),\n"
        "             lambda: render.render_native_page(np.random.default_rng(0), (100, 100)),\n"
        "             lambda: data.render_line('x'), lambda: next(data.recognition_batches(1))):\n"
        "    try:\n"
        "        call()\n"
        "    except render.RenderUnavailable as e:\n"
        "        print('Pillow' in str(e))\n"
        "ds = data.RecognitionDataset(0, cache_path='test-data/train/rec_64_768_s0.npz')\n"
        "det = data.DetectionDataset(0, cache_path='test-data/train/det_8_s0.npz')\n"
        "imgs, labels, lengths = next(ds.batches(4, seed=1, as_u8=True))\n"
        "pages, masks = next(det.batches(2, seed=1))\n"
        "print(len(ds), len(det), imgs.shape, int(lengths.min()) > 0, pages.shape, float(masks.max()))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["True"] * 4 + ["64 8 (4, 1, 64, 768) True (2, 1, 800, 608) 1.0"]


def test_without_a_face_of_the_bank_drawing_raises(monkeypatch):
    from ocrs_tpu_torch.train import render

    monkeypatch.setattr(render, "candidate_paths", lambda: [(c, None) for c in render._FONT_CANDIDATES])
    render.font_paths.cache_clear()
    try:
        with pytest.raises(render.RenderUnavailable, match="font bank"):
            render.font_paths()
        with pytest.raises(render.RenderUnavailable, match="font bank"):
            render.sample_style(__import__("numpy").random.default_rng(0))
    finally:
        render.font_paths.cache_clear()
