"""The port's CLI (``python -m ocrs_tpu_torch.cli``) against the JAX
package's (``ocrs_tpu.cli``): the counterparts of the CLI tests in
tests/test_output_cli.py, and each flag once.

With the shipped weights the ``--json`` output must equal ``ocrs_tpu.cli``'s
on the same PNG: texts exactly, vertices within 1 px (the two U-Nets compute
in bf16). Two tests start a subprocess; the rest call ``main`` in process,
in a temporary working directory, with ``--device cpu``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ocrs_tpu import cli as jcli
from ocrs_tpu_torch import cli
from ocrs_tpu_torch.png import decode_png, read_png, write_png
from test_torch_options import PAGES as OPTION_PAGES
from test_torch_support import (
    DET_WEIGHTS,
    REC_WEIGHTS,
    REPO,
    assert_same_ocr_json,
    jax_native,  # noqa: F401 - a fixture, used by pytestmark
)

# The JAX CLI's layout and CTC collapse take its native library.
pytestmark = pytest.mark.usefixtures("jax_native")

CPU = ["--device", "cpu"]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


def _write_page(tmp_path, name):
    path = tmp_path / f"{name}.png"
    write_png(path, OPTION_PAGES[name])
    return path


def test_cli_end_to_end(tmp_path):
    """The CLI as a subprocess on a tiny image with random weights."""
    img_path = tmp_path / "test.png"
    rng = np.random.default_rng(0)
    write_png(img_path, rng.integers(0, 255, (64, 96, 3), dtype=np.uint8))
    result = subprocess.run(
        [sys.executable, "-m", "ocrs_tpu_torch.cli", str(img_path), "--random-weights", "--json", *CPU],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=tmp_path,
    )
    assert result.returncode == 0, result.stderr
    doc = json.loads(result.stdout)
    assert doc["image_width"] == 96 and doc["image_height"] == 64
    assert "paragraphs" in doc and doc["url"] == str(img_path)


def test_cli_reads_stdin(tmp_path, capsys):
    """An image piped to ``-`` reads as the same image given by path."""
    path = _write_page(tmp_path, "plain")
    result = subprocess.run(
        [sys.executable, "-m", "ocrs_tpu_torch.cli", "-", *CPU],
        input=path.read_bytes(), capture_output=True, timeout=600, env=_env(), cwd=tmp_path,
    )
    assert result.returncode == 0, result.stderr
    assert cli.main([str(path), *CPU]) == 0
    assert result.stdout.decode() == capsys.readouterr().out
    assert result.stdout.decode().splitlines() == ["Section 12 notes", "This line is longer", "notes Section 12"]


def test_cli_missing_image(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.main(["definitely-missing.png", "--fake-models", *CPU])
    assert exc.value.code not in (0, None) and "definitely-missing.png" in str(exc.value.code)
    (tmp_path / "garbage.png").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="decode"):
        cli.main(["garbage.png", "--fake-models", *CPU])


def test_cli_default_weights_discovery():
    """Without --detect-model/--rec-model the CLI loads the shipped weights
    under <repo>/weights, as the JAX CLI does."""
    args = cli.build_parser().parse_args(["x.png"])
    det, rec = cli._load_models(args)
    jargs = jcli.build_parser().parse_args(["x.png"])
    jdet, jrec = jcli._load_models(jargs)
    assert (args.detect_model, args.rec_model) == (jargs.detect_model, jargs.rec_model) == (str(DET_WEIGHTS), str(REC_WEIGHTS))
    assert det.input_shape() == list(jdet.input_shape()) and rec.arch == jrec.arch == "convctc"


def test_cli_flags_and_defaults_mirror_jax():
    port, jax = cli.build_parser(), jcli.build_parser()
    dests = {a.dest: a for a in port._actions}
    for action in jax._actions:
        mine = dests[action.dest]
        assert (mine.option_strings, mine.default, mine.nargs, mine.type) == (
            action.option_strings, action.default, action.nargs, action.type
        ), action.dest
    assert set(dests) - {a.dest for a in jax._actions} == {"device"} and dests["device"].default is None


CASES = {
    "defaults": ("plain", []),
    "beam": ("plain", ["--beam"]),
    "allowed_chars": ("plain", ["--allowed-chars", "abcdefghijklmnopqrstuvwxyz "]),
    "deskew": ("rotated", ["--deskew"]),
    "vertical_text": ("vertical", ["--vertical-text"]),
    "min_line_conf": ("plain", ["--min-line-conf", "0.97"]),
    "rule_glyph": ("ruled", ["--rule-glyph", "["]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_json_equals_jax_cli(case, tmp_path, monkeypatch, capsys):
    page, flags = CASES[case]
    monkeypatch.chdir(tmp_path)
    path = str(_write_page(tmp_path, page))
    models = ["--detect-model", str(DET_WEIGHTS), "--rec-model", str(REC_WEIGHTS)]
    assert jcli.main([path, "--json", *models, *flags]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main([path, "--json", *models, *flags, *CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    assert_same_ocr_json(got, want)
    texts = [l["text"] for l in got["paragraphs"][0]["lines"]]
    assert texts
    if case == "allowed_chars":
        assert not any(ch.isdigit() or ch.isupper() for t in texts for ch in t)
    if case == "rule_glyph":
        assert texts[1] == "["


def test_cli_png_maps_line_images_output_and_debug(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    path = str(_write_page(tmp_path, "plain"))
    page = read_png(path)
    assert cli.main([path, "--png", "-o", "out.png", *CPU]) == 0
    annotated = decode_png((tmp_path / "out.png").read_bytes())
    assert annotated.shape == (*page.shape[:2], 3) and (annotated != page).any()
    assert cli.main([path, "--png", *CPU]) == 0 and (tmp_path / "ocr-annotated.png").exists()
    capsys.readouterr()
    argv = [path, "--text-map", "--text-mask", "--text-line-images", "--debug", "-o", "out.txt", *CPU]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    text = (tmp_path / "out.txt").read_text()
    assert text.splitlines() == ["Section 12 notes", "This line is longer", "notes Section 12"]
    assert "Found" in err and "Stage times: total=" in err and "recognize_text=" in err
    text_map, mask = read_png(tmp_path / "text-map.png"), read_png(tmp_path / "text-mask.png")
    assert text_map.shape == mask.shape == (*page.shape[:2], 1)
    assert set(np.unique(mask).tolist()) == {0, 255} and text_map.max() > 200
    lines = sorted((tmp_path / "lines").iterdir())
    assert [p.name for p in lines] == ["line-0.png", "line-1.png", "line-2.png"]
    assert all(read_png(p).shape[0] == 64 for p in lines)


def test_cli_fake_models_alphabet_and_clipboard(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    img = np.zeros((100, 200, 3), np.uint8)
    img[30:50, 20:90] = 255
    write_png("blocks.png", img)
    argv = ["blocks.png", "--fake-models", "--json"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main([*argv, *CPU]) == 0
    assert json.loads(capsys.readouterr().out) == want
    # An alphabet of the fake recognizer's 63 classes, another than the default.
    alphabet = "".join(chr(ord("A") + i % 26) for i in range(63))
    assert jcli.main(["blocks.png", "--fake-models", "-a", alphabet]) == 0
    want = capsys.readouterr().out
    assert cli.main(["blocks.png", "--fake-models", "-a", alphabet, *CPU]) == 0
    assert capsys.readouterr().out == want and want.strip()
    with pytest.raises(SystemExit, match="cannot use both"):
        cli.main(["blocks.png", "--clipboard", "--fake-models", *CPU])
    with pytest.raises(SystemExit, match="clipboard"):  # no clipboard here
        cli.main(["--clipboard", "--fake-models", *CPU])
    with pytest.raises(SystemExit) as exc:
        cli.main(["--version"])
    assert exc.value.code == 0 and "ocrs-tpu-torch 0.1.0" in capsys.readouterr().out


def test_cli_serve_flag_starts_the_server_on_the_device(monkeypatch, capsys):
    started = {}

    class Server:
        server_address = ("0.0.0.0", 4321)

        def shutdown(self):
            started["shutdown"] = True

        def server_close(self):
            started["closed"] = True

    def fake_serve(engine, host, port):
        started.update(engine=engine, host=host, port=port)
        return Server()

    class Interrupted(threading.Event):
        def wait(self, timeout=None):
            raise KeyboardInterrupt

    import ocrs_tpu_torch.serve as tserve

    monkeypatch.setattr(tserve, "serve", fake_serve)
    monkeypatch.setattr(threading, "Event", Interrupted)
    assert cli.main(["--serve", "4321", "--fake-models", "--beam", *CPU]) == 0
    assert started["host"] == "0.0.0.0" and started["port"] == 4321 and started["shutdown"] and started["closed"]
    assert started["engine"].device == torch.device("cpu")
    assert "serving OCR API on :4321" in capsys.readouterr().err


def test_cli_runs_on_cuda_unless_asked_and_fails_without_it(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_png("blocks.png", np.zeros((20, 30), np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["blocks.png", "--fake-models"], ["blocks.png", "--fake-models", "--device", "cuda"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code not in (0, None)
        assert "no CUDA device is available" in exc.value.code and "--device cpu" in exc.value.code


def test_cli_model_urls_read_from_the_cache(tmp_path, monkeypatch, capsys):
    cache = tmp_path / "cache"
    cache.mkdir()
    shutil.copy(DET_WEIGHTS, cache / "det.npz")
    shutil.copy(REC_WEIGHTS, cache / "rec.npz")
    monkeypatch.setenv("OCRS_TPU_CACHE", str(cache))
    import urllib.request

    def no_download(*args, **kwargs):
        raise AssertionError("a cached model was downloaded")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_download)
    monkeypatch.chdir(tmp_path)
    path = str(_write_page(tmp_path, "plain"))
    argv = [path, "--detect-model", "https://example.invalid/m/det.npz", "--rec-model", "http://example.invalid/rec.npz"]
    assert cli.main([*argv, *CPU]) == 0
    assert capsys.readouterr().out.splitlines() == ["Section 12 notes", "This line is longer", "notes Section 12"]
