"""Support for the port's tests; it holds no tests of its own.

The port's parity tests hold it against the JAX package, whose layout, CTC
collapse and beam, run-table rect fit and low-bandwidth transport take the
native host library (``ocrs_tpu/native.py``) where it loads and other routes
where it does not. That loader compiles straight onto
``_build/libocrs_native.so`` with no lock, and a process that once failed to
load it (another process was writing the file, or the build timed out)
keeps the failure for its life. Test workers that start together on a
checkout without ``_build/`` can lose that race, and a port test would then
be compared with routes the JAX package takes only without its library.

:func:`_require_jax_native` repairs this in the calling process: it rebuilds
the library under a file lock, into a temporary file moved into place, and
loads it again. The fixture ``jax_native`` calls it once per module.

It also holds the pages, converters and comparisons that the tests of the
entry points (output, serving, CLI) share.
"""

import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from ocrs_tpu import native as jnative

#: The JAX loader's own compiler flags (``ocrs_tpu/native.py::_build``).
JAX_NATIVE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _require_jax_native() -> None:
    """Make ``ocrs_tpu.native`` available in this process, or skip where no
    C++ compiler exists. A compiler that fails raises with its output."""
    if jnative.available():
        return
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("the JAX package's native library cannot be built: no g++ on PATH")
    jnative._BUILD_DIR.mkdir(exist_ok=True)
    with open(jnative._BUILD_DIR / "libocrs_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            digest = jnative._src_digest()
            tmp = jnative._LIB_PATH.with_name(f"libocrs_native.{os.getpid()}-{threading.get_ident()}.tmp")
            out = subprocess.run(
                [cxx, *JAX_NATIVE_FLAGS, str(jnative._SRC), "-o", str(tmp)],
                capture_output=True,
                text=True,
                timeout=600,
            )
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {jnative._SRC}:\n{out.stdout}{out.stderr}")
            os.replace(tmp, jnative._LIB_PATH)
            jnative._STAMP_PATH.write_text(digest)
            with jnative._lock:
                jnative._tried = False
                jnative._lib = None
            loaded = jnative.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if not loaded:
        raise RuntimeError(f"{jnative._LIB_PATH} was rebuilt but does not load")


@pytest.fixture(scope="module")
def jax_native():
    _require_jax_native()


# ---------------------------------------------------------------------------
# Shared by the tests of the entry points (output, serving, CLI).
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
DET_WEIGHTS = REPO / "weights" / "text-detection.npz"
REC_WEIGHTS = REPO / "weights" / "text-recognition.npz"


def text_page_rgb() -> np.ndarray:
    """The text page of ``chip_smoke.py`` (lines the shipped recognizer reads
    with wide margins) as (H, W, 3) uint8."""
    return np.repeat(chip_smoke.text_page(), 3, axis=2)


def to_port_text_lines(lines):
    """JAX ``TextLine``s (or None) -> the port's, char rects unchanged."""
    from ocrs_tpu_torch.geometry import Rect
    from ocrs_tpu_torch.text_items import TextChar, TextLine

    return [
        None
        if tl is None
        else TextLine([TextChar(c.char, Rect.from_tlbr(c.rect.top, c.rect.left, c.rect.bottom, c.rect.right)) for c in tl.chars()])
        for tl in lines
    ]


def to_port_rrects(rects):
    from ocrs_tpu_torch.geometry import RotatedRect

    return [RotatedRect(r.center, r.up, r.width, r.height) for r in rects]


def assert_same_ocr_json(got: dict, want: dict, atol: float = 1.0) -> None:
    """Two HierText-style documents: the same texts at every level, vertices
    within `atol` pixels (the two U-Nets compute in bf16)."""
    assert {k: v for k, v in got.items() if k != "paragraphs"} == {k: v for k, v in want.items() if k != "paragraphs"}
    (gp,), (wp,) = got["paragraphs"], want["paragraphs"]
    assert [l["text"] for l in gp["lines"]] == [l["text"] for l in wp["lines"]]
    for gl, wl in zip(gp["lines"], wp["lines"]):
        assert [w["text"] for w in gl["words"]] == [w["text"] for w in wl["words"]]
        for a, b in [(gl, wl)] + list(zip(gl["words"], wl["words"])):
            np.testing.assert_allclose(np.array(a["vertices"]), np.array(b["vertices"]), atol=atol)
