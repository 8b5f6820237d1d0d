#!/usr/bin/env python3
"""Write the committed page sets of ``test-data/eval/`` and the JAX tools'
results on them.

Run from a checkout of the repository on a machine that can draw (Pillow,
the font bank's faces, matplotlib, pygame and the ``pettingzoo`` package's
Minecraft.ttf) and that has the JAX package:

    JAX_PLATFORMS=cpu python3 tools/torch_eval_fixtures.py [--out test-data/eval]

It draws every page with the port's renderers (``ocrs_tpu_torch``) and writes:

  * ``accuracy_s1234_p8.npz``: the 8 styled pages (and their ground-truth
    words) that ``tools/eval_accuracy.py`` draws at its defaults;
  * ``independent.npz``: the 9 pages, expected texts and groups of
    ``tools/eval_independent.py``;
  * ``profile_p16.npz``: the 16 pages of 3508 x 2480 that
    ``tools/profile_stages.py`` draws;
  * ``reference.json``: the JAX tools' results on the CPU on those pages:
    ``tools/eval_accuracy.py --detect weights/text-detection.npz --rec
    weights/text-recognition.npz --pages 8`` and ``tools/eval_independent.py``
    with its defaults, each run as a subprocess as a user runs it, and each
    accuracy page scored alone by the JAX tool's ``evaluate``.

It checks that the JAX package's renderers draw the same arrays, so that the
JAX tools scored the committed pages. Machines that cannot draw (the card's)
read the files through the port tools' ``--pages-from``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ACCURACY_SEED, ACCURACY_PAGES = 1234, 8
PROFILE_PAGES = 16
ACCURACY_ARGS = [
    "--detect", "weights/text-detection.npz", "--rec", "weights/text-recognition.npz", "--pages", str(ACCURACY_PAGES)
]


def jax_tool(script: str, args: list[str]) -> dict:
    """A JAX tool run as a subprocess on the CPU, with the repository on
    its path; its JSON output."""
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path)
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / script), *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=1800, check=True,
    ).stdout
    return json.loads(out[out.index("{"):])


@contextlib.contextmanager
def jax_pages(pages):
    """``ocrs_tpu.train.render.render_native_page`` replaced by one that
    hands out `pages` (uint8) in turn, as the floats the JAX tool turns back
    into the same bytes."""
    import ocrs_tpu.train.render as jrender

    queue = [((page.astype(np.float64) + 0.5) / 255.0, words) for page, words in pages]
    original = jrender.render_native_page
    jrender.render_native_page = lambda rng: queue.pop(0)
    try:
        yield
    finally:
        jrender.render_native_page = original


def accuracy_per_page(pages) -> list[dict]:
    """Each page scored alone by the JAX tool's ``evaluate`` with the
    engine its ``main`` builds."""
    import eval_accuracy as jtool
    from ocrs_tpu.engine import OcrEngine, OcrEngineParams
    from ocrs_tpu.models.weights import load_detection_model, load_params, load_recognition_model

    rec_path = str(REPO / "weights" / "text-recognition.npz")
    _, rec_meta = load_params(rec_path)
    engine = OcrEngine(
        OcrEngineParams(
            detection_model=load_detection_model(str(REPO / "weights" / "text-detection.npz")),
            recognition_model=load_recognition_model(rec_path),
            alphabet=rec_meta.get("alphabet"),
        )
    )
    per_page = []
    for i, page in enumerate(pages):
        with jax_pages([page]):
            result = jtool.evaluate(engine, 1, ACCURACY_SEED, 0.3, 1)
        per_page.append({"page": i, "hw": list(page[0].shape), "words": len(page[1]), **result})
    return per_page


def check_jax_renderers(acc_pages, groups) -> None:
    """The JAX package's renderers draw the committed arrays."""
    import eval_independent as jind
    from ocrs_tpu.train.render import render_native_page

    rng = np.random.default_rng(ACCURACY_SEED)
    for i, (page, words) in enumerate(acc_pages):
        page01, gt = render_native_page(rng)
        while len(gt) == 0:
            page01, gt = render_native_page(rng)
        assert np.array_equal((page01 * 255).astype(np.uint8), page), f"accuracy page {i} differs from the JAX renderer's"
        assert [w for w, _ in gt] == [w for w, _ in words], f"accuracy page {i}'s words differ"
    jax_groups = {
        "matplotlib": jind.render_matplotlib(0), "pygame": jind.render_pygame(1), "heldout-font": jind.render_heldout_font(2)
    }
    for group, pages in groups.items():
        assert len(jax_groups[group]) == len(pages), group
        for i, ((img, text), (jimg, jtext)) in enumerate(zip(pages, jax_groups[group])):
            assert np.array_equal(img, jimg) and text == jtext, f"{group} page {i} differs from the JAX tool's"


def git_commit() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, cwd=REPO, check=True
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=Path, default=REPO / "test-data" / "eval")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO / "tools"))

    from ocrs_tpu_torch.tools import eval_accuracy, eval_independent, profile_stages

    args.out.mkdir(parents=True, exist_ok=True)
    acc_pages = eval_accuracy.draw_pages(ACCURACY_PAGES, ACCURACY_SEED)
    eval_accuracy.save_pages(args.out / f"accuracy_s{ACCURACY_SEED}_p{ACCURACY_PAGES}.npz", acc_pages, ACCURACY_SEED)
    groups = eval_independent.draw_groups()
    eval_independent.save_groups(args.out / "independent.npz", groups)
    np.savez_compressed(args.out / f"profile_p{PROFILE_PAGES}.npz", pages=profile_stages.draw_pages(PROFILE_PAGES))
    check_jax_renderers(acc_pages, groups)

    reference = {
        "commit": git_commit(),
        "platform": "JAX_PLATFORMS=cpu",
        "machine": f"{platform.machine()}, {os.cpu_count()} cores",
        "eval_accuracy": {
            "command": "PYTHONPATH=. python tools/eval_accuracy.py " + " ".join(ACCURACY_ARGS),
            "result": jax_tool("eval_accuracy.py", ACCURACY_ARGS),
            "per_page": accuracy_per_page(acc_pages),
        },
        "eval_independent": {
            "command": "PYTHONPATH=. python tools/eval_independent.py",
            "result": jax_tool("eval_independent.py", []),
            "pages": {group: [list(img.shape) for img, _ in pages] for group, pages in groups.items()},
        },
    }
    (args.out / "reference.json").write_text(json.dumps(reference, indent=1) + "\n")
    for path in sorted(args.out.iterdir()):
        print(f"{path.relative_to(REPO)}: {path.stat().st_size} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
