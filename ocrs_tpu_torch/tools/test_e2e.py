"""Golden-output end-to-end test of the port's CLI: the port of the default
tier of ``tools/test_e2e.py``.

Runs ``python -m ocrs_tpu_torch.cli IMAGE --fake-models`` on every PNG of a
directory (``test-data/`` by default), strips whitespace, diffs against
``<name>.expected.txt`` and prints each image's wall time. ``--update``
rewrites the baselines instead.

    python -m ocrs_tpu_torch.tools.test_e2e [DIR] [--update] [--device cpu]

The fake models (``models/fakes.py``) are deterministic, so the tier needs
no trained weights and exercises the CLI's whole surface: image decoding,
preprocessing, detection, layout, recognition, CTC and output. ``--device``
is passed to the CLI (without it the CLI runs on CUDA and fails where there
is none). The JAX tool's ``--real`` tier, the shipped weights against the
reference project's golden images, is not ported: those images are not in
the repository.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def strip_whitespace(text: str) -> str:
    return "".join(text.split())


def run_ocr(image: Path, extra_args: list[str]) -> str:
    result = subprocess.run(
        [sys.executable, "-m", "ocrs_tpu_torch.cli", str(image), "--fake-models", *extra_args],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=900,
    )
    if result.returncode != 0:
        raise RuntimeError(f"CLI failed on {image.name}:\n{result.stderr}")
    return result.stdout


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("test_data", nargs="?", default=str(REPO / "test-data"), help="Directory of test images")
    parser.add_argument("--update", action="store_true", help="Rewrite expected outputs")
    parser.add_argument("--device", default=None, help="the CLI's --device (default: the CLI's, CUDA)")
    args = parser.parse_args(argv)

    test_dir = Path(args.test_data)
    images = sorted(test_dir.glob("*.png"))
    if not images:
        print(f"no test images in {test_dir}", file=sys.stderr)
        return 1
    extra = [] if args.device is None else ["--device", args.device]

    failures = 0
    for image in images:
        expected_path = image.with_suffix("").with_suffix(".expected.txt")
        start = time.time()
        output = run_ocr(image, extra)
        elapsed = time.time() - start
        print(f"{image.name}: {elapsed:.2f}s")

        if args.update:
            expected_path.write_text(output)
            print(f"  updated {expected_path.name}")
            continue

        if not expected_path.exists():
            print(f"  MISSING baseline {expected_path.name}", file=sys.stderr)
            failures += 1
            continue

        expected = expected_path.read_text()
        if strip_whitespace(output) != strip_whitespace(expected):
            print(f"  MISMATCH vs {expected_path.name}", file=sys.stderr)
            print(f"  expected: {expected!r}", file=sys.stderr)
            print(f"  got:      {output!r}", file=sys.stderr)
            failures += 1
        else:
            print("  OK")

    if failures:
        print(f"{failures} failure(s)", file=sys.stderr)
        return 1
    print("all golden tests passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
