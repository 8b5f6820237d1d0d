"""The committed training caches (test-data/train/), which the trainer reads
on a machine without Pillow, are what the renderers make: the port's
trainer remakes each file byte for byte with the commands of README.md, and
the JAX package's datasets, rendered from the same seeds, hold the same
arrays and texts. A renderer that drifts, in either package, fails here."""

from pathlib import Path

import numpy as np
import pytest

from ocrs_tpu.train import data as J
from ocrs_tpu_torch.train import train_models

REPO = Path(__file__).resolve().parent.parent
CACHES = REPO / "test-data" / "train"

# (file, CLI arguments of the port's trainer that render it)
COMMITTED = {
    "rec_64_768_s0.npz": ["recognition", "--samples", "64", "--width", "768", "--data-seed", "0"],
    "rec_32_768_s7919.npz": ["recognition", "--samples", "32", "--width", "768", "--data-seed", "7919"],
    "det_8_s0.npz": ["detection", "--samples", "8", "--data-seed", "0"],
}


@pytest.mark.parametrize("name", list(COMMITTED))
def test_committed_cache_is_remade_by_both_renderers(name, tmp_path):
    committed = CACHES / name
    remade = tmp_path / name
    args = COMMITTED[name]
    record = train_models.main([*args, "--render-only", "--cache", str(remade), "-o", str(tmp_path / "unused.npz")])
    assert record["cache"] == str(remade) and not (tmp_path / "unused.npz").exists()
    assert remade.read_bytes() == committed.read_bytes()

    # The JAX package's dataset from the same seed holds the same arrays.
    samples, seed = int(args[args.index("--samples") + 1]), int(args[args.index("--data-seed") + 1])
    with np.load(committed, allow_pickle=True) as data:
        stored = {k: data[k] for k in data.files}
    if args[0] == "recognition":
        ds = J.RecognitionDataset(samples, width=768, seed=seed)
        np.testing.assert_array_equal(ds._flat, stored["flat"])
        np.testing.assert_array_equal(ds._offsets, stored["offsets"])
        np.testing.assert_array_equal(ds._widths, stored["widths"])
        assert ds._texts == list(stored["texts"])
    else:
        ds = J.DetectionDataset(samples, page_hw=(800, 608), seed=seed)
        np.testing.assert_array_equal(ds._images, stored["images"])
        np.testing.assert_array_equal(ds._masks_packed, stored["masks"])
