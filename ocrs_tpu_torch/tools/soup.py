"""Average two or more recognition/detection checkpoints ("model soup"):
the port of ``tools/soup.py``.

Uniform (or weighted) parameter averaging of fine-tune parents that share an
init (Wortsman et al., "Model soups", 2022). Each leaf is the float64 sum of
the weighted leaves, in the order the files are given, cast to the first
file's dtype, as the JAX tool computes it; the trees must have the same
structure.

    python -m ocrs_tpu_torch.tools.soup weights/text-recognition.npz weights/cand_r5.npz \\
        -o soup.npz [--w 0.5 0.5]

The output has the first file's metadata plus ``soup_of`` (the files' names)
and ``soup_weights`` (the normalized weights).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def structure(tree):
    """The tree's shape without its leaves: dict keys (sorted, as JAX's
    tree structure sorts them) and list lengths."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("list", tuple(structure(v) for v in tree))
    return None


def tree_map(fn, *trees):
    """`fn` over the trees' leaves, position by position; dicts come back
    with sorted keys, as ``jax.tree_util.tree_map`` returns them."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def soup(trees, ws):
    """The weighted average of `trees` (weights `ws`, already normalized)."""
    return tree_map(
        lambda *leaves: sum(w * np.asarray(leaf, dtype=np.float64) for w, leaf in zip(ws, leaves)).astype(
            np.asarray(leaves[0]).dtype
        ),
        *trees,
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoints", nargs="+", help=".npz weight files")
    parser.add_argument("--w", type=float, nargs="+", default=None, help="per-checkpoint weights (default: uniform)")
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)

    from ..models.weights import load_params, save_params

    trees, metas = [], []
    for ck in args.checkpoints:
        params, meta = load_params(ck)
        trees.append(params)
        metas.append(meta)

    ws = args.w or [1.0 / len(trees)] * len(trees)
    if len(ws) != len(trees):
        parser.error("--w must match the number of checkpoints")
    total = sum(ws)
    ws = [w / total for w in ws]

    ref = structure(trees[0])
    if any(structure(t) != ref for t in trees[1:]):
        parser.error("checkpoints have different parameter structures")

    meta = dict(metas[0])
    meta["soup_of"] = [str(Path(c).name) for c in args.checkpoints]
    meta["soup_weights"] = ws
    save_params(args.output, soup(trees, ws), meta=meta)
    print(f"saved {args.output} (uniform={args.w is None}, weights={ws})")


if __name__ == "__main__":
    main()
