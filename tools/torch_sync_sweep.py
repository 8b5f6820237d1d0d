#!/usr/bin/env python3
"""Where the page pipeline's launch path makes the host wait for the card.

Run from a checkout of the repository on a machine with one NVIDIA GPU:

    python3 tools/torch_sync_sweep.py [--root DIR] [--passes 2] [--seed 0]

It builds config 5's pipeline of ``bench_torch/bench.py`` (the shipped
models, ``PagePipeline(max_lines_per_batch=128)``, the 16 committed pages of
3508 x 2480), warms it with two groups, then takes one steady group through
the steps that ``process_stream`` runs on its threads, one at a time:
``_stage_pages`` (the staging thread), ``_detect_tables`` with the start of
the tables' copy to the host, ``_tables_to_words_arrays`` and
``_layout_group`` (which wait for the tables on purpose), then
``_dispatch_recognition`` and ``_collect_recognition`` (which waits for the
labels on purpose). Each step runs under
``torch.cuda.set_sync_debug_mode("warn")``, so that every operation that
synchronizes the host with the card (a copy from pageable memory, ``.item()``,
``nonzero``, a stream or device synchronization) warns; the warning's Python
stack says where it came from. Prints one JSON object: per step, its host
milliseconds (no fence: what the calling thread spent) and its synchronizing
operations, each as the frames of the stack that lie in the repository,
innermost last; the texts' SHA-256 over the timed passes; and the peak of
``torch.cuda.max_memory_allocated()`` over each of ``--passes`` passes of
``process_stream`` over the 6 groups of config 5 ordered by ``--seed``, with
their pages per second (not the benchmark's figure: no bounds, and the first
pass is the first over these arrays), the peak of
``torch.cuda.max_memory_reserved()`` (which holds the memory pool of the
pipeline's CUDA graphs), and, where the pipeline has them, the graph cache's
captures, replays and eager runs in the pass (``PagePipeline.graph_stats``).

Last, ``launch_queue_depth``: how many small kernels the host can launch
behind a kernel that holds the card for about a second before a launch
blocks (the first launch that takes more than a millisecond on the host),
and how long that launch took: a host that runs further ahead than that
waits inside its launches.

``--root DIR`` imports the package and the benchmark's loaders from another
checkout (a parent unpacked with ``git archive``), so one call can sweep two
commits with the same script.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import inspect
import json
import os
import sys
import time
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GROUPS_PER_PASS = 6


@contextlib.contextmanager
def sync_warnings(root: Path):
    """Warn-mode sync debugging while inside; yields the list that gets each
    synchronizing operation's stack (the frames under `root`, as
    ``path:line function``, innermost last)."""
    import torch

    stacks: list[list[str]] = []
    prev_mode = torch.cuda.get_sync_debug_mode()
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            show(message, category, filename, lineno, file, line)
            return
        frames = traceback.extract_stack()[:-1]
        stacks.append([
            f"{os.path.relpath(f.filename, root)}:{f.lineno} {f.name}"
            for f in frames
            if Path(f.filename).resolve().is_relative_to(root) and not f.filename.endswith("torch_sync_sweep.py")
        ])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield stacks
        finally:
            torch.cuda.set_sync_debug_mode(prev_mode)


def launch_queue_depth(dev, n: int = 8192, block_ms: float = 1.0) -> dict:
    """Launches of ``x.add_(1)`` queued behind ``torch.cuda._sleep`` (about
    a second at 2 GHz) before one blocks for more than `block_ms`."""
    import torch

    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(2_000_000_000)
    took = []
    for _ in range(n):
        t0 = time.perf_counter()
        x.add_(1)
        took.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(dev)
    first = next((i for i, ms in enumerate(took) if ms > block_ms), None)
    return {"launches_before_a_block": first, "blocked_ms": took[first] if first is not None else None, "tried": n}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(REPO), help="checkout whose package is swept")
    parser.add_argument("--passes", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_sync_sweep: no CUDA device", file=sys.stderr)
        return 2
    from bench_torch import bench
    from ocrs_tpu_torch import PagePipeline
    from ocrs_tpu_torch.recognition import _HostCopies

    dev = torch.device("cuda")
    det, rec, alphabet = bench.load_models()
    pages, _ = bench.load_pages()
    pipe = PagePipeline(det, rec, alphabet, max_lines_per_batch=bench.PIPELINE_MAX_LINES, device=dev)
    pipe.process(pages)
    pipe.process_stream([pages] * 2)
    torch.cuda.synchronize()

    steps = {}

    def step(name, fn):
        with sync_warnings(root) as stacks:
            t0 = time.perf_counter()
            out = fn()
            host_ms = (time.perf_counter() - t0) * 1e3
        steps[name] = {"host_ms": host_ms, "syncs": len(stacks), "stacks": stacks}
        return out

    staged = step("stage_pages", lambda: pipe._stage_pages(pages))
    torch.cuda.synchronize()

    # The steps as process_stream runs them: through its graphs, where the
    # root's pipeline has them (`graphs=True`).
    graphs = {"graphs": True} if "graphs" in inspect.signature(pipe._detect_tables).parameters else {}

    def detect():
        # The tables' copy to the host started, as process_stream starts it
        # (a root whose _detect_tables returns the device tables: here).
        tables, scale = pipe._detect_tables(staged, **graphs)
        return (tables if isinstance(tables, _HostCopies) else _HostCopies((tables,))), scale

    copies, scale = step("detect_launch", detect)
    words = step("tables_to_words", lambda: pipe._tables_to_words_arrays(copies, scale))
    lines = step("layout", lambda: pipe._layout_group(*words))
    inflight = step("dispatch_recognition", lambda: pipe._dispatch_recognition(staged, lines, **graphs))
    step("collect_recognition", lambda: pipe._collect_recognition(lines, inflight))
    torch.cuda.synchronize()
    del staged, copies, inflight

    rng = np.random.default_rng(args.seed)
    groups = [np.ascontiguousarray(pages[rng.permutation(len(pages))]) for _ in range(GROUPS_PER_PASS)]
    passes, digest = [], hashlib.sha256()
    read_graphs = getattr(pipe, "graph_stats", None)  # None on a checkout without graphs
    for _ in range(args.passes):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        graphs_before = read_graphs() if read_graphs else None
        t0 = time.perf_counter()
        results = pipe.process_stream(groups)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for group in results:
            for r in group:
                digest.update(r.text.encode() + b"\0")
        graphs = None
        if read_graphs:
            after = read_graphs()
            graphs = {k: after[k] - graphs_before[k] for k in ("graph_captures", "graph_replays", "eager_batches")}
            graphs["pool_bytes"] = after["pool_bytes"]
            graphs["input_buffer_bytes"] = after["input_buffer_bytes"]
        passes.append({
            "pages_per_sec": len(groups) * len(pages) / seconds,
            "max_memory_allocated_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
            "max_memory_reserved_mib": torch.cuda.max_memory_reserved(dev) / 2**20,
            "graphs": graphs,
        })

    queue = launch_queue_depth(dev)
    smi = bench.card_line()
    print(smi, flush=True)
    print(json.dumps({
        "root": os.path.relpath(root, REPO),
        "card": smi,
        "steps": steps,
        "launch_path_syncs": steps["detect_launch"]["syncs"] + steps["dispatch_recognition"]["syncs"],
        "passes": passes,
        "texts_sha256": digest.hexdigest(),
        "launch_queue_depth": queue,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
