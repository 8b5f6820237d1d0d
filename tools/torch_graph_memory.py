#!/usr/bin/env python3
"""Where the page pipeline's device memory goes, and what its CUDA graphs
do under the batching service's traffic.

Run from a checkout of the repository on a machine with one NVIDIA GPU:

    python3 tools/torch_graph_memory.py --part pipeline|mesh|a4|mixed [--root DIR] [--passes 3] [--rounds 4] [--clients 8]

``--part pipeline``: config 5's pipeline of ``bench_torch/bench.py`` (the
shipped models, ``PagePipeline(max_lines_per_batch=128)``, the 16 committed
A4 pages at 300 dpi) runs ``--passes`` passes of ``process_stream`` over 6
groups of those pages in seeded orders. ``--part mesh``: the same through
``PagePipeline(mesh=)`` of two shards on the one card (8 pages a shard).
Both print the allocator's figures after the passes:
``memory_reserved``, ``max_memory_reserved`` and ``max_memory_allocated``,
and the snapshot's segments (``torch.cuda.memory_snapshot()``) summed by
memory pool (a graph cache's pool, or the allocator's own) and by the stream
they were allocated on (the calling thread's, a pipeline's copy stream, a
shard's stream, a graph cache's capture stream), reserved bytes and the
bytes of live blocks in them; and the graph caches' counts
(``PagePipeline.graph_stats``).

``--part a4`` and ``--part mixed``: the batching service
(``serve.BatchingOcrService``, ``max_batch=8``, ``max_wait_ms=15``) under
``--clients`` closed-loop client threads, a warm-up round and ``--rounds``
timed rounds of 64 requests each (the same requests every round), on a mix
of decoded pages: ``a4``, the A4 pages at 150 dpi that ``chip_smoke.py``'s
serving phase draws (one page size), or ``mixed``, those pages cut to one
of six sizes from 877 x 620 to 1754 x 1240 drawn for each request from a
seeded generator, so that with few clients the stacks the service pads to
each batch's largest page change shape from batch to batch. It prints requests per second over the timed rounds and each
round's seconds, each request's latency from submit to result (median, 95th
percentile), the batches' sizes and milliseconds, ``memory_reserved`` and
``max_memory_reserved`` after the rounds, and the service pipeline's graph
counts over the timed rounds with the page-stack shapes its recognition
keys have met.

``--root DIR`` imports the package, the benchmark's loaders and
``chip_smoke.py`` from another checkout (a parent unpacked with ``git
archive``), so that one call measures two commits with the same script; a
checkout without graphs reports ``graphs: null``. Prints one JSON object
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GROUPS_PER_PASS = 6
MIXED_SIZES = [(1754, 1240), (1754, 900), (1400, 1240), (1100, 1000), (877, 1240), (877, 620)]


def card() -> str:
    if shutil.which("nvidia-smi") is None:
        return "not measured"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"


def graph_stats(pipe):
    read = getattr(pipe, "graph_stats", None)  # None on a checkout without graphs
    return read() if read else None


def memory_by_pool_and_stream(streams: dict) -> list:
    """The snapshot's segments summed by (pool, stream): `streams` maps a
    stream handle to its name."""
    import torch

    pools = {}
    for s in torch.cuda.memory_snapshot():
        pool = tuple(s.get("segment_pool_id", ())) or None
        key = ("default" if pool in (None, (0, 0)) else f"graph pool {pool}", streams.get(s["stream"], f"stream {s['stream']}"))
        entry = pools.setdefault(key, {"reserved_bytes": 0, "live_bytes": 0, "segments": 0})
        entry["reserved_bytes"] += s["total_size"]
        entry["live_bytes"] += s.get("allocated_size", 0)
        entry["segments"] += 1
    return [{"pool": p, "stream": st, **v} for (p, st), v in sorted(pools.items(), key=lambda kv: -kv[1]["reserved_bytes"])]


def stream_names(pipe) -> dict:
    import torch

    names = {torch.cuda.current_stream().cuda_stream: "caller", 0: "default"}
    shards = pipe._shards or [pipe]
    for i, shard in enumerate(shards):
        tag = "" if pipe._shards is None else f"shard {i} "
        if shard._copy_stream is not None:
            names[shard._copy_stream.cuda_stream] = tag + "copy stream"
        cache = getattr(shard, "_graphs", None)
        if cache is not None and cache._stream is not None:
            names[cache._stream.cuda_stream] = tag + "graph capture stream"
    for i, stream in enumerate(getattr(pipe, "_shard_streams", None) or []):
        if stream is not None:
            names[stream.cuda_stream] = f"shard {i} stream"
    return names


def pipeline_part(args, bench, ot) -> dict:
    import numpy as np
    import torch

    det, rec, alphabet = bench.load_models()
    pages, _ = bench.load_pages()
    kwargs = {}
    if args.part == "mesh":
        from ocrs_tpu_torch.parallel.sharding import make_data_mesh

        kwargs["mesh"] = make_data_mesh(devices=["cuda:0", "cuda:0"])
    pipe = ot.PagePipeline(det, rec, alphabet, max_lines_per_batch=bench.PIPELINE_MAX_LINES, **kwargs)
    rng = np.random.default_rng(0)
    groups = [np.ascontiguousarray(pages[rng.permutation(len(pages))]) for _ in range(GROUPS_PER_PASS)]
    passes = []
    for _ in range(args.passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_stream(groups)
        torch.cuda.synchronize()
        passes.append({"pages_per_sec": len(groups) * len(pages) / (time.perf_counter() - t0),
                       "memory_reserved_bytes": torch.cuda.memory_reserved()})
    return {
        "passes": passes,
        "memory_reserved_bytes": torch.cuda.memory_reserved(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "by_pool_and_stream": memory_by_pool_and_stream(stream_names(pipe)),
        "graphs": graph_stats(pipe),
    }


def service_part(args, ot, chip_smoke) -> dict:
    import numpy as np
    import torch

    from ocrs_tpu_torch.engine import OcrEngine, OcrEngineParams
    from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
    from ocrs_tpu_torch.png import decode_image, encode_png
    from ocrs_tpu_torch.serve import BatchingOcrService

    det = load_detection_model(args.root / "weights" / "text-detection.npz")
    rec = load_recognition_model(args.root / "weights" / "text-recognition.npz")
    engine = OcrEngine(OcrEngineParams(detection_model=det, recognition_model=rec))
    a4 = [
        decode_image(encode_png(chip_smoke.full_page(
            seed, hw=chip_smoke.A4_150_HW, scale=chip_smoke.A4_150_SCALE, pitch=chip_smoke.A4_150_PITCH,
            left=chip_smoke.A4_150_LEFT,
        )[0]))
        for seed in range(8)
    ]
    per_client = 64 // args.clients
    rng = np.random.default_rng(0)
    requests = {}
    for c in range(args.clients):
        for k in range(per_client):
            page = a4[(c + k) % 8]
            if args.part == "mixed":
                h, w = MIXED_SIZES[rng.integers(len(MIXED_SIZES))]
                page = np.ascontiguousarray(page[:h, :w])
            requests[(c, k)] = page
    service = BatchingOcrService(engine, det, rec, ot.DEFAULT_ALPHABET, max_batch=8, max_wait_ms=15.0)
    latencies = []

    def client(c, out):
        for k in range(per_client):
            t0 = time.perf_counter()
            service.submit(requests[(c, k)]).result(timeout=600)
            out.append((time.perf_counter() - t0) * 1e3)

    def one_round():
        out = []
        threads = [threading.Thread(target=client, args=(c, out)) for c in range(args.clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0, out

    one_round()  # warm-up
    service.batch_sizes.clear()
    service.batch_ms.clear()
    before = graph_stats(service._pipeline)
    rounds = []
    for _ in range(args.rounds):
        seconds, out = one_round()
        rounds.append(seconds)
        latencies += out
    after = graph_stats(service._pipeline)
    graphs = None
    if after is not None:
        graphs = {k: after[k] - before[k] for k in ("graph_captures", "graph_replays", "eager_batches")}
        graphs.update({k: after[k] for k in ("graphs", "input_buffer_bytes", "pool_bytes")})
        graphs["stack_shapes_seen"] = sorted(
            {str(key[3]) for key in service._pipeline._graphs._seen if key[0] == "recognize"}
        )
    latencies.sort()
    return {
        "clients": args.clients,
        "requests_per_sec": per_client * args.clients * args.rounds / sum(rounds),
        "round_seconds": rounds,
        "latency_p50_ms": statistics.median(latencies),
        "latency_p95_ms": latencies[int(0.95 * (len(latencies) - 1))],
        "batch_sizes": list(service.batch_sizes),
        "batch_ms": list(service.batch_ms),
        "memory_reserved_bytes": torch.cuda.memory_reserved(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
        "graphs": graphs,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--part", choices=("pipeline", "mesh", "a4", "mixed"), required=True)
    ap.add_argument("--root", type=Path, default=REPO, help="the checkout whose package is measured")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--clients", type=int, default=8)
    args = ap.parse_args()
    args.root = args.root.resolve()
    import torch

    if not torch.cuda.is_available():
        print("torch_graph_memory: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root))
    import chip_smoke
    import ocrs_tpu_torch as ot
    from bench_torch import bench

    report = {"card": card(), "root": str(args.root), "part": args.part, "torch": torch.__version__}
    if args.part in ("a4", "mixed"):
        report["service"] = service_part(args, ot, chip_smoke)
    else:
        report[args.part] = pipeline_part(args, bench, ot)
    print(json.dumps(report), flush=True)
    # The service's worker thread never ends: leave without tearing it down
    # (its interpreter shutdown can abort the process).
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
