#!/usr/bin/env python3
"""Where the card's time goes in the port's page pipeline, with torch.profiler.

Run from a checkout of the repository on a machine with one NVIDIA GPU:

    python3 tools/torch_pipeline_profile.py [--groups 3] [--transport hbm] [--device-geometry] [--shards 2]
        [--trace DIR] [--timeline PATH] [--bench-pages]

It draws the full-size pages of ``chip_smoke.py`` (groups of 16 pages of
3508 x 2480 uint8), runs ``PagePipeline.process_stream`` with the shipped
detector and recognizer over two warm-up groups, then profiles a stream over
``--groups`` groups and prints one JSON object: wall seconds, pages per
second under the profiler, the summed device time of all kernels and copies
(the card's busy share is that over the wall time; both streams are summed,
so it is an upper bound), the kernels launched and the loop flags read from
the card per group, and the twelve kernels that took most of the time.
``--device-geometry`` runs the pipeline with ``run_table_geometry=False``
(labelling and rect fitting on the card, page by page). ``--shards N`` runs
it under ``make_data_mesh(devices=["cuda:0"] * N)``: N shards of each group
on the one card, each on its own thread and stream. The object also lists
the twelve host operations and runtime calls that took most of the host's
time (self time, summed over threads). With ``--trace DIR`` the Chrome trace
is written there. With ``--timeline PATH`` one more stream over the same
groups runs with a ``TimelineRecorder`` (no profiler): its spans and card
intervals are written to PATH as a Chrome trace (one track per host thread,
one per stream; Perfetto opens it), and the object gets ``timeline``, their
``timeline_summary`` by the thread that ran the stream (each shard's under
``--shards``), over every group, or past the stream's first group and
before its last two where there are more than three. ``--bench-pages``
takes the benchmark's 16 committed pages (``bench_torch/data/
pages_a4_p16.npz``, config 5's group) in place of the drawn ones.

``host_launches_per_group`` splits what the host issued to the card under
the profiler, a group, into CUDA graph replays (``cudaGraphLaunch``) and
eager launches and copies (kernel launches, ``cudaMemcpyAsync``,
``cudaMemsetAsync``), each with its count and the host's self ms in those
calls; ``graph_stats`` has the pipeline's graph cache counts over the
profiled stream (``PagePipeline.graph_stats``; None for a checkout
without them).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: The calls that hand the card a kernel, a copy or a graph, as the
#: profiler names them.
GRAPH_LAUNCH = "cudaGraphLaunch"
EAGER_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                  "cudaMemcpyAsync", "cudaMemsetAsync")


def host_launches(events, groups: int) -> dict:
    """Counts and host self ms a group of the launch calls among the
    profiler's `events` (``key_averages()``): graph replays, eager launches
    and copies, and each call."""
    by_call = {e.key: {"count": e.count / groups, "host_ms": e.self_cpu_time_total / 1e3 / groups}
               for e in events if e.key == GRAPH_LAUNCH or e.key in EAGER_LAUNCHES}
    eager = [v for k, v in by_call.items() if k != GRAPH_LAUNCH]
    return {
        "graph": by_call.get(GRAPH_LAUNCH, {"count": 0.0, "host_ms": 0.0}),
        "eager": {"count": sum(v["count"] for v in eager), "host_ms": sum(v["host_ms"] for v in eager)},
        "by_call": by_call,
    }


def write_timeline(path, record) -> None:
    """A recorder's records (``TimelineRecorder.finish()``) as a Chrome
    trace file at `path`."""
    from ocrs_tpu_torch.utils.tracing import chrome_trace

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(chrome_trace(record.spans, record.intervals)))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from ocrs_tpu_torch import DEFAULT_ALPHABET, PagePipeline
    from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
    from ocrs_tpu_torch.ops.connected_components import loop_counts
    from ocrs_tpu_torch.parallel.sharding import make_data_mesh
    from ocrs_tpu_torch.utils.tracing import TimelineRecorder, timeline_summary

    parser = argparse.ArgumentParser()
    parser.add_argument("--groups", type=int, default=3)
    parser.add_argument("--transport", default="hbm")
    parser.add_argument("--device-geometry", action="store_true")
    parser.add_argument("--shards", type=int, default=1)
    parser.add_argument("--trace", default=None)
    parser.add_argument("--timeline", default=None, metavar="PATH")
    parser.add_argument("--bench-pages", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_pipeline_profile: no CUDA device", file=sys.stderr)
        return 2

    if args.bench_pages:
        with np.load(REPO / "bench_torch" / "data" / "pages_a4_p16.npz") as z:
            group = z["pages"]
    else:
        group = np.stack([chip_smoke.full_page(seed)[0] for seed in range(chip_smoke.GROUP_PAGES)])
    groups = [np.roll(group, k, axis=0) for k in range(args.groups)]
    pipe = PagePipeline(
        load_detection_model(REPO / "weights" / "text-detection.npz"),
        load_recognition_model(REPO / "weights" / "text-recognition.npz"),
        DEFAULT_ALPHABET,
        transport=args.transport,
        run_table_geometry=not args.device_geometry,
        mesh=make_data_mesh(devices=["cuda:0"] * args.shards) if args.shards > 1 else None,
    )
    pipe.process_stream(groups[:2])
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    loop_counts.update(iterations=0, host_syncs=0)
    # A checkout from before the graph cache has no counts to read.
    read_graphs = getattr(pipe, "graph_stats", None)
    graphs_before = read_graphs() if read_graphs else None
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        pipe.process_stream(groups)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    graph_stats = None
    if read_graphs:
        graphs_after = read_graphs()
        graph_stats = {k: graphs_after[k] - graphs_before[k] for k in ("graph_captures", "graph_replays", "eager_batches")}
        graph_stats.update({k: graphs_after[k] for k in ("graphs", "input_buffer_bytes", "pool_bytes")})
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / f"pipeline_trace_shards{args.shards}.json"))
    # Rows of the device itself (kernels and copies), not those of the
    # operators that launched them, which carry the same time once more.
    rows = []
    for e in prof.key_averages():
        device_us = getattr(e, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(e, "self_cuda_time_total", 0.0)
        if device_us > 0 and e.device_type != torch.autograd.DeviceType.CPU:
            rows.append((device_us, e.count, e.key))
    rows.sort(reverse=True)
    host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    timeline = None
    if args.timeline:
        recorder = TimelineRecorder("cuda:0")
        pipe.process_stream(groups, recorder=recorder)
        record = recorder.finish()
        write_timeline(args.timeline, record)
        # Under shards each shard's thread runs its own stream.
        mains = [f"ocrs-shard-{i}" for i in range(args.shards)] if args.shards > 1 else [record.main_thread]
        skip = (1, 2) if args.groups > 3 else (0, 0)
        timeline = {
            main: timeline_summary(record.spans, record.intervals, record.counts, main_thread=main,
                                   skip_groups=skip[0], skip_last=skip[1])
            for main in mains
        }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(
        json.dumps(
            {
                "card": smi,
                "transport": args.transport,
                "run_table_geometry": not args.device_geometry,
                "groups": args.groups,
                "shards": args.shards,
                "pages": args.groups * len(group),
                "bench_pages": args.bench_pages,
                "wall_s_under_profiler": wall,
                "pages_per_s_under_profiler": args.groups * len(group) / wall,
                "device_time_s": device_s,
                "device_busy_share_upper_bound": device_s / wall if device_s else None,
                "kernels_and_copies_per_group": sum(r[1] for r in rows) / args.groups,
                "host_launches_per_group": host_launches(prof.key_averages(), args.groups),
                "graph_stats": graph_stats,
                "loop_flag_reads_per_group": loop_counts["host_syncs"] / args.groups,
                "top_kernels": [{"ms": r[0] / 1e3, "count": r[1], "name": r[2][:120]} for r in rows[:12]],
                "top_host_ops": [{"ms": r[0] / 1e3, "count": r[1], "name": r[2][:120]} for r in host[:12]],
                "timeline_file": args.timeline,
                "timeline": timeline,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
