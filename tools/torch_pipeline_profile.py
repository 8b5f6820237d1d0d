#!/usr/bin/env python3
"""Where the card's time goes in the port's page pipeline, with torch.profiler.

Run from a checkout of the repository on a machine with one NVIDIA GPU:

    python3 tools/torch_pipeline_profile.py [--groups 3] [--transport hbm] [--device-geometry] [--shards 2]

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
is written there.
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


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from ocrs_tpu_torch import DEFAULT_ALPHABET, PagePipeline
    from ocrs_tpu_torch.models.weights import load_detection_model, load_recognition_model
    from ocrs_tpu_torch.ops.connected_components import loop_counts
    from ocrs_tpu_torch.parallel.sharding import make_data_mesh

    parser = argparse.ArgumentParser()
    parser.add_argument("--groups", type=int, default=3)
    parser.add_argument("--transport", default="hbm")
    parser.add_argument("--device-geometry", action="store_true")
    parser.add_argument("--shards", type=int, default=1)
    parser.add_argument("--trace", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_pipeline_profile: no CUDA device", file=sys.stderr)
        return 2

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
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        pipe.process_stream(groups)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
                "pages": args.groups * chip_smoke.GROUP_PAGES,
                "wall_s_under_profiler": wall,
                "pages_per_s_under_profiler": args.groups * chip_smoke.GROUP_PAGES / wall,
                "device_time_s": device_s,
                "device_busy_share_upper_bound": device_s / wall if device_s else None,
                "kernels_and_copies_per_group": sum(r[1] for r in rows) / args.groups,
                "loop_flag_reads_per_group": loop_counts["host_syncs"] / args.groups,
                "top_kernels": [{"ms": r[0] / 1e3, "count": r[1], "name": r[2][:120]} for r in rows[:12]],
                "top_host_ops": [{"ms": r[0] / 1e3, "count": r[1], "name": r[2][:120]} for r in host[:12]],
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
