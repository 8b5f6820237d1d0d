#!/usr/bin/env python3
"""Where a step of the port's GRU sequence kernel spends its clocks.

Runs one bidirectional launch at the recognizer's largest shape, for the
kernel (mode 0) and its two timing-only variants, and prints for each: its
time (median of 20 launches between CUDA events, on the kernel as the port
builds it), its largest difference from the plain version (mode 0), and the
clocks per step of each phase, from a second build of
``ocrs_tpu_torch/csrc/gru_seq.cu`` with ``-DOCRS_GRU_PROFILE`` (thread 0 of
block 0 adds up ``clock64()`` differences per phase of a step). Further
``-D...`` arguments go to both builds, to time a variant of the source kept
behind a flag. Needs one CUDA device and ``nvcc``:

    python3 tools/torch_gru_profile.py [T N H] [-DFLAG ...]

The clocks are those of one thread, with the cost of reading the clock in
them; the phases of other warps overlap. Read them as shares, and take the
kernel's time from ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PHASES = ("wait_for_h", "product", "block_barrier", "partials_gates", "proxy_fence", "barrier_copies", "out_and_next_x")


def main() -> int:
    import torch

    from ocrs_tpu_torch import cuda_build
    from ocrs_tpu_torch.ops import gru

    if not torch.cuda.is_available():
        print("torch_gru_profile: no CUDA device", file=sys.stderr)
        return 2
    flags = tuple(v for v in sys.argv[1:] if v.startswith("-D"))
    sizes = [int(v) for v in sys.argv[1:] if not v.startswith("-D")]
    t_len, n, hidden = sizes if len(sizes) == 3 else (608, 20, 192)
    g = torch.Generator(device="cuda").manual_seed(0)
    xps = [torch.randn(n, t_len, 3 * hidden, device="cuda", generator=g).transpose(0, 1) for _ in range(2)]
    rec = []
    for _ in range(2):
        rec.append(torch.randn(hidden, 3 * hidden, device="cuda", generator=g) * (2.0 / hidden) ** 0.5)
        rec.append(torch.randn(3 * hidden, device="cuda", generator=g) * 0.1)

    def event_ms(fn, reps=20):
        times = []
        for i in range(reps + 3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times[3:])

    # The wrapper launches whatever library cuda_build.load hands it.
    cuda_build._loaded[("gru_seq", ())] = cuda_build.load("gru_seq", flags)
    torch.backends.cuda.matmul.allow_tf32 = False
    err = float((gru.bigru_sequence(*xps, *rec) - gru.bigru_sequence_reference(*xps, *rec)).abs().max())
    ms = [event_ms(lambda: gru.bigru_sequence(*xps, *rec, timing_mode=mode)) for mode in (0, 1, 2)]
    lib = cuda_build.load("gru_seq", (*flags, "-DOCRS_GRU_PROFILE"))
    cuda_build._loaded[("gru_seq", ())] = lib
    lib.ocrs_gru_seq_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for mode in (0, 1, 2):
        gru.bigru_sequence(*xps, *rec, timing_mode=mode)  # warm-up
        torch.cuda.synchronize()
        lib.ocrs_gru_seq_profile(None, 1)
        gru.bigru_sequence(*xps, *rec, timing_mode=mode)
        torch.cuda.synchronize()
        sums = (ctypes.c_longlong * 8)()
        lib.ocrs_gru_seq_profile(sums, 0)
        per_step = {name: sums[i] / t_len for i, name in enumerate(PHASES)}
        print(json.dumps({
            "card": card, "flags": flags, "shape": {"T": t_len, "N": n, "H": hidden}, "timing_mode": mode,
            "ms": ms[mode], "max_abs_err_vs_plain": err if mode == 0 else None,
            "clocks_per_step": per_step, "total": sum(per_step.values()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
