#!/usr/bin/env python3
"""Time the RQ-spline CUDA kernel of one checkout of sbi_tpu_torch on one GPU.

Runs ``chip_smoke.kernel_timings`` (device time and back-to-back call time
at n = 20,000, 30,000 and 300,000, K = 10, warm and cold L2, both
directions), the wrapper's host time per call at n = 20,000, and two
PyTorch yardsticks on the ``sbi_tpu_torch`` found under ``--root``, and
prints one JSON line with the card's name and power limit. To compare two versions of
the kernel, run it on both checkouts on one card, in turns:

    python3 scripts/torch_rqs_bench.py --root /path/to/parent --label parent
    python3 scripts/torch_rqs_bench.py --label change

Timing helpers always come from the ``chip_smoke.py`` beside this script,
so both versions are timed by the same code. ``--once`` instead launches
the kernel once per size and direction and times nothing, as a target for
a hardware profiler (``ncu -k regex:rqs ...``). Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(torch, rqs, device, smoke, reps=7, calls=200):
    """Host time per call of the wrapper (no_grad, n = 20,000, K = 10), in µs:
    the least and the median over ``reps`` runs of ``calls`` calls enqueued
    back to back. The device finishes each call in a few µs, so the host's
    own work per call sets the pace (a call of a sampling batch)."""
    gen = torch.Generator(device=device).manual_seed(7)
    p = smoke.PARAM_STD * torch.randn(10_000, 2, 29, generator=gen, device=device)
    x = 1.5 * torch.randn(10_000, 2, generator=gen, device=device)
    out = {}
    with torch.no_grad():
        for inverse in (False, True):
            call = lambda: rqs.rational_quadratic_spline(x, p[..., :10], p[..., 10:20], p[..., 20:], inverse)
            for _ in range(20):
                call()
            runs = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    call()
                runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
            out["inverse" if inverse else "forward"] = {"min_us": min(runs),
                                                        "median_us": statistics.median(runs)}
    return out


def yardsticks(torch, smoke, device):
    """Device ms of two PyTorch calls beside the kernel, at each size: a
    one-element fill (the least device time of any launch) and a sum over
    the same (rows, dims, 3K-1) parameter tensor (a read of the kernel's
    input bytes at the rate a library reduction reaches), warm and cold."""
    flush_buf = torch.empty(smoke.FLUSH_BYTES // 4, device=device)
    flush = lambda: flush_buf.fill_(1.0)
    one = torch.empty(1, device=device)
    out = {"fill_1_element_ms": smoke.device_ms(torch, lambda: one.fill_(1.0))}
    for rows, dims in smoke.TIMING_SIZES:
        p = torch.randn(rows, dims, 29, device=device)
        out[f"sum_params_{rows * dims}"] = {
            "warm_ms": smoke.device_ms(torch, p.sum),
            "cold_ms": smoke.device_ms(torch, p.sum, before=flush, match="reduce"),
        }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Time the RQ-spline kernel of one checkout.")
    parser.add_argument("--root", default=ROOT, help="checkout whose sbi_tpu_torch is timed")
    parser.add_argument("--label", default="change")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--once", action="store_true", help="one launch per size and direction")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_rqs_bench: needs a GPU", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from sbi_tpu_torch.ops import rqs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    rqs.build()
    if args.once:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        for rows, dims in smoke.TIMING_SIZES:
            p = smoke.PARAM_STD * torch.randn(rows, dims, 29, generator=gen, device=device)
            x = 1.5 * torch.randn(rows, dims, generator=gen, device=device)
            for inverse in (False, True):
                rqs.rational_quadratic_spline(x, p[..., :10], p[..., 10:20], p[..., 20:], inverse)
        torch.cuda.synchronize()
        return 0
    timings = smoke.kernel_timings(torch, rqs, device, args.seed)
    print(json.dumps({"label": args.label, "root": os.path.abspath(args.root), "device": smi,
                      "timings": {("inverse" if k else "forward"): v for k, v in timings.items()},
                      "host_us_per_call_n20000": host_us(torch, rqs, device, smoke),
                      "yardsticks": yardsticks(torch, smoke, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
