#!/usr/bin/env python3
"""Where the time goes in sbi_tpu_torch's NSF serving, training and NLE
sampling paths, on one GPU.

Builds the SLCP posterior of ``chip_smoke.py`` (5 coupling transforms,
hidden 50, 10 bins, random weights from ``--seed``), warms it up, then runs
``DirectPosterior.sample((100_000,))`` and ``log_prob`` of those samples
under ``torch.profiler``; then trains SLCP NPE at the same width on 10,000
simulations (batch 200) and profiles one epoch after a warm-up epoch.
Prints one JSON line per call: wall time, device busy time (sum of kernel
times), the device's idle share, the number of kernel launches, the device
time of the heaviest kernels by name and the RQ-spline kernels' share
(forward and backward). The training line adds the host's heaviest
operations by their own CPU time and the number of host syncs in an epoch
(``torch.cuda.set_sync_debug_mode``). Last, SLCP's NLE likelihood at the
same width (random weights) is sampled by ``MCMCPosterior`` with 1,000
slice chains (warmup 10, 5 samples a chain) and profiled the same way; its
line adds the FSM iterations, host syncs, device ops and host time per
iteration. Needs CUDA; run from the repository root:

    python3 scripts/torch_profile_nsf.py
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profile(torch, fn, top=8):
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    launches = 0
    for evt in prof.events():
        # A user annotation (the optimizer's step range) is reported as a
        # device event too, and is no work of its own.
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time_total
            launches += 1
    busy_s = sum(kernels.values()) / 1e6
    spline_s = sum(v for k, v in kernels.items() if "rqs_kernel" in k) / 1e6
    backward_s = sum(v for k, v in kernels.items() if "rqs_backward_kernel" in k) / 1e6
    heaviest = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    return {
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall),
        "device_ops": launches,
        "spline_s": spline_s,
        "spline_share_of_busy": spline_s / busy_s if busy_s else None,
        "spline_backward_s": backward_s,
        "spline_backward_share_of_busy": backward_s / busy_s if busy_s else None,
        "heaviest": [{"name": k[:80], "s": v / 1e6} for k, v in heaviest],
        "host_heaviest": [{"name": e.key[:80], "self_cpu_s": e.self_cpu_time_total / 1e6,
                           "calls": e.count} for e in host],
    }


def host_syncs(torch, fn):
    """Host syncs that ``fn`` makes, as torch's sync debug mode reports them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Profile the NSF serving path on one GPU.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--samples", type=int, default=100_000)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_nsf: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from sbi_tpu_torch.inference.posteriors import DirectPosterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.simulators import get_task, slcp_simulator
    from sbi_tpu_torch.utils.sbiutils import resolve_device

    device = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    task = get_task("slcp", device=device)
    theta = task.prior.sample((10_000,), generator=gen)
    est = posterior_nn("nsf", device=device, generator=torch.Generator().manual_seed(args.seed))(
        theta, slcp_simulator(theta, generator=gen))
    chip_smoke.perturb_heads(torch, est, gen)
    post = DirectPosterior(est, task.prior)
    x_o = slcp_simulator(task.prior.sample((1,), generator=gen), generator=gen)
    post.sample((1000,), x=x_o, generator=gen)  # warm-up
    post.leakage_correction(x_o, generator=gen)

    samples = None

    def sample():
        nonlocal samples
        samples = post.sample((args.samples,), x=x_o, generator=gen)

    def log_prob():
        with torch.no_grad():
            post.log_prob(samples, x=x_o)

    for name, fn in (("sample", sample), ("log_prob", log_prob)):
        fn()  # warm-up of this call's shapes
        print(json.dumps({"call": name, "samples": args.samples, "device": smi, **profile(torch, fn)}),
              flush=True)

    import warnings

    from sbi_tpu_torch.inference import NPE

    inference = NPE(prior=task.prior, density_estimator="nsf")
    inference.append_simulations(theta, slcp_simulator(theta, generator=gen))

    def epoch():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
            inference.train(max_num_epochs=1, resume_training=bool(inference._optimizer),
                            generator=gen)

    epoch()  # warm-up; builds the net
    steps0 = inference._opt_steps
    result = profile(torch, epoch)
    steps = inference._opt_steps - steps0
    syncs = host_syncs(torch, epoch)
    print(json.dumps({"call": "train_epoch", "simulations": theta.shape[0], "batch": 200,
                      "steps": steps, "steps_per_s_profiled": steps / result["wall_s"],
                      "device_ops_per_step": result["device_ops"] / steps,
                      "host_syncs_per_epoch": syncs, "device": smi, **result}), flush=True)

    from sbi_tpu_torch.inference.posteriors import MCMCPosterior
    from sbi_tpu_torch.inference.potentials.likelihood_based_potential import (
        likelihood_estimator_based_potential,
    )
    from sbi_tpu_torch.neural_nets import likelihood_nn
    from sbi_tpu_torch.samplers.mcmc import slice_fsm

    lik = likelihood_nn("nsf", device=device, generator=torch.Generator().manual_seed(args.seed))(
        theta, slcp_simulator(theta, generator=gen))
    chip_smoke.perturb_heads(torch, lik, gen)
    potential, transform = likelihood_estimator_based_potential(lik, task.prior, x_o)
    mcmc = MCMCPosterior(potential, proposal=task.prior, theta_transform=transform)

    def nle_sample():
        mcmc.sample((5_000,), generator=gen, num_chains=1_000, warmup_steps=10)

    nle_sample()  # warm-up
    with chip_smoke.FsmCounts(torch, slice_fsm) as counts:
        result = profile(torch, nle_sample, top=12)
    syncs = host_syncs(torch, nle_sample)
    n = max(counts.iterations, 1)
    print(json.dumps({"call": "nle_slice_sample", "chains": 1_000, "warmup": 10,
                      "samples_per_chain": 5, "fsm_iterations": counts.iterations,
                      "fsm_host_syncs": counts.syncs, "host_syncs": syncs,
                      "device_ops_per_iteration": result["device_ops"] / n,
                      "host_us_per_iteration_profiled": result["wall_s"] / n * 1e6,
                      "device_us_per_iteration": result["device_busy_s"] / n * 1e6,
                      "device": smi, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
