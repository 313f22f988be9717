#!/usr/bin/env python3
"""Smoke test of sbi_tpu_torch on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the RQ-spline CUDA kernel from ``sbi_tpu_torch/csrc/rqs.cu``,
holds it against its plain PyTorch version in both directions (values and
gradients, edge cases included), then drives the NSF serving path through
the port's public entry points: an SLCP posterior at full width (5 coupling
transforms, hidden 50, 10 bins) that answers ``sample``, ``log_prob``,
``sample_batched`` and ``leakage_correction``, and a two_moons posterior
(autoregressive branch). Weights are random, from ``--seed``; each head is
perturbed so the splines are far from the identity. Every phase prints one
JSON line; any failure raises and the script exits non-zero. The kernel
launch counters are zeroed just before the main path and read just after,
and the path fails unless every kernel was launched. The last two lines are
the ``kernels`` summary and ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
REPLACES = "sbi_tpu/ops/rqs_pallas.py:137"
SOURCE = "sbi_tpu_torch/csrc/rqs.cu"
# Tolerances of kernel vs plain version, at spline parameters of std 0.3
# (wider than the main path's conditioners give). Both compute in float32;
# the softmax sums and cumulative knots are summed in another order, so
# knots differ by a few ulp of tail_bound. An input within that distance of
# a knot may fall in the neighbouring bin, which moves y and log|det| only
# by rounding because the spline is C1 across knots.
PARAM_STD = 0.3
Y_ATOL, Y_RTOL, LD_ATOL = 1e-5, 1e-5, 1e-4
# Stress case, parameters of std 1: some bins are ~500x steeper than wide,
# and a knot that moves by one ulp moves y by ~1e-4 in any float32
# implementation. There the kernel is held to the plain version run in
# float64: its error may be at most STRESS_FACTOR times the float32 plain
# version's own error (+ 1e-6).
STRESS_FACTOR = 4.0
# From K = 64 on, bins are 2B/K wide and a knot sums up to K float32 terms,
# so the log-det of two float32 versions differs by more than LD_ATOL
# (2.3e-4 between kernel and plain at K = 64, std 0.3). Those cases are
# held to float64 as the stress case is.
LARGE_K = 64
# Gradients recompute through the plain version in both cases; they differ
# only through the upstream gradient 2*y, which carries y's error.
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
ROUND_TRIP_ATOL = 1e-3  # noise -> data -> noise through 5 spline layers
SAMPLE_LP_ATOL = 1e-3  # single-pass sample_and_log_prob vs log_prob
# Kernel timing sizes, (conditioner rows, transformed dims) at K = 10: one
# 10,000-row proposal batch of two_moons (2) and of SLCP's couplings (3),
# and a 100,000-row log_prob of SLCP.
TIMING_SIZES = ((10_000, 2), (10_000, 3), (100_000, 3))
FLUSH_BYTES = 2 * 50 * 10**6  # twice the 50 MB L2, written before a cold call


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Kernel vs plain version
# ---------------------------------------------------------------------------


def spline_inputs(torch, n, K, device, gen, std=PARAM_STD, strided=True, lead=0, pad=0):
    """x (n,) ~ N(0, 1.5^2), and w, h, d ~ N(0, std^2) as slices of one
    (n, 3K-1 + pad) tensor (as the conditioner hands them to the spline; the
    tensor starts ``lead`` floats into its buffer) or as separate tensors."""
    x = 1.5 * torch.randn(n, generator=gen, device=device)
    if strided:
        P = 3 * K - 1 + pad
        buf = std * torch.randn(lead + n * P, generator=gen, device=device)
        p = buf[lead:].view(n, P)
        return x, p[:, :K], p[:, K:2 * K], p[:, 2 * K:3 * K - 1]
    w = std * torch.randn(n, K, generator=gen, device=device)
    h = std * torch.randn(n, K, generator=gen, device=device)
    d = std * torch.randn(n, K - 1, generator=gen, device=device)
    return x, w, h, d


def compare(torch, rqs, x, w, h, d, inverse, tail_bound=3.0, consts=None):
    consts = consts or (rqs.DEFAULT_MIN_BIN_WIDTH, rqs.DEFAULT_MIN_BIN_HEIGHT,
                        rqs.DEFAULT_MIN_DERIVATIVE)
    with torch.no_grad():
        y, ld = rqs.rational_quadratic_spline(x, w, h, d, inverse, tail_bound, *consts)
        y0, ld0 = rqs.rational_quadratic_spline_plain(x, w, h, d, inverse, tail_bound, *consts)
    torch.cuda.synchronize() if x.is_cuda else None
    err_y = float((y - y0).abs().max()) if x.numel() else 0.0
    err_ld = float((ld - ld0).abs().max()) if x.numel() else 0.0
    ok = bool(torch.allclose(y, y0, atol=Y_ATOL, rtol=Y_RTOL)) and bool(
        torch.allclose(ld, ld0, atol=LD_ATOL, rtol=0.0))
    return ok, err_y, err_ld


def within_float64(torch, rqs, x, w, h, d, inverse, tail_bound=3.0):
    """Kernel and float32 plain version, each against the plain version in
    float64: the kernel's max error in y and in log|det| may be at most
    STRESS_FACTOR times the float32 plain version's own (+ 1e-6)."""
    with torch.no_grad():
        yk, lk = rqs.rational_quadratic_spline(x, w, h, d, inverse, tail_bound)
        yp, lp = rqs.rational_quadratic_spline_plain(x, w, h, d, inverse, tail_bound)
        y64, l64 = rqs.rational_quadratic_spline_plain(
            *(t.double() for t in (x, w, h, d)), inverse, tail_bound)
    errs = {k: float((a.double() - b).abs().max()) for k, a, b in (
        ("kernel_y", yk, y64), ("kernel_ld", lk, l64),
        ("plain_y", yp, y64), ("plain_ld", lp, l64))}
    ok = all(errs[f"kernel_{q}"] <= STRESS_FACTOR * errs[f"plain_{q}"] + 1e-6 for q in ("y", "ld"))
    return ok, errs


def kernel_checks(torch, rqs, device, n_main, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    B = 3.0
    results = []

    def run(name, x, w, h, d, inverse, consts=None):
        ok, ey, eld = compare(torch, rqs, x, w, h, d, inverse, B, consts)
        if w.shape[-1] >= LARGE_K:
            ok, _ = within_float64(torch, rqs, x, w, h, d, inverse, B)
        results.append({"case": name, "inverse": inverse, "n": int(x.numel()),
                        "K": int(w.shape[-1]), "max_abs_err_y": ey,
                        "max_abs_err_ld": eld, "ok": ok})
        check(ok, f"kernel != plain in case {name} (inverse={inverse}): "
                  f"y err {ey}, ld err {eld}")
        # The large-K cases, held to float64, stay out of the summary's
        # max_abs_err, which is against the plain version at Y_ATOL/LD_ATOL.
        return max(ey, eld) if w.shape[-1] < LARGE_K else 0.0

    worst = {False: 0.0, True: 0.0}
    for inverse in (False, True):
        x, w, h, d = spline_inputs(torch, n_main, 10, device, gen)
        worst[inverse] = max(worst[inverse], run("main_strided", x, w, h, d, inverse))
        # (rows, n_trans, 3K-1) as the coupling layer produces it.
        p = PARAM_STD * torch.randn(n_main // 3, 3, 29, generator=gen, device=device)
        xr = 1.5 * torch.randn(n_main // 3, 3, generator=gen, device=device)
        worst[inverse] = max(worst[inverse], run(
            "coupling_layout", xr, p[..., :10], p[..., 10:20], p[..., 20:], inverse))
        # Tile edges: n = 1, and n not a multiple of any tile size, in both
        # tile loads (one row span, and separate tensors).
        for n in (1, 33, 300_001, 1_000_003):
            for strided in (True, False):
                xs, ws, hs, ds = spline_inputs(torch, n, 10, device, gen, strided=strided)
                name = f"n={n}_{'one_span' if strided else 'separate'}"
                worst[inverse] = max(worst[inverse], run(name, xs, ws, hs, ds, inverse))
        # Span bases 1, 2 and 3 floats past a 16-byte boundary.
        for lead in (1, 2, 3):
            xs, ws, hs, ds = spline_inputs(torch, 30_001, 10, device, gen, lead=lead)
            worst[inverse] = max(worst[inverse], run(f"base+{lead}_floats", xs, ws, hs, ds, inverse))
        # Rows padded to 32 floats: equal strides, but not one span.
        xs, ws, hs, ds = spline_inputs(torch, 30_000, 10, device, gen, pad=3)
        worst[inverse] = max(worst[inverse], run("padded_rows", xs, ws, hs, ds, inverse))
        edge = torch.tensor([-B, B, -B - 1e-3, B + 1e-3, -10.0, 10.0, 0.0,
                             -B + 1e-6, B - 1e-6], device=device)
        _, we, he, de = spline_inputs(torch, edge.numel(), 10, device, gen)
        worst[inverse] = max(worst[inverse], run("at_and_beyond_bounds", edge, we, he, de, inverse))
        x4, w4, h4, d4 = spline_inputs(torch, 4099, 4, device, gen)
        worst[inverse] = max(worst[inverse], run(
            "K=4_nondefault_constants", x4, w4, h4, d4, inverse, (1e-2, 5e-3, 1e-2)))
        x10, w10, h10, d10 = spline_inputs(torch, 30_000, 10, device, gen)
        worst[inverse] = max(worst[inverse], run(
            "K=10_nondefault_constants", x10, w10, h10, d10, inverse, (1e-2, 5e-3, 1e-2)))
        # K outside the K = 10 instance: the generic kernel, both tile loads,
        # up to the largest K (the smallest tile).
        for K, n in ((2, 20_000), (4, 20_000), (7, 30_000), (64, 30_000), (rqs.MAX_BINS, 3_000)):
            for strided in (True, False):
                xk, wk, hk, dk = spline_inputs(torch, n, K, device, gen, strided=strided)
                name = f"K={K}_{'one_span' if strided else 'separate'}"
                worst[inverse] = max(worst[inverse], run(name, xk, wk, hk, dk, inverse))
    return results, worst


def stress_check(torch, rqs, device, n, seed):
    """Parameters of std 1: kernel and float32 plain version, each against
    the plain version in float64."""
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    out = {}
    for inverse in (False, True):
        x, w, h, d = spline_inputs(torch, n, 10, device, gen, std=1.0)
        ok, errs = within_float64(torch, rqs, x, w, h, d, inverse)
        check(ok, f"stress (inverse={inverse}): kernel error vs float64 above "
                  f"{STRESS_FACTOR} x the plain version's: {errs}")
        out["inverse" if inverse else "forward"] = errs
    return out


def gradient_check(torch, rqs, device, n, seed):
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = {}
    for inverse in (False, True):
        x, w, h, d = spline_inputs(torch, n, 10, device, gen, strided=False)
        grads = []
        for fn in (rqs.rational_quadratic_spline, rqs.rational_quadratic_spline_plain):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, h, d)]
            y, ld = fn(*leaves, inverse, 3.0)
            ((y**2).sum() + ld.sum()).backward()
            grads.append([t.grad for t in leaves])
        errs = [float((a - b).abs().max()) for a, b in zip(*grads)]
        ok = all(bool(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL))
                 for a, b in zip(*grads))
        check(ok, f"gradients differ (inverse={inverse}): {errs}")
        out["inverse" if inverse else "forward"] = dict(zip(("x", "w", "h", "d"), errs))
    return out


def time_ms(torch, fn, iters=100, warmup=10, before=None):
    """Wall time per call of ``iters`` calls back to back, by CUDA events:
    the host's work per call included wherever it exceeds the device's.
    With ``before`` (an L2 flush), each call is timed by its own pair of
    events and ``before`` runs outside them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if before is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def device_ms(torch, fn, iters=20, warmup=3, before=None, match=None):
    """Device time per call: the summed time of the device operations one
    call launches (torch.profiler), averaged over ``iters`` calls. With
    ``match``, only operations whose name contains it count; ``before``
    (an L2 flush) runs before each call and is not counted then."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):  # a session now and then drops device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and (match is None or match in e.name)]
        # Every call launches the same operations, so a count that is not
        # a multiple of the calls means some were dropped.
        if ops and len(ops) % iters == 0:
            return sum(e.device_time_total for e in ops) / iters / 1e3
    check(False, "the profiler lost device operations in three sessions")


def spline_bound_ms(n, K):
    """Least time for the spline on n elements: bytes (x, 3K-1 params in;
    y, ld out; float32) over HBM bandwidth vs float32 operations (about
    25K+40 per element: softmaxes, cumulative knots, softplus, bin search,
    rational-quadratic evaluation) over the float32 peak."""
    bytes_moved = n * 4 * (1 + (3 * K - 1) + 2)
    ops = n * (25 * K + 40)
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_timings(torch, rqs, device, seed):
    """Kernel times at the main path's sizes (``TIMING_SIZES``, K = 10), warm
    and cold L2, and the plain version at the largest. Cold: a write of
    ``FLUSH_BYTES`` before each call, outside the timed span. The
    n = 300,000 figures also stand under the summary keys ``ms``,
    ``call_ms``, ``plain_ms`` and ``plain_call_ms``, which the kernels line
    reads and which earlier runs recorded."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    flush_buf = torch.empty(FLUSH_BYTES // 4, device=device)
    flush = lambda: flush_buf.fill_(1.0)
    inputs = {}
    for rows, dims in TIMING_SIZES:
        p = PARAM_STD * torch.randn(rows, dims, 29, generator=gen, device=device)
        x = 1.5 * torch.randn(rows, dims, generator=gen, device=device)
        inputs[rows * dims] = (x, p[..., :10], p[..., 10:20], p[..., 20:])
    out = {}
    fwd, inv = rqs.forward_launches, rqs.inverse_launches
    with torch.no_grad():
        for inverse in (False, True):
            t = {"K": 10, "sizes": {}}
            for n, args in inputs.items():
                call = lambda: rqs.rational_quadratic_spline(*args, inverse)
                bound, by = spline_bound_ms(n, 10)
                t["sizes"][str(n)] = {
                    "bound_ms": bound, "bound_by": by,
                    "warm": {"device_ms": device_ms(torch, call, match="rqs"),
                             "time_ms": time_ms(torch, call)},
                    "cold": {"device_ms": device_ms(torch, call, before=flush, match="rqs"),
                             "time_ms": time_ms(torch, call, before=flush)},
                }
            n = max(inputs)
            big, plain = t["sizes"][str(n)], lambda: rqs.rational_quadratic_spline_plain(
                *inputs[n], inverse)
            t.update(n=n, bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                     ms=big["warm"]["device_ms"], call_ms=big["warm"]["time_ms"],
                     plain_ms=device_ms(torch, plain), plain_call_ms=time_ms(torch, plain))
            out[inverse] = t
    # Timing launches are not launches of the main path.
    rqs.forward_launches, rqs.inverse_launches = fwd, inv
    return out


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def count_calls(obj, name):
    """Count calls of ``obj.name`` (one flow pass each) through an instance
    attribute that wraps the method."""
    orig = getattr(obj, name)
    box = [0]

    def wrapped(*args, **kwargs):
        box[0] += 1
        return orig(*args, **kwargs)

    object.__setattr__(obj, name, wrapped)
    return box


def perturb_heads(torch, est, gen, std=0.03):
    """Give every zero-initialised spline head N(0, std^2) weights, so the
    splines are far from the identity while most of the random posterior's
    mass stays inside SLCP's prior box. At std 0.1 almost none of it does
    for some observations, and rejection sampling starves."""
    from sbi_tpu_torch.neural_nets.estimators.flows import MaskedRQSAutoregressive, RQSCoupling

    with torch.no_grad():
        for layer in est.net.layers:
            if isinstance(layer, RQSCoupling):
                head = layer.dense[-1]
            elif isinstance(layer, MaskedRQSAutoregressive):
                head = layer.made.masked[-1]
            else:
                continue
            head.weight.copy_(std * torch.randn(head.weight.shape, generator=gen,
                                                device=head.weight.device))


def flow_checks(torch, est, x_o, gen, n):
    """Round trip noise -> data -> noise, and single-pass
    sample_and_log_prob against log_prob of the same samples."""
    net = est.net
    with torch.no_grad():
        zc = est._embed_condition(x_o)
        z = torch.randn(n, est.input_shape[0], generator=gen, device=x_o.device)
        ctx = zc.repeat(n, 1)
        data, _ = net.inverse(z, ctx)
        h = data
        for layer in net.layers:
            h, _ = layer(h, ctx)
        rt_err = float((h - z).abs().max())
        theta, lp1 = est.sample_and_log_prob_fn(n, x_o, generator=gen)
        lp2 = est.log_prob(theta, x_o)
        lp_err = float((lp1 - lp2).abs().max())
    check(rt_err <= ROUND_TRIP_ATOL, f"round trip error {rt_err}")
    check(lp_err <= SAMPLE_LP_ATOL, f"sample_and_log_prob vs log_prob error {lp_err}")
    return rt_err, lp_err


def sync_time(torch, fn):
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    return out, time.perf_counter() - t0


def slcp_path(torch, rqs, device, seed, num_sims=10_000, num_samples=100_000,
              num_obs=64, batched_samples=256, hidden=50):
    from sbi_tpu_torch.inference.posteriors import DirectPosterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.simulators import get_task, slcp_simulator

    gen = torch.Generator(device=device).manual_seed(seed)
    task = get_task("slcp", device=device)
    theta = task.prior.sample((num_sims,), generator=gen)
    x = slcp_simulator(theta, generator=gen)
    est = posterior_nn("nsf", hidden_features=hidden, device=device,
                       generator=torch.Generator().manual_seed(seed))(theta, x)
    perturb_heads(torch, est, gen)
    n_params = sum(p.numel() for p in est.net.parameters())
    post = DirectPosterior(est, task.prior)
    x_o = slcp_simulator(task.prior.sample((1,), generator=gen), generator=gen)
    xs = slcp_simulator(task.prior.sample((num_obs,), generator=gen), generator=gen)
    inv_passes = count_calls(est.net, "inverse")
    fwd_passes = count_calls(est.net, "log_prob")
    n_spline = sum(1 for l in est.net.layers if type(l).__name__ == "RQSCoupling")

    f0, i0 = rqs.forward_launches, rqs.inverse_launches
    post.sample((1000,), x=x_o, generator=gen)  # warm-up: library handles, allocator
    samples, t_sample = sync_time(torch, lambda: post.sample((num_samples,), x=x_o, generator=gen))
    check(rqs.inverse_launches - i0 == n_spline * inv_passes[0],
          f"sample: {rqs.inverse_launches - i0} inverse launches for {inv_passes[0]} flow passes")
    leak, t_leak = sync_time(torch, lambda: post.leakage_correction(x_o, generator=gen))
    with torch.no_grad():
        lp, t_lp = sync_time(torch, lambda: post.log_prob(samples, x=x_o))
    batched, t_batched = sync_time(torch, lambda: post.sample_batched(
        (batched_samples,), x=xs, generator=gen, starvation_policy="raise"))
    check(rqs.forward_launches - f0 == n_spline * fwd_passes[0],
          f"{rqs.forward_launches - f0} forward launches for {fwd_passes[0]} passes")
    check(rqs.inverse_launches - i0 == n_spline * inv_passes[0],
          f"{rqs.inverse_launches - i0} inverse launches for {inv_passes[0]} passes")

    check(tuple(samples.shape) == (num_samples, 5), f"sample shape {tuple(samples.shape)}")
    check(tuple(batched.shape) == (batched_samples, num_obs, 5), f"batched shape {tuple(batched.shape)}")
    for name, t in (("samples", samples), ("log_prob", lp), ("batched", batched), ("leakage", leak)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(bool(task.prior.within_support(samples).all()), "sample outside the prior")
    check(bool(task.prior.within_support(batched.reshape(-1, 5)).all()), "batched sample outside the prior")
    check(0.0 < float(leak) <= 1.0, f"leakage correction {float(leak)}")
    rt_err, lp_err = flow_checks(torch, est, x_o, gen, min(num_samples, 10_000))
    emit("slcp", params=n_params, num_transforms=n_spline, hidden=hidden,
         samples=num_samples, sample_s=t_sample, samples_per_s=num_samples / t_sample,
         log_prob_s=t_lp, log_probs_per_s=num_samples / t_lp,
         sample_batched_s=t_batched, batched_obs=num_obs, batched_samples=batched_samples,
         leakage_s=t_leak, leakage=float(leak),
         inverse_passes=inv_passes[0], forward_passes=fwd_passes[0],
         round_trip_max_err=rt_err, sample_log_prob_max_err=lp_err)


def two_moons_path(torch, rqs, device, seed, num_sims=10_000, num_samples=10_000, hidden=50):
    from sbi_tpu_torch.inference.posteriors import DirectPosterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.simulators import get_task, two_moons_simulator

    gen = torch.Generator(device=device).manual_seed(seed + 10)
    task = get_task("two_moons", device=device)
    theta = task.prior.sample((num_sims,), generator=gen)
    x = two_moons_simulator(theta, generator=gen)
    est = posterior_nn("nsf", hidden_features=hidden, device=device,
                       generator=torch.Generator().manual_seed(seed + 10))(theta, x)
    perturb_heads(torch, est, gen)
    post = DirectPosterior(est, task.prior)
    x_o = torch.zeros(1, 2, device=device)
    inv_passes = count_calls(est.net, "inverse")
    fwd_passes = count_calls(est.net, "log_prob")
    n_spline = sum(1 for l in est.net.layers if type(l).__name__ == "MaskedRQSAutoregressive")

    f0, i0 = rqs.forward_launches, rqs.inverse_launches
    post.sample((1000,), x=x_o, generator=gen)  # warm-up
    samples, t_sample = sync_time(torch, lambda: post.sample((num_samples,), x=x_o, generator=gen))
    with torch.no_grad():
        lp, t_lp = sync_time(torch, lambda: post.log_prob(samples, x=x_o))
    # Each autoregressive inverse runs dim = 2 sequential spline passes.
    check(rqs.inverse_launches - i0 == 2 * n_spline * inv_passes[0],
          f"{rqs.inverse_launches - i0} inverse launches for {inv_passes[0]} passes")
    check(rqs.forward_launches - f0 == n_spline * fwd_passes[0],
          f"{rqs.forward_launches - f0} forward launches for {fwd_passes[0]} passes")
    check(tuple(samples.shape) == (num_samples, 2), f"sample shape {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()) and bool(torch.isfinite(lp).all()), "non-finite output")
    check(bool(task.prior.within_support(samples).all()), "sample outside the prior")
    rt_err, lp_err = flow_checks(torch, est, x_o, gen, num_samples)
    emit("two_moons", params=sum(p.numel() for p in est.net.parameters()),
         num_transforms=n_spline, samples=num_samples, sample_s=t_sample,
         samples_per_s=num_samples / t_sample, log_prob_s=t_lp,
         log_probs_per_s=num_samples / t_lp, inverse_passes=inv_passes[0],
         forward_passes=fwd_passes[0], round_trip_max_err=rt_err,
         sample_log_prob_max_err=lp_err)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU.", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from sbi_tpu_torch.ops import rqs
        from sbi_tpu_torch.utils.sbiutils import resolve_device
    except ImportError as err:
        print(f"chip_smoke: run it from the repository root ({err}).", file=sys.stderr)
        return 1

    # 1. Environment
    device = resolve_device(None)  # cuda; switches TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda, device=name,
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])

    # 2. Build
    t0 = time.perf_counter()
    lib = rqs.build()
    ptxas = [l.strip() for l in rqs.build_log.splitlines() if "registers" in l or "spill" in l]
    emit("build", seconds=time.perf_counter() - t0, library=os.path.basename(str(lib)), ptxas=ptxas)

    # 3. Kernel vs plain version, both directions
    cases, worst = kernel_checks(torch, rqs, device, 300_000, args.seed)
    grads = gradient_check(torch, rqs, device, 300_000, args.seed)
    stress = stress_check(torch, rqs, device, 300_000, args.seed)
    torch.cuda.synchronize()
    emit("kernel_vs_plain", param_std=PARAM_STD,
         tolerance={"y_atol": Y_ATOL, "y_rtol": Y_RTOL, "ld_atol": LD_ATOL,
                    "grad_atol": GRAD_ATOL, "grad_rtol": GRAD_RTOL,
                    "stress_factor": STRESS_FACTOR},
         cases=cases, gradient_max_abs_err=grads, stress_max_abs_err_vs_float64=stress)

    # 4 + 5. Main path: counts zeroed just before, read just after
    rqs.forward_launches = 0
    rqs.inverse_launches = 0
    slcp_path(torch, rqs, device, args.seed)
    two_moons_path(torch, rqs, device, args.seed)
    launches = {False: rqs.forward_launches, True: rqs.inverse_launches}
    check(launches[False] > 0 and launches[True] > 0, f"main path launches {launches}")

    # 6. Times at the main path's sizes, and the kernels line
    timings = kernel_timings(torch, rqs, device, args.seed)
    emit("kernel_timings", timings={("inverse" if k else "forward"): v for k, v in timings.items()},
         device_ms="device time per call (torch.profiler), the kernel alone",
         time_ms="wall time per call back to back (CUDA events), host work included",
         warm="the working set (35 MB at n = 300,000) stays in the 50 MB L2, as after the conditioner writes it",
         cold=f"{FLUSH_BYTES} bytes written before each call, outside the timed span")
    kernels = []
    for inverse in (False, True):
        t = timings[inverse]
        kernels.append({
            "name": "rqs_spline_" + ("inverse" if inverse else "forward"),
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[inverse], "max_abs_err": worst[inverse],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": f"n={t['n']}, K={t['K']}",
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
