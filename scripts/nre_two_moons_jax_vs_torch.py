#!/usr/bin/env python3
"""two_moons NRE_B trained by the JAX package and by the PyTorch port on
the same inputs, scored by the same metrics: does the port's trained ratio
match the JAX package's?

Run from the root of the repository, on the CPU (both packages; a few
minutes an initialisation on 4 cores):

    JAX_PLATFORMS=cpu python3 scripts/nre_two_moons_jax_vs_torch.py --inits 2

or the port alone on one GPU (it needs no JAX):

    python3 scripts/nre_two_moons_jax_vs_torch.py --packages torch --device cuda --inits 4

The inputs are drawn with numpy from ``--seed``: ``--simulations`` theta
uniform on [-1, 1]^2 and x from the two_moons simulator (the formula of
both packages' ``two_moons_simulator``). Initialisation ``i`` trains
``NRE_B`` (the default ResNet classifier, 10 atoms, batch 200, patience
``--patience``, at most ``--max-epochs``): in ``sbi_tpu`` seeded with
``i``, in ``sbi_tpu_torch`` with weights, batches and atoms from seed
``i``. At each observation of ``tests/mini_sbibm/files/two_moons.npz`` the
trained ratio draws ``--draws`` samples by rejection sampling, the same
numpy code for both packages (``ratio_rejection``: uniform proposals on
the prior box, log M the largest log ratio of 200,000 of them plus log
1.2; no chain initialisation, no ascent), scored against as many
reference draws by the port's
``c2st_torch`` (one holdout split) and, where the JAX package runs, by its
``c2st`` (sklearn, 5-fold). Prints one JSON line per initialisation and
package, then each package's means.
"""

import argparse
import json
import math
import os
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, os.getcwd())


def two_moons_data(seed, n):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-1.0, 1.0, size=(n, 2))
    a = -math.pi / 2 + math.pi * rng.uniform(size=n)
    r = 0.1 + 0.01 * rng.standard_normal(n)
    p = np.stack([r * np.cos(a) + 0.25, r * np.sin(a)], axis=-1)
    shift = np.stack([-np.abs(theta[:, 0] + theta[:, 1]) / math.sqrt(2.0),
                      (-theta[:, 0] + theta[:, 1]) / math.sqrt(2.0)], axis=-1)
    return theta.astype(np.float32), (p + shift).astype(np.float32)


def ratio_rejection(log_ratio, n, seed, batch=200_000):
    """``n`` draws with density proportional to exp(log_ratio) on [-1, 1]^2
    (the prior is uniform there); also the number of proposals whose log
    ratio exceeded log M (0 when M bounds the ratio)."""
    rng = np.random.default_rng(seed)
    log_m = log_ratio(rng.uniform(-1.0, 1.0, (batch, 2))).max() + math.log(1.2)
    out, above = [], 0
    while sum(len(o) for o in out) < n:
        cand = rng.uniform(-1.0, 1.0, (batch, 2))
        lr = log_ratio(cand)
        above += int((lr > log_m).sum())
        out.append(cand[np.log(rng.uniform(size=batch)) < lr - log_m])
    return np.concatenate(out)[:n].astype(np.float32), above


def train_jax(theta, x, observations, init, args):
    import jax
    import jax.numpy as jnp

    from sbi_tpu.inference import NRE_B
    from sbi_tpu.utils import BoxUniform
    from sbi_tpu.utils.sbiutils import seed_all_backends

    seed_all_backends(init)
    prior = BoxUniform(-jnp.ones(2), jnp.ones(2))
    inference = NRE_B(prior=prior)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inference.append_simulations(jnp.asarray(theta), jnp.asarray(x)).train(
            training_batch_size=200, stop_after_epochs=args.patience,
            max_num_epochs=args.max_epochs, key=jax.random.PRNGKey(init))
    train_s = time.perf_counter() - t0
    est = inference._neural_net

    def sampler(x_o, seed):
        def log_ratio(t):
            t = jnp.asarray(t, jnp.float32)
            return np.asarray(est.log_ratio(t, jnp.broadcast_to(jnp.asarray(x_o), t.shape)))

        return ratio_rejection(log_ratio, args.draws, seed)

    return inference.summary, train_s, sampler


def train_torch(theta, x, observations, init, args):
    import torch

    from sbi_tpu_torch.inference import NRE_B
    from sbi_tpu_torch.utils import BoxUniform

    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(init)
    torch.manual_seed(init)  # the classifier's initialisation
    prior = BoxUniform(-torch.ones(2), torch.ones(2), device=device)
    inference = NRE_B(prior=prior, device=device)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inference.append_simulations(torch.tensor(theta), torch.tensor(x)).train(
            training_batch_size=200, stop_after_epochs=args.patience,
            max_num_epochs=args.max_epochs, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    est = inference._neural_net

    def sampler(x_o, seed):
        @torch.no_grad()
        def log_ratio(t):
            t = torch.tensor(t, dtype=torch.float32, device=device)
            xs = torch.tensor(x_o, device=device).expand(t.shape[0], -1)
            return est.log_ratio(t, xs).cpu().numpy()

        return ratio_rejection(log_ratio, args.draws, seed)

    return inference.summary, train_s, sampler


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--packages", nargs="+", default=["jax", "torch"], choices=["jax", "torch"])
    parser.add_argument("--inits", type=int, default=2)
    parser.add_argument("--first-init", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--simulations", type=int, default=30_000)
    parser.add_argument("--patience", type=int, default=20)
    parser.add_argument("--max-epochs", type=int, default=300)
    parser.add_argument("--draws", type=int, default=2_000)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)

    import torch

    from sbi_tpu_torch.utils import c2st_torch

    if args.device == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    with np.load(os.path.join("tests", "mini_sbibm", "files", "two_moons.npz")) as f:
        observations = f["observations"].astype(np.float32)
        references = f["reference_samples"][:, : args.draws].astype(np.float32)
    theta, x = two_moons_data(args.seed, args.simulations)
    trainers = {"jax": train_jax, "torch": train_torch}
    results = {p: [] for p in args.packages}
    for init in range(args.first_init, args.first_init + args.inits):
        for package in args.packages:
            summary, train_s, sampler = trainers[package](theta, x, observations, init, args)
            drawn = [sampler(x_o, 1_000 * init + i) for i, x_o in enumerate(observations)]
            draws = [d for d, _ in drawn]
            gen = torch.Generator().manual_seed(init)
            by_torch = [float(c2st_torch(torch.tensor(d), torch.tensor(r), generator=gen))
                        for d, r in zip(draws, references)]
            row = {"package": package, "init": init, "epochs": summary["epochs_trained"][-1],
                   "train_s": train_s,
                   "best_validation_loss": float(summary["best_validation_loss"][-1]),
                   "c2st_torch": by_torch, "proposals_above_log_m": [a for _, a in drawn]}
            if "jax" in args.packages:
                from sbi_tpu.utils.metrics import c2st

                row["c2st_sklearn"] = [float(c2st(d, r)) for d, r in zip(draws, references)]
            results[package].append(row)
            print(json.dumps(row), flush=True)
    for package, rows in results.items():
        summary = {"package": package, "inits": len(rows),
                   "best_validation_loss": float(np.mean([r["best_validation_loss"] for r in rows]))}
        for metric in ("c2st_torch", "c2st_sklearn"):
            if metric in rows[0]:
                per_obs = np.mean([r[metric] for r in rows], axis=0)
                summary[metric] = per_obs.tolist()
                summary[metric + "_mean"] = float(per_obs.mean())
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
