#!/usr/bin/env python3
"""two_moons NRE_B at the round-2 recipe on the port, at several stopping
patiences and with several ways to sample: how far the patience cut and
the chains' initialisation move the C2ST.

The recipe (scripts/bm_round2.py:377-380): 30,000 simulations, the default
ResNet classifier, 10 atoms, batch 200, patience 150; observations 0-2 of
tests/mini_sbibm/files/two_moons.npz sampled by 200 slice chains (warmup
300, thin 3), 2,000 draws each, scored by c2st_torch against as many
reference draws. The samplers (``--samplers``): ``batched``, one
``sample_batched`` run for the three observations (its chains start from
1,024 shared prior candidates resampled per observation, as the JAX
package's); ``batched10k``, the same from 10,000 candidates; ``sample``,
one ``sample`` run per observation (chains resampled from 10,000
candidates, as the recipe sampled); ``rejection``, exact draws of
``sample_with="rejection"``, which no chain initialisation affects. Each
run prints one JSON line: the
patience, the seed, the epochs trained, the training seconds, the
validation losses and each sampler's C2STs. Run it on the card from the
repository root:

    python3 scripts/nre_two_moons_patience.py --patience 20 50 150 --seeds 0 1

(``--device cpu`` runs on the CPU, slowly.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--patience", type=int, nargs="+", default=[20, 50, 150])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--max-epochs", type=int, default=300)
    parser.add_argument("--simulations", type=int, default=30_000)
    parser.add_argument("--samplers", nargs="+", default=["batched"],
                        choices=["batched", "batched10k", "sample", "rejection"])
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from sbi_tpu_torch.inference import NRE_B, simulate_for_sbi
    from sbi_tpu_torch.simulators import get_task
    from sbi_tpu_torch.utils import c2st_torch
    from sbi_tpu_torch.utils.sbiutils import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    with np.load(os.path.join(ROOT, "tests", "mini_sbibm", "files", "two_moons.npz")) as f:
        xs = torch.as_tensor(f["observations"], device=device)
        refs = torch.as_tensor(f["reference_samples"][:, :2_000], device=device)
    task = get_task("two_moons", device=device)
    for seed in args.seeds:
        data_gen = torch.Generator(device=device).manual_seed(seed)
        theta, x = simulate_for_sbi(task.simulator, task.prior, args.simulations, generator=data_gen)
        for patience in args.patience:
            gen = torch.Generator(device=device).manual_seed(1_000 + seed)
            torch.manual_seed(seed)  # the classifier's initialisation
            inference = NRE_B(prior=task.prior, device=device)
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                inference.append_simulations(theta, x).train(
                    training_batch_size=200, stop_after_epochs=patience,
                    max_num_epochs=args.max_epochs, generator=gen)
            if device.type == "cuda":
                torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            posterior = inference.build_posterior(
                mcmc_parameters=dict(num_chains=200, warmup_steps=300, thin=3))
            rejection = inference.build_posterior(sample_with="rejection")
            scores = {}
            for sampler in args.samplers:
                if sampler in ("sample", "rejection"):
                    post = posterior if sampler == "sample" else rejection
                    draws = torch.stack([post.sample((2_000,), x=x_o, generator=gen)
                                         for x_o in xs], dim=1)
                else:
                    draws = posterior.sample_batched(
                        (2_000,), x=xs, generator=gen, num_chains=200,
                        num_init_candidates=10_000 if sampler == "batched10k" else 1_024)
                scores[sampler] = [float(c2st_torch(draws[:, i], refs[i], generator=gen))
                                   for i in range(len(xs))]
            summary = inference.summary
            print(json.dumps({
                "seed": seed, "patience": patience, "epochs": summary["epochs_trained"][-1],
                "max_epochs": args.max_epochs, "train_s": train_s,
                "steps_per_s": inference._opt_steps / train_s,
                "best_validation_loss": summary["best_validation_loss"][-1],
                "validation_loss": summary["validation_loss"], "c2st": scores,
                "c2st_mean": {k: sum(v) / len(v) for k, v in scores.items()},
                "device": str(device),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
