#!/usr/bin/env python3
"""The 10-D MDN of BASELINE config 1 trained by the JAX package and by the
PyTorch port on the same inputs, over several weight initialisations.

Run from the root of the repository. On the CPU, both packages (a few
minutes an initialisation on 4 cores, most of it the C2STs):

    JAX_PLATFORMS=cpu python3 scripts/mdn_10d_jax_vs_torch.py --inits 6
    JAX_PLATFORMS=cpu python3 scripts/mdn_10d_jax_vs_torch.py --inits 24 --scored 0

On one GPU, the port alone (it needs no JAX):

    python3 scripts/mdn_10d_jax_vs_torch.py --packages torch --device cuda --inits 8

The inputs are ``chip_smoke.mdn_data(--seed)``, those of chip_smoke.py's
``mdn_linear_gaussian_10d`` phase: 10,000 (theta, x) pairs, three
observations (x_o = 0 and two x drawn from the simulator), and at each
1,000 draws from the analytic posterior and 1,000 from the control (the
posterior with its mean moved by ``MDN_CONTROL_SHIFT_SD`` standard
deviations in every coordinate). Initialisation ``i`` trains
``posterior_nn("mdn", num_components=5, hidden_features=100)`` with batch
200 to patience (at most 200 epochs): in ``sbi_tpu`` seeded with ``i``, in
``sbi_tpu_torch`` with weights and batches from seed ``i``. At each
observation the posterior draws 1,000 samples, held against the analytic
draws by the port's ``c2st_torch`` (a holdout split, as chip_smoke.py
scores) and, where the JAX package runs, by its ``c2st`` (sklearn, 5-fold,
the metric of ``tests/test_linear_gaussian_npe.py``). Only the first
``--scored`` initialisations are sampled and scored; the others report the
epochs and the best validation loss alone (``--inits 0`` scores the control
alone). Prints the card's name and power limit on a GPU, the control's
C2STs, one JSON line per initialisation and package, then each package's
means and standard deviations.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def train_jax(theta, x, observations, init, device, scored):
    import jax
    import jax.numpy as jnp

    from sbi_tpu.inference import NPE
    from sbi_tpu.neural_nets import posterior_nn
    from sbi_tpu.utils import MultivariateNormal
    from sbi_tpu.utils.sbiutils import seed_all_backends

    seed_all_backends(init)
    prior = MultivariateNormal(jnp.zeros(cs.MDN_DIM), covariance_matrix=jnp.eye(cs.MDN_DIM))
    inference = NPE(prior=prior, density_estimator=posterior_nn(
        "mdn", num_components=cs.MDN_COMPONENTS, hidden_features=cs.MDN_HIDDEN))
    t0 = time.perf_counter()
    inference.append_simulations(jnp.asarray(theta), jnp.asarray(x)).train(
        training_batch_size=cs.MDN_BATCH, max_num_epochs=cs.MDN_MAX_EPOCHS)
    seconds = time.perf_counter() - t0
    posterior = inference.build_posterior()
    samples = [np.asarray(posterior.sample((cs.MDN_DRAWS,), x=jnp.asarray(x_o[None]),
                                           key=jax.random.PRNGKey(1000 + init + 10 * i)))
               for i, x_o in enumerate(observations)] if scored else None
    return samples, inference.summary["epochs_trained"][-1], \
        float(inference.summary["best_validation_loss"][-1]), seconds


def train_torch(theta, x, observations, init, device, scored):
    import torch

    from sbi_tpu_torch.inference import NPE
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.utils import MultivariateNormal

    prior = MultivariateNormal(torch.zeros(cs.MDN_DIM, device=device),
                               covariance_matrix=torch.eye(cs.MDN_DIM, device=device),
                               device=device)
    inference = NPE(prior=prior, density_estimator=posterior_nn(
        "mdn", num_components=cs.MDN_COMPONENTS, hidden_features=cs.MDN_HIDDEN, device=device,
        generator=torch.Generator().manual_seed(init)), device=device)
    t0 = time.perf_counter()
    inference.append_simulations(torch.as_tensor(theta, device=device),
                                 torch.as_tensor(x, device=device)).train(
        training_batch_size=cs.MDN_BATCH, max_num_epochs=cs.MDN_MAX_EPOCHS,
        generator=torch.Generator(device=device).manual_seed(init))
    seconds = time.perf_counter() - t0
    posterior = inference.build_posterior()
    g = torch.Generator(device=device).manual_seed(1000 + init)
    samples = [posterior.sample((cs.MDN_DRAWS,), x=torch.as_tensor(x_o[None], device=device),
                                generator=g).cpu().numpy()
               for x_o in observations] if scored else None
    return samples, inference.summary["epochs_trained"][-1], \
        float(inference.summary["best_validation_loss"][-1]), seconds


def scores(samples, refs, seed, device, sklearn):
    """``c2st_torch`` on ``device`` and, if ``sklearn``, the JAX package's
    ``c2st``, of each sample set against its reference draws."""
    import torch

    from sbi_tpu_torch.utils import c2st_torch

    g = torch.Generator(device=device).manual_seed(2000 + seed)
    out = {"c2st_torch": [float(c2st_torch(torch.as_tensor(s, device=device),
                                           torch.as_tensor(r, device=device), generator=g))
                          for s, r in zip(samples, refs)]}
    if sklearn:
        from sbi_tpu.utils.metrics import c2st

        out["c2st_sklearn"] = [float(c2st(s, r)) for s, r in zip(samples, refs)]
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--inits", type=int, default=3)
    parser.add_argument("--first-init", type=int, default=0)
    parser.add_argument("--scored", type=int, default=None,
                        help="initialisations sampled and scored (default: all)")
    parser.add_argument("--packages", default="jax,torch")
    parser.add_argument("--device", default="cpu", help="the port's device")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    packages = args.packages.split(",")
    scored = args.inits if args.scored is None else args.scored
    with_jax = "jax" in packages
    if with_jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import torch

    from sbi_tpu_torch.utils.sbiutils import resolve_device

    device = resolve_device(args.device)  # TF32 off
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    else:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    theta, x, observations, refs, controls, mahalanobis_sq = cs.mdn_data(args.seed)
    print(json.dumps({"observations_mahalanobis_sq": mahalanobis_sq}), flush=True)
    print(json.dumps({"control_mean_shift_sd": cs.MDN_CONTROL_SHIFT_SD,
                      **scores(controls, refs, -1, device, with_jax)}), flush=True)
    fns = {"jax": train_jax, "torch": train_torch}
    rows = {name: [] for name in packages}
    for init in range(args.first_init, args.first_init + args.inits):
        for name in packages:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                samples, epochs, best_val, seconds = fns[name](
                    theta, x, observations, init, device, init < args.first_init + scored)
            row = {"package": name, "init": init, "epochs": epochs, "best_val": best_val,
                   "train_s": seconds}
            if samples is not None:
                row.update(scores(samples, refs, init, device, with_jax))
            rows[name].append(row)
            print(json.dumps(row), flush=True)
    for name, rs in rows.items():
        summary = {"package": name, "inits": len(rs)}
        for key in ("best_val", "epochs", "c2st_torch", "c2st_sklearn"):
            values = np.array([r[key] for r in rs if key in r], np.float64)
            if len(values):
                summary[f"mean_{key}"] = values.mean(0).tolist()
                summary[f"sd_{key}"] = values.std(0, ddof=1).tolist() if len(values) > 1 else None
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
