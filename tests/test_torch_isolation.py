"""sbi_tpu_torch stands alone: it imports no JAX and nothing of sbi_tpu, and
its entry points run on the GPU unless told otherwise, never falling back
to the CPU quietly."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sbi_tpu")


def _port_files():
    files = sorted((ROOT / "sbi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_sbi_tpu_imports():
    offenders = [
        (str(f.relative_to(ROOT)), mod)
        for f in _port_files()
        for mod in _imported_roots(f)
        if mod in FORBIDDEN
    ]
    assert offenders == []


def _run(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_out():
    code = (
        "import sys, sbi_tpu_torch\n"
        "import sbi_tpu_torch.inference, sbi_tpu_torch.neural_nets, "
        "sbi_tpu_torch.simulators, sbi_tpu_torch.utils.params_bridge, "
        "sbi_tpu_torch.samplers.mcmc, sbi_tpu_torch.inference.trainers.nle.nle_a, "
        "sbi_tpu_torch.inference.posteriors.ensemble_posterior, "
        "sbi_tpu_torch.simulators.linear_gaussian, "
        "sbi_tpu_torch.neural_nets.estimators.mdn, sbi_tpu_torch.neural_nets.net_builders.mdn, "
        "sbi_tpu_torch.inference.trainers.npe.npe_a, sbi_tpu_torch.inference.trainers.npe.npe_b, "
        "sbi_tpu_torch.inference.posteriors.npe_a_posterior, "
        "sbi_tpu_torch.inference.posteriors.posterior_parameters, "
        "sbi_tpu_torch.samplers.mcmc.hmc, sbi_tpu_torch.samplers.vi, "
        "sbi_tpu_torch.samplers.vi.vi_divergence_optimizers, "
        "sbi_tpu_torch.samplers.vi.vi_quality_control, "
        "sbi_tpu_torch.inference.posteriors.vi_posterior, "
        "sbi_tpu_torch.inference.posteriors.filtered_direct_posterior\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'sbi_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda():
    """device=None means cuda: without CUDA it raises instead of running on
    the CPU; device='cpu' runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.neural_nets.net_builders.flow import build_nsf
    from sbi_tpu_torch.simulators import get_task
    from sbi_tpu_torch.utils import BoxUniform

    theta = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    x = theta + 0.1
    with pytest.raises(RuntimeError, match="CUDA"):
        build_nsf(theta, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        posterior_nn("nsf")(theta, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        BoxUniform(-np.ones(3), np.ones(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        get_task("slcp")
    est = build_nsf(theta, x, hidden_features=8, num_transforms=1, device="cpu")
    assert est.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        posterior_nn("mdn")(theta, x)
    with pytest.raises(NotImplementedError, match="later slice"):
        posterior_nn("made")(theta, x)

    # Training: the trainer, a builder made without a device, the simulation
    # helper and infer() raise without CUDA; with device="cpu" they run.
    from sbi_tpu_torch.inference import NPE, infer, simulate_for_sbi
    from sbi_tpu_torch.simulators import two_moons_simulator

    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    theta2 = theta[:, :2]
    with pytest.raises(RuntimeError, match="CUDA"):
        NPE(prior=prior)
    with pytest.raises(RuntimeError, match="CUDA"):
        NPE(prior=prior, density_estimator=posterior_nn("nsf"), device="cpu").append_simulations(
            theta2, x[:, :2]).train(max_num_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_for_sbi(two_moons_simulator, get_task("two_moons").prior, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer(two_moons_simulator, prior, "NPE", 50)
    small = posterior_nn("nsf", hidden_features=8, num_transforms=1, device="cpu")
    trainer = NPE(prior=prior, density_estimator=small, device="cpu")
    theta_s, x_s = simulate_for_sbi(two_moons_simulator, prior, 50)
    assert theta_s.device == x_s.device == torch.device("cpu")
    trainer.append_simulations(theta_s, x_s).train(max_num_epochs=1)
    assert trainer._neural_net.device == torch.device("cpu")
    posterior = infer(two_moons_simulator, prior, "NPE", 50,
                      init_kwargs=dict(device="cpu", density_estimator=small),
                      train_kwargs=dict(max_num_epochs=1))
    assert posterior.sample((5,), x=np.zeros(2, np.float32)).shape == (5, 2)


def test_nle_and_mcmc_default_to_cuda():
    """NLE, MCMCPosterior (over a potential that names no device, with
    every method), VIPosterior and infer(..., "NLE") raise without CUDA;
    with device="cpu" they run."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from sbi_tpu_torch.inference import NLE, MCMCPosterior, VIPosterior, infer
    from sbi_tpu_torch.neural_nets import likelihood_nn
    from sbi_tpu_torch.simulators import two_moons_simulator
    from sbi_tpu_torch.utils import BoxUniform

    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")

    def potential(theta):
        return prior.log_prob(theta)

    with pytest.raises(RuntimeError, match="CUDA"):
        NLE(prior=prior)
    with pytest.raises(RuntimeError, match="CUDA"):
        NLE(prior=prior, density_estimator=likelihood_nn("nsf"), device="cpu").append_simulations(
            np.zeros((20, 2), np.float32), np.zeros((20, 2), np.float32)).train(max_num_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        MCMCPosterior(potential, proposal=prior)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer(two_moons_simulator, prior, "NLE", 50)
    for method in ("hmc", "nuts"):
        with pytest.raises(RuntimeError, match="CUDA"):
            MCMCPosterior(potential, proposal=prior, method=method)
    with pytest.raises(RuntimeError, match="CUDA"):
        VIPosterior(potential, prior=prior)
    for method in ("slice_np_vectorized", "hmc", "nuts"):
        samples = MCMCPosterior(potential, proposal=prior, num_chains=4, warmup_steps=5,
                                method=method, device="cpu").sample((8,))
        assert samples.shape == (8, 2) and samples.device == torch.device("cpu")
    small = likelihood_nn("nsf", hidden_features=8, num_transforms=1, device="cpu")
    trainer = NLE(prior=prior, density_estimator=small, device="cpu")
    theta = prior.sample((50,))
    trainer.append_simulations(theta, two_moons_simulator(theta)).train(max_num_epochs=1)
    assert trainer._neural_net.device == torch.device("cpu")
    posterior = trainer.build_posterior(mcmc_parameters=dict(num_chains=4, warmup_steps=5))
    assert posterior.sample((8,), x=np.zeros(2, np.float32)).shape == (8, 2)


def test_ensembles_default_to_cuda():
    """The gaussian_linear task raises without CUDA; with device="cpu" an
    ensemble trains, and its posterior samples, on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from sbi_tpu_torch.inference import NPE, EnsemblePosterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.simulators import get_task

    with pytest.raises(RuntimeError, match="CUDA"):
        get_task("gaussian_linear")
    task = get_task("gaussian_linear", device="cpu")
    theta = task.prior.sample((60,))
    small = posterior_nn("nsf", hidden_features=8, num_transforms=1, interleave_affine=True,
                         device="cpu")
    trainer = NPE(prior=task.prior, density_estimator=small, device="cpu")
    members = trainer.append_simulations(theta, task.simulator(theta)).train_ensemble(
        num_members=2, max_num_epochs=1)
    assert all(m.device == torch.device("cpu") for m in members)
    posterior = trainer.build_ensemble_posterior()
    assert isinstance(posterior, EnsemblePosterior)
    assert posterior.sample((5,), x=np.zeros(10, np.float32)).shape == (5, 10)


def test_mdn_family_defaults_to_cuda():
    """posterior_nn("mdn"), NPE_A and NPE_B raise without CUDA; with
    device="cpu" they train, and their posteriors sample, on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from sbi_tpu_torch.inference import NPE_A, NPE_B, DirectPosterior, NPE_A_Posterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.utils import BoxUniform

    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    theta = prior.sample((60,))
    x = theta + 0.1
    with pytest.raises(RuntimeError, match="CUDA"):
        posterior_nn("mdn")(theta, x)
    for cls in (NPE_A, NPE_B):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(prior=prior)
    small = posterior_nn("mdn", hidden_features=8, num_components=2, device="cpu")
    for trainer, posterior_type in ((NPE_A(prior=prior, device="cpu"), NPE_A_Posterior),
                                    (NPE_B(prior=prior, density_estimator=small, device="cpu"),
                                     DirectPosterior)):
        trainer.append_simulations(theta, x).train(max_num_epochs=1)
        assert trainer._neural_net.device == torch.device("cpu")
        posterior = trainer.build_posterior()
        assert isinstance(posterior, posterior_type)
        assert posterior.sample((5,), x=np.zeros(2, np.float32)).shape == (5, 2)


def test_vector_field_modules_leave_jax_out():
    code = (
        "import sys\n"
        "import sbi_tpu_torch.neural_nets.embedding_nets, "
        "sbi_tpu_torch.neural_nets.estimators.score_estimator, "
        "sbi_tpu_torch.neural_nets.estimators.flowmatching_estimator, "
        "sbi_tpu_torch.neural_nets.net_builders.vector_field_nets, "
        "sbi_tpu_torch.inference.trainers.vfpe.fmpe, sbi_tpu_torch.inference.trainers.vfpe.npse, "
        "sbi_tpu_torch.samplers.ode, sbi_tpu_torch.samplers.score, "
        "sbi_tpu_torch.inference.potentials.vector_field_potential, "
        "sbi_tpu_torch.inference.posteriors.vector_field_posterior\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'sbi_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_vector_fields_default_to_cuda():
    """FMPE, NPSE and the vector-field builders raise without CUDA; with
    device="cpu" they train, and their posteriors sample, on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from sbi_tpu_torch.inference import FMPE, NPSE, VectorFieldPosterior, infer
    from sbi_tpu_torch.neural_nets import posterior_flow_nn, posterior_score_nn
    from sbi_tpu_torch.simulators import two_moons_simulator
    from sbi_tpu_torch.utils import BoxUniform

    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    theta = prior.sample((60,))
    x = theta + 0.1
    for builder in (posterior_flow_nn(), posterior_score_nn()):
        with pytest.raises(RuntimeError, match="CUDA"):
            builder(theta, x)
    for cls in (FMPE, NPSE):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(prior=prior)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer(two_moons_simulator, prior, "NPSE", 50)
    for trainer in (FMPE(prior=prior, device="cpu"), NPSE(prior=prior, sde_type="vp", device="cpu")):
        trainer.append_simulations(theta, x).train(max_num_epochs=1)
        assert trainer._neural_net.device == torch.device("cpu")
        posterior = trainer.build_posterior()
        assert isinstance(posterior, VectorFieldPosterior)
        assert posterior.sample((5,), x=np.zeros(2, np.float32), steps=10).shape == (5, 2)


def test_nre_modules_leave_jax_out():
    code = (
        "import sys\n"
        "import sbi_tpu_torch.neural_nets.estimators.ratio_estimators, "
        "sbi_tpu_torch.neural_nets.net_builders.classifier, "
        "sbi_tpu_torch.inference.trainers.nre.nre_a, sbi_tpu_torch.inference.trainers.nre.nre_b, "
        "sbi_tpu_torch.inference.trainers.nre.nre_c, sbi_tpu_torch.inference.trainers.nre.bnre, "
        "sbi_tpu_torch.inference.potentials.ratio_based_potential, "
        "sbi_tpu_torch.inference.posteriors.rejection_posterior, "
        "sbi_tpu_torch.inference.posteriors.importance_posterior, "
        "sbi_tpu_torch.samplers.rejection, sbi_tpu_torch.samplers.importance\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'sbi_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_nre_and_its_posteriors_default_to_cuda():
    """The NRE trainers, classifier_nn's builders and the rejection and
    importance posteriors (over a potential that names no device) raise
    without CUDA; with device="cpu" they train and sample on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from sbi_tpu_torch.inference import (
        BNRE,
        NRE_A,
        NRE_B,
        NRE_C,
        ImportanceSamplingPosterior,
        RejectionPosterior,
        infer,
    )
    from sbi_tpu_torch.neural_nets import classifier_nn
    from sbi_tpu_torch.simulators import two_moons_simulator
    from sbi_tpu_torch.utils import BoxUniform

    prior = BoxUniform(-np.ones(2), np.ones(2), device="cpu")
    theta = prior.sample((60,))
    x = two_moons_simulator(theta)

    def potential(t):
        return prior.log_prob(t)

    for model in ("linear", "mlp", "resnet"):
        with pytest.raises(RuntimeError, match="CUDA"):
            classifier_nn(model)(theta, x)
    for cls in (NRE_A, NRE_B, NRE_C, BNRE):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(prior=prior)
    for cls in (RejectionPosterior, ImportanceSamplingPosterior):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(potential, proposal=prior)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer(two_moons_simulator, prior, "NRE", 50)
    trainer = NRE_B(prior=prior, device="cpu")
    trainer.append_simulations(theta, x).train(max_num_epochs=1)
    assert trainer._neural_net.device == torch.device("cpu")
    for sample_with in ("mcmc", "rejection", "importance"):
        posterior = trainer.build_posterior(
            sample_with=sample_with, mcmc_parameters=dict(num_chains=4, warmup_steps=5)
            if sample_with == "mcmc" else None)
        samples = posterior.sample((5,), x=np.zeros(2, np.float32))
        assert samples.shape == (5, 2) and samples.device == torch.device("cpu")


def test_prior_on_another_device_than_the_trainer_raises():
    from sbi_tpu_torch.inference import NPE
    from sbi_tpu_torch.utils import BoxUniform

    prior = BoxUniform(-np.ones(2), np.ones(2), device="meta")
    with pytest.raises(ValueError, match="device"):
        NPE(prior=prior, device="cpu")


def test_chip_smoke_refuses_to_run_here(tmp_path):
    """Without CUDA, or alone in a directory, chip_smoke.py exits non-zero
    and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def _module_level_imports(path):
    """Roots imported outside any function body of ``path``."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (alias.name.split(".")[0] for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                yield node.module.split(".")[0]
            yield from walk(ast.iter_child_nodes(node))

    return set(walk(ast.parse(path.read_text(), filename=str(path)).body))


def test_no_module_level_sklearn_import():
    """sklearn is imported only inside the functions that need it (c2st's
    classifier="rf"): the card's machine has no sklearn."""
    offenders = [str(f.relative_to(ROOT)) for f in _port_files()
                 if "sklearn" in _module_level_imports(f)]
    assert offenders == []
    metrics = ROOT / "sbi_tpu_torch" / "utils" / "metrics.py"
    assert "sklearn" in set(_imported_roots(metrics))  # inside c2st: the check sees it


def test_diagnostics_modules_leave_jax_and_sklearn_out():
    code = (
        "import sys\n"
        "import sbi_tpu_torch.diagnostics, sbi_tpu_torch.diagnostics.sbc, "
        "sbi_tpu_torch.diagnostics.tarp, sbi_tpu_torch.diagnostics.lc2st, "
        "sbi_tpu_torch.diagnostics.misspecification, sbi_tpu_torch.simulators.hodgkin_huxley, "
        "sbi_tpu_torch.utils.metrics, sbi_tpu_torch.utils.mlp_classifier, "
        "sbi_tpu_torch.utils.params_bridge\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'sbi_tpu', 'sklearn')]\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_diagnostics_default_to_cuda():
    """The HH prior and simulator, the batched classifier, c2st and LC2ST
    given arrays raise without CUDA; with device="cpu" (or CPU tensors) they run there."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from sbi_tpu_torch.diagnostics import LC2ST
    from sbi_tpu_torch.simulators import hh_prior, hodgkin_huxley
    from sbi_tpu_torch.utils import BatchedMLPClassifier, c2st

    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(40, 2)), rng.normal(size=(40, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        hh_prior()
    with pytest.raises(RuntimeError, match="CUDA"):
        hodgkin_huxley(np.array([[120.0, 36.0]]))
    with pytest.raises(RuntimeError, match="CUDA"):
        c2st(a, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedMLPClassifier((4,), random_state=[0]).fit(a[None], np.zeros((1, 40)))
    with pytest.raises(RuntimeError, match="CUDA"):
        LC2ST(a, b, a)
    theta = hh_prior(device="cpu").sample((1,))
    assert hodgkin_huxley(theta).device == torch.device("cpu")
    assert c2st(a, b, device="cpu").device == torch.device("cpu")
    lc = LC2ST(a, b, a, num_trials_null=2, device="cpu").train_under_null_hypothesis()
    assert lc.state.clfs_null.coefs_[0].device == torch.device("cpu")
