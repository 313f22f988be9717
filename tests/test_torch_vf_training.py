"""sbi_tpu_torch's FMPE and NPSE trainers against sbi_tpu's, on the CPU: the
EMA loss summary and the statistical patience on the same loss sequences,
the parameter EMA and its opt-out, the fixed validation grid, the resume
guard, ``train_ensemble``, and small trainings end to end on the 2-D
linear Gaussian (shift -1, covariance 0.3 I, prior N(0, I)).

Tolerances:

- the hooks' arrays (EMA'd losses): 1e-12 relative, the same float64
  recurrence; stop decisions, patience counters and the epoch kept: exact.
- the parameter EMA against ``params_ema_transform``'s update: 1e-7
  absolute, one float32 multiply-add; against a replay of the recorded
  optimizer steps: 1e-6.
- the validation loss on the JAX package's noise: 1e-5 relative plus 1e-6
  absolute, as the losses in ``test_torch_vf_nets.py``.
- end to end: posterior means increase with x in every coordinate
  (``tests/test_vector_field.py``'s check); draws finite, of the shapes
  asked for; the 64-step ``log_prob`` within LOG_PROB_STEP_ATOL of 256
  steps.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.inference import FMPE as JaxFMPE
from sbi_tpu.inference import NPSE as JaxNPSE
from sbi_tpu.inference.trainers.base import params_ema_transform
from sbi_tpu.utils.distributions import MultivariateNormal as JaxMVN
from sbi_tpu_torch.inference import (
    FMPE,
    METHOD_REGISTRY,
    NPSE,
    VectorFieldPosterior,
    VectorFieldPosteriorParameters,
    infer,
)
from sbi_tpu_torch.inference.trainers.base import ema_update_
from sbi_tpu_torch.neural_nets import posterior_flow_nn, posterior_score_nn
from sbi_tpu_torch.samplers.ode import ode_solvers
from sbi_tpu_torch.simulators.linear_gaussian import linear_gaussian
from sbi_tpu_torch.utils import MultivariateNormal

from .test_torch_vf_nets import close, vf_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
# The 64-step log_prob against 256 steps, twice the largest error read on
# this file's trained fields (FMPE 0.067, NPSE-VE 0.41: the VE flow is stiff
# near t_min, where sigma falls to 0.01).
LOG_PROB_STEP_ATOL = {"FMPE": 0.15, "NPSE": 0.8}
D = 2


def prior_cpu():
    return MultivariateNormal(torch.zeros(D), covariance_matrix=torch.eye(D), device="cpu")


def lg_data(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    theta = torch.randn(n, D, generator=g)
    x = linear_gaussian(theta, -torch.ones(D), 0.3 * torch.eye(D), generator=g)
    return theta, x


def small(kind):
    if kind == "fm":
        return posterior_flow_nn(hidden_features=16, device="cpu")
    return posterior_score_nn(sde_type=kind, hidden_features=16, device="cpu")


def trainer(kind, **kw):
    cls = FMPE if kind == "fm" else NPSE
    extra = {} if kind == "fm" else {"sde_type": kind}
    return cls(prior=prior_cpu(), density_estimator=small(kind), device="cpu", **extra, **kw)


# ---------------------------------------------------------------------------
# The stopping rule against the JAX package's
# ---------------------------------------------------------------------------


def loss_sequence(seed, n=150):
    """A validation curve that falls, then rises from epoch 50 (over-
    fitting), with noise on it."""
    rng = np.random.default_rng(seed)
    epochs = np.arange(n)
    return (1.0 + 2.0 * np.exp(-epochs / 15.0) + 0.02 * np.maximum(0, epochs - 50)
            + 0.08 * rng.standard_normal(n))


@pytest.mark.parametrize("seed,chunks,patience,decay", [
    (0, (1,), 10, 0.1), (1, (1,), 5, 0.3), (2, (3, 1, 5, 2), 8, 0.1), (3, (5,), 12, 0.05),
])
def test_loss_summary_and_statistical_patience(seed, chunks, patience, decay):
    """The same raw per-epoch losses, in the same chunks, through both
    packages' ``_postprocess_epoch_losses``, the summary, then
    ``_converged_chunk``: the same EMA'd arrays, the same stop, the same
    patience counter and the same chunk kept, chunk after chunk."""
    val = loss_sequence(seed)
    train = val + 0.1
    jtr = JaxFMPE(prior=JaxMVN(jnp.zeros(D), covariance_matrix=jnp.eye(D)))
    ttr = FMPE(prior=prior_cpu(), device="cpu")
    for tr in (jtr, ttr):
        tr._ema_loss_decay = decay
    start, i = 0, 0
    while start < len(val):
        n = chunks[i % len(chunks)]
        i += 1
        chunk = slice(start, min(start + n, len(val)))
        start = chunk.stop
        jt, jv = jtr._postprocess_epoch_losses(train[chunk], val[chunk])
        tt, tv = ttr._postprocess_epoch_losses(list(train[chunk]), list(val[chunk]))
        np.testing.assert_allclose(tt, jt, rtol=1e-12)
        np.testing.assert_allclose(tv, jv, rtol=1e-12)
        for tr, (a, b) in ((jtr, (jt, jv)), (ttr, (tt, tv))):
            tr._summary["training_loss"].extend(float(v) for v in a)
            tr._summary["validation_loss"].extend(float(v) for v in b)
        j_stop = jtr._converged_chunk(np.asarray(jv), chunk.stop, patience)
        t_stop = ttr._converged_chunk(tv, lambda: chunk.stop, patience)
        assert (t_stop, ttr._epochs_since_last_improvement, ttr._best_params) == (
            j_stop, jtr._epochs_since_last_improvement, jtr._best_params)
        assert ttr._best_val_loss == pytest.approx(jtr._best_val_loss, rel=1e-12)
        if j_stop:
            break
    assert j_stop and start < len(val)  # the rule stopped on the rising curve


def test_statistical_patience_resets():
    """An epoch within 2 sigma of the best resets the patience counter, one
    3 sigma above it counts (``tests/test_vf_convergence.py``)."""
    tr = NPSE(prior=prior_cpu(), device="cpu")
    tr._best_val_loss, tr._epochs_since_last_improvement = 1.0, 3
    tr._summary["validation_loss"] = list(1.0 + 0.05 * np.sin(np.arange(20)))
    assert not tr._converged_chunk([1.02], lambda: None, stop_after_epochs=5)
    assert tr._epochs_since_last_improvement == 0
    tr._converged_chunk([1.0 + 5 * 0.035], lambda: None, stop_after_epochs=5)
    assert tr._epochs_since_last_improvement == 1


def test_base_hooks_keep_the_npe_rule():
    """The base loop's default hooks: losses untouched; convergence on the
    best of the losses given, patience counted in epochs."""
    from sbi_tpu_torch.inference import NPE

    tr = NPE(prior=prior_cpu(), device="cpu")
    assert tr._postprocess_epoch_losses([2.0], [1.5]) == ([2.0], [1.5])
    assert not tr._converged_chunk([1.5], lambda: "a", 3) and tr._best_params == "a"
    assert not tr._converged_chunk([1.6, 1.7], lambda: "b", 3)
    assert tr._converged_chunk([1.6], lambda: "c", 3) and tr._best_params == "a"


# ---------------------------------------------------------------------------
# Parameter EMA, validation grid, resume
# ---------------------------------------------------------------------------


def test_ema_update_formula():
    rng = np.random.default_rng(0)
    ema0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    params = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in ema0.items()}
    tx = params_ema_transform(0.97)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    _, state = tx.update(zeros, tx.init(ema0), params)
    ema = [torch.tensor(v) for v in ema0.values()]
    ema_update_(ema, [torch.tensor(v) for v in params.values()], 0.97)
    for got, want in zip(ema, state.ema.values()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("decay", [0.9, None])
def test_parameter_ema_tracks_steps_and_is_validated(decay):
    """With a decay, the trainer's EMA equals a replay of every optimizer
    step's parameters, and the validation loss it records and the
    snapshots it keeps are the EMA's; with None there is no EMA and the raw
    parameters are validated and kept."""
    theta, x = lg_data(300)
    tr = trainer("fm")
    tr.append_simulations(theta, x)
    tr._neural_net = tr._build_neural_net(theta, x)
    net = tr._neural_net.net
    trajectory = [[p.detach().clone() for p in net.parameters()]]
    step = tr._train_step

    def recording_step(*args, **kwargs):
        out = step(*args, **kwargs)
        trajectory.append([p.detach().clone() for p in net.parameters()])
        return out

    raw = []
    post = tr._postprocess_epoch_losses

    def recording_post(t, v):
        raw.append(v[0])
        return post(t, v)

    snapshots = []
    converged = tr._converged_chunk

    def recording_converged(vals, snapshot, stop):
        kept = tr._ema_params if decay is not None else list(net.parameters())
        snapshots.append((snapshot(), [p.detach().clone() for p in kept]))
        return converged(vals, snapshot, stop)

    tr._train_step, tr._postprocess_epoch_losses = recording_step, recording_post
    tr._converged_chunk = recording_converged
    tr.train(max_num_epochs=3, ema_params_decay=decay, generator=torch.Generator().manual_seed(0))
    # every snapshot holds the parameters validation scored: the EMA, or the raw ones
    names = [k for k, _ in net.named_parameters()]
    for snap, want in snapshots:
        for name, w in zip(names, want):
            assert torch.equal(snap[name], w), name
    if decay is None:
        assert tr._ema_params is None
        at = trajectory[-1]
    else:
        at = [p.clone() for p in trajectory[0]]
        for params in trajectory[1:]:
            at = [decay * e + (1 - decay) * p for e, p in zip(at, params)]
        for got, want in zip(tr._ema_params, at):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    # the last epoch's raw validation loss, recomputed at those parameters
    probe = copy.deepcopy(tr._neural_net)
    with torch.no_grad():
        for p, v in zip(probe.net.parameters(), at):
            p.copy_(v)
        val_idx = tr._val_indices
        want = tr._fixed_times_loss(probe, 0.05, 0.95, 10)(theta[val_idx], x[val_idx]).mean()
    assert raw[-1] == pytest.approx(float(want), rel=1e-5)
    # the estimator ends with the best epoch's snapshot
    for k, v in net.state_dict().items():
        assert torch.equal(v, tr._best_params[k])


def test_validation_grid_on_jax_noise():
    """The fixed-grid validation loss, fed the JAX package's fixed noise
    (``PRNGKey(0)`` split as the loss splits it), equals the JAX package's
    vmapped loss over the same grid."""
    je, te, theta, x = vf_pair("vp", seed=6)
    n = 20
    grid = jnp.linspace(0.05, 0.95, 10)
    want = jax.vmap(lambda t: je.loss_fn(je.params, jnp.asarray(theta[:n]), jnp.asarray(x[:n]),
                                         jax.random.PRNGKey(0), times=jnp.full((n,), t)))(grid)
    noise = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(0))[1], (n, D)))
    tr = NPSE(prior=prior_cpu(), device="cpu")
    got = tr._fixed_times_loss(te, 0.05, 0.95, 10)(torch.tensor(theta[:n]), torch.tensor(x[:n]),
                                                    torch.tensor(noise))
    close(got, want.mean(axis=0), LOSS_RTOL, LOSS_ATOL)
    # without noise: one fixed draw, the same at every call
    fn = tr._fixed_times_loss(te, 0.05, 0.95, 10)
    a = fn(torch.tensor(theta[:n]), torch.tensor(x[:n]))
    assert torch.equal(a, fn(torch.tensor(theta[:n]), torch.tensor(x[:n])))


def test_resume_guard():
    theta, x = lg_data(200)
    tr = trainer("ve").append_simulations(theta, x)
    g = torch.Generator().manual_seed(0)
    tr.train(max_num_epochs=2, generator=g)
    steps, ema = tr._opt_steps, tr._ema_params
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")  # the same setting: the state goes on
        tr.train(max_num_epochs=1, resume_training=True, generator=g)
    assert not [w for w in caught if "optimizer structure" in str(w.message)]
    assert tr._opt_steps > steps and tr._ema_params is ema
    with pytest.warns(UserWarning, match="optimizer structure changed"):
        tr.train(max_num_epochs=1, resume_training=True, ema_params_decay=None, generator=g)
    assert tr._ema_params is None and tr._epoch == 4
    with pytest.warns(UserWarning, match="optimizer structure changed"):
        tr.train(max_num_epochs=1, resume_training=True, ema_params_decay=0.99, generator=g)
    assert tr._ema_params is not None


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["fm", "ve"])
def trained(request):
    torch.manual_seed(0)
    theta, x = lg_data(2000)
    tr = trainer(request.param)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        tr.append_simulations(theta, x).train(
            training_batch_size=100, max_num_epochs=40, ema_params_decay=0.99,
            generator=torch.Generator().manual_seed(0))
    return request.param, tr


def test_sample_batched_and_ode(trained):
    """``build_posterior()``: SDE for NPSE, ODE for FMPE. ``sample_batched``
    over three observations, (S, B, D), means increasing with x; the ODE
    path for a batch; ``sample`` and ``log_prob`` for one observation."""
    kind, tr = trained
    post = tr.build_posterior()
    assert isinstance(post, VectorFieldPosterior)
    assert post.sample_with == ("ode" if kind == "fm" else "sde")
    g = torch.Generator().manual_seed(1)
    xs = torch.tensor([[-2.0, -2.0], [0.0, 0.0], [2.0, 2.0]])
    if kind == "fm":  # flow matching has no SDE: the ODE, one observation at a time
        with pytest.raises(NotImplementedError, match="no SDE"):
            post.sample_batched((20,), x=xs, generator=g, sample_with="sde")
    s = post.sample_batched((200,), x=xs, generator=g, steps=100)
    assert s.shape == (200, 3, 2) and bool(torch.isfinite(s).all())
    means = s.mean(0)
    assert bool((means[2] > means[1]).all() and (means[1] > means[0]).all()), means
    s_ode = post.sample_batched((50,), x=xs[:2], generator=g, sample_with="ode")
    assert s_ode.shape == (50, 2, 2) and bool(torch.isfinite(s_ode).all())
    one = post.sample((30,), x=xs[1], generator=g, steps=50)
    assert one.shape == (30, 2) and bool(torch.isfinite(one).all())
    lp = post.log_prob(one[:5], x=xs[1])
    assert lp.shape == (5,) and bool(torch.isfinite(lp).all())
    # the potential's gradient is the score at data time
    post.potential_fn.set_x(xs[1:2])
    grad = post.potential_fn.gradient(one[:5])
    est = post.vector_field_estimator
    want = est.score(one[:5], xs[1:2].expand(5, 2), est.t_min if est.SDE_DEFINED else est.t_max)
    assert torch.equal(grad, want)


def test_ode_steps_honoured(trained, monkeypatch):
    """``sample_via_ode`` integrates at the potential's ``ode_steps``."""
    _, tr = trained
    post = tr.build_posterior()
    steps = []
    rk4 = ode_solvers.odeint_rk4

    def counting(f, z0, t0, t1, num_steps=64):
        steps.append(num_steps)
        return rk4(f, z0, t0, t1, num_steps)

    monkeypatch.setattr(ode_solvers, "odeint_rk4", counting)
    g = torch.Generator().manual_seed(2)
    post.sample_via_ode((20,), x=torch.zeros(2), generator=g)
    post.potential_fn.ode_steps = 16
    post.sample_via_ode((20,), x=torch.zeros(2), generator=g)
    assert steps == [64, 16]


def test_refusals(trained):
    """iid observations, guidance and ``map`` come with a later slice."""
    _, tr = trained
    post = tr.build_posterior()
    two = torch.zeros(2, 2)
    with pytest.raises(NotImplementedError, match="later slice"):
        post.sample((5,), x=two)
    with pytest.raises(NotImplementedError, match="later slice"):
        post.log_prob(torch.zeros(3, 2), x=two)
    with pytest.raises(NotImplementedError, match="later slice"):
        post.sample((5,), x=torch.zeros(2), guidance_method="universal")
    with pytest.raises(NotImplementedError, match="later slice"):
        post.sample((5,), x=torch.zeros(2), iid_method="fnpe")
    with pytest.raises(NotImplementedError, match="later slice"):
        post.potential_fn.set_x(torch.zeros(1, 2), x_is_iid=True)
    with pytest.raises(NotImplementedError, match="later slice"):
        post.map(x=torch.zeros(2))
    with pytest.raises(NotImplementedError, match="later slice"):
        post.sample_batched((5,), x=two, mesh="auto")


def test_posterior_parameters_and_warnings(trained):
    kind, tr = trained
    post = tr.build_posterior(posterior_parameters=VectorFieldPosteriorParameters(
        sample_with="ode", max_sampling_batch_size=500))
    assert isinstance(post, VectorFieldPosterior)
    assert (post.sample_with, post.max_sampling_batch_size) == ("ode", 500)
    with pytest.warns(UserWarning, match="takes precedence"):
        tr.build_posterior(sample_with="sde", posterior_parameters=VectorFieldPosteriorParameters())
    with pytest.warns(UserWarning, match="single-round"):
        trainer(kind).append_simulations(*lg_data(20), proposal=object())


def test_train_ensemble_and_infer():
    """``train_ensemble`` trains FMPE and NPSE members as one vmapped step
    (times and noise drawn outside it); ``infer`` knows both methods."""
    assert METHOD_REGISTRY["FMPE"] is FMPE and METHOD_REGISTRY["NPSE"] is NPSE
    theta, x = lg_data(300)
    g = torch.Generator().manual_seed(0)
    for kind in ("fm", "vp"):
        tr = trainer(kind).append_simulations(theta, x)
        members = tr.train_ensemble(num_members=2, max_num_epochs=2, epoch_chunk=1, generator=g)
        assert len(members) == 2
        assert not torch.equal(members[0].net.inp.weight, members[1].net.inp.weight)
        post = tr.build_ensemble_posterior()
        s = post.sample((10,), x=torch.zeros(2), generator=g, steps=20)
        assert s.shape == (10, 2) and bool(torch.isfinite(s).all())
    post = infer(lambda th: linear_gaussian(th, -torch.ones(D), 0.3 * torch.eye(D)), prior_cpu(),
                 "FMPE", 100, init_kwargs=dict(device="cpu", density_estimator=small("fm")),
                 train_kwargs=dict(max_num_epochs=1))
    assert isinstance(post, VectorFieldPosterior) and post.sample_with == "ode"


def test_log_prob_step_sweep(trained):
    """The 64-step RK4 ``log_prob``'s discretisation error on a trained
    field (the JAX package integrates the same 64 steps): against 256
    steps, 16 steps err more than 64, and 64 stay within
    LOG_PROB_STEP_ATOL."""
    _, tr = trained
    post = tr.build_posterior()
    theta = post.sample((30,), x=torch.zeros(2), generator=torch.Generator().manual_seed(3),
                        sample_with="ode")
    lps = {}
    for steps in (16, 64, 256):
        post.potential_fn.ode_steps = steps
        lps[steps] = post.log_prob(theta, x=torch.zeros(2))
    err16 = float((lps[16] - lps[256]).abs().max())
    err64 = float((lps[64] - lps[256]).abs().max())
    assert err64 < err16 and err64 <= LOG_PROB_STEP_ATOL[type(tr).__name__]
