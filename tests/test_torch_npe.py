"""sbi_tpu_torch's NPE training against sbi_tpu's, on the CPU.

The flows are small (hidden 16, 2 transforms) with the JAX package's
weights, perturbed and bridged (``params_bridge``), as in
test_torch_flows.py; inputs are numpy arrays made from a seed. Tolerances:

- loss: 1e-4 absolute, the flows' log-prob tolerance (float32 sums over a
  few layers, accumulated in another order by XLA and torch).
- gradients: 1e-4 absolute plus 1e-3 relative per parameter element. A
  parameter's gradient is a mean over the batch of products through the
  whole flow; float32 reordering leaves ~1e-5 relative on each term, and a
  sum of terms of both signs loses the rest.
- three clip(5.0) + Adam(5e-4) steps: Adam divides each gradient element by
  its own magnitude, so an element whose gradient is of the order of the
  rounding noise may move by up to the learning rate per step, in either
  framework and either way: parameters agree within 2 x 3 x 5e-4 = 3e-3
  absolute, and all but 1% of the elements within 1e-5.
- the cosine schedule: 1e-4 relative (the rate is read back from optax's
  float32 Adam update of a unit gradient, whose bias corrections round at
  ~1e-5 relative).
- early stopping: exact (the same stopping epoch and best epoch).
- end to end: two_moons trained by both packages on 2,000 simulations at
  the same small budget (hidden 16, 2 transforms, at most 100 epochs); the
  port's C2ST against the reference posterior may exceed JAX's by at most
  0.12. Both are scored by sbi_tpu's ``c2st_jax`` (n = 1,000 per side, one
  key). The packages' initialisations and batch orders differ: over seven
  seeds the port's C2ST minus JAX's read -0.035 to +0.09 (JAX 0.56-0.64).
"""

import copy
import functools
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbi_tpu.inference import NPE as JaxNPE
from sbi_tpu.inference import NPE_C as JaxNPE_C
from sbi_tpu.inference import simulate_for_sbi as jax_simulate_for_sbi
from sbi_tpu.inference.trainers._contracts import TrainConfig as JaxTrainConfig
from sbi_tpu.neural_nets.net_builders.flow import build_maf as jax_build_maf
from sbi_tpu.simulators.tasks import get_task as jax_get_task
from sbi_tpu.utils import BoxUniform as JaxBoxUniform
from sbi_tpu.utils.metrics import c2st_jax
from sbi_tpu_torch.inference import NPE, NPE_C, simulate_for_sbi
from sbi_tpu_torch.inference.trainers._contracts import TrainConfig
from sbi_tpu_torch.inference.trainers.base import clip_by_global_norm_
from sbi_tpu_torch.neural_nets.net_builders.flow import build_maf
from sbi_tpu_torch.simulators import get_task
from sbi_tpu_torch.utils import BoxUniform
from sbi_tpu_torch.utils.params_bridge import load_flax_params

from .test_torch_flows import SMALL, make_pair
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

LOSS_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
LR = 5e-4
KEY = jax.random.PRNGKey(0)


@functools.lru_cache(maxsize=None)
def _maf_pair(dim=3, seed=0, noise=0.1, n=300):
    """A JAX MAF and the port's MAF with the same perturbed weights.
    Cached: callers must not modify what it returns."""
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, dim)) * 1.5 + 0.3).astype(np.float32)
    x = (theta[:, :1] + rng.normal(size=(n, 3))).astype(np.float32)
    je = jax_build_maf(jnp.asarray(theta), jnp.asarray(x), key=jax.random.PRNGKey(seed), **SMALL)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + noise * rng.normal(size=a.shape).astype(np.float32), je.params)
    je.params = jax.tree_util.tree_map(jnp.asarray, params)
    te = build_maf(theta, x, device="cpu", **SMALL)
    load_flax_params(
        te, params,
        np.asarray(je.input_transform.loc), np.asarray(je.input_transform.scale),
        np.asarray(je.condition_transform.loc), np.asarray(je.condition_transform.scale),
    )
    return je, te, theta, x


def _pair(kind):
    """(jax estimator, a private copy of the port's, theta, x)."""
    je, te, theta, x = _maf_pair() if kind == "maf3" else make_pair(int(kind[-1]))
    return je, copy.deepcopy(te), theta, x


@functools.lru_cache(maxsize=None)
def _jax_first_round_grad(kind):
    """The JAX trainer's first-round loss of ``kind``'s estimator as one
    jitted value_and_grad of (params, theta, x, masks), compiled once for
    the tests that use it."""
    je = _maf_pair()[0] if kind == "maf3" else make_pair(int(kind[-1]))[0]
    jtr = JaxNPE(prior=None)
    jtr._neural_net = je
    loss = jtr._make_loss_fn(None, None, True)
    return jax.jit(jax.value_and_grad(lambda p, *batch: loss(p, KEY, *batch).mean()))


def _trainers(je, te, cls=(JaxNPE, NPE), prior=(None, None)):
    jtr = cls[0](prior=prior[0])
    jtr._neural_net = je
    ttr = cls[1](prior=prior[1], device="cpu")
    ttr._neural_net = te
    return jtr, ttr


def _assert_grads_match(te, jax_grads, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    """Bridge JAX's gradient tree into a clone of the port's estimator and
    compare it with the port's .grad, parameter by parameter."""
    ref = load_flax_params(copy.deepcopy(te), jax.tree_util.tree_map(np.asarray, jax_grads))
    for (name, p), (_, r) in zip(te.net.named_parameters(), ref.net.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), r.detach().numpy(), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["nsf2", "nsf5", "maf3"])
def test_first_round_loss_and_gradients_match_jax(kind):
    je, te, theta, x = _pair(kind)
    _, ttr = _trainers(je, te)
    th, xs, masks = theta[:64], x[:64], np.ones(64, np.float32)
    val, grads = _jax_first_round_grad(kind)(je.params, *map(jnp.asarray, (th, xs, masks)))
    loss = ttr._make_loss_fn(None, None, True)(
        torch.tensor(th), torch.tensor(xs), torch.tensor(masks), None).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(val)) <= LOSS_ATOL
    _assert_grads_match(te, grads)


def test_maf_log_prob_and_inverse_match_jax():
    """The bridged MAF: log-prob, and noise -> data (its sequential
    inverse), in z-scored space, within the flows' 1e-4."""
    je, te, theta, x = _maf_pair()
    lp_j = np.asarray(je.log_prob(jnp.asarray(theta[None, :40]), jnp.asarray(x[:40])))
    with torch.no_grad():
        lp_t = te.log_prob(torch.tensor(theta[None, :40]), torch.tensor(x[:40])).numpy()
    np.testing.assert_allclose(lp_t, lp_j, atol=1e-4, rtol=0)
    z = np.random.default_rng(3).normal(size=(40, 3)).astype(np.float32)
    ctx = np.array(je.condition_transform.forward(jnp.asarray(x[:40])))

    def inverse(m, z_, c_):
        h = z_
        for layer in reversed(m.layers):
            h, _ = layer.inverse(h, c_)
        return h

    out_j = np.asarray(je.net.apply(je.params, jnp.asarray(z), jnp.asarray(ctx), method=inverse))
    with torch.no_grad():
        out_t, _ = te.net.inverse(torch.tensor(z), torch.tensor(ctx))
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("combined", [False, True])
def test_atomic_loss_matches_jax_when_atoms_cover_the_batch(combined):
    """With num_atoms >= batch size every row contrasts with all other
    rows, so the loss does not depend on the draw of the atoms."""
    je, te, theta, x = _pair("nsf5")
    B, dim = 12, theta.shape[1]
    lo, hi = np.full(dim, -10.0, np.float32), np.full(dim, 10.0, np.float32)
    jtr, ttr = _trainers(je, te, (JaxNPE_C, NPE_C),
                         (JaxBoxUniform(jnp.asarray(lo), jnp.asarray(hi)), BoxUniform(lo, hi, device="cpu")))
    for tr in (jtr, ttr):
        tr._num_atoms, tr._use_combined_loss = B, combined
    th, xs = theta[:B], x[:B]
    masks = np.tile(np.array([1.0, 0.0], np.float32), B // 2)
    jloss = jtr._make_proposal_loss_fn(None, None)
    val, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, KEY, jnp.asarray(th), jnp.asarray(xs), jnp.asarray(masks)).mean()
    ))(je.params)
    tloss = ttr._make_proposal_loss_fn(None, None)
    args = (torch.tensor(th), torch.tensor(xs), torch.tensor(masks))
    loss = tloss(*args, torch.Generator().manual_seed(0)).mean()
    loss.backward()
    with torch.no_grad():
        again = tloss(*args, torch.Generator().manual_seed(1)).mean()
    assert abs(float(again) - float(loss)) <= 1e-5
    assert abs(float(loss) - float(val)) <= LOSS_ATOL
    _assert_grads_match(te, grads)


def test_three_clipped_adam_steps_match_optax():
    je, te, theta, x = _pair("nsf5")
    jtr, ttr = _trainers(je, te)
    masks = np.ones(len(theta), np.float32)
    batches = [slice(0, 64), slice(64, 128), slice(128, 192)]
    # JAX: the trainer's own optax chain (clip 5.0, Adam 5e-4).
    tx = jtr._make_optimizer(JaxTrainConfig(), steps_per_epoch=len(batches))
    params = je.params
    state = tx.init(params)

    @jax.jit
    def apply(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state, optax.global_norm(g)

    norms = []
    for sl in batches:
        batch = tuple(jnp.asarray(a[sl]) for a in (theta, x, masks))
        _, g = _jax_first_round_grad("nsf5")(params, *batch)
        params, state, norm = apply(g, state, params)
        norms.append(float(norm))
    # The port: its trainer's optimizer and step.
    net_params = list(te.net.parameters())
    ttr._optimizer = ttr._make_optimizer(TrainConfig(), net_params)
    tloss = ttr._make_loss_fn(None, None, True)
    for sl in batches:
        batch = tuple(torch.tensor(a[sl]) for a in (theta, x, masks))
        ttr._train_step(tloss, batch, None, net_params, 5.0, None)
    assert ttr._opt_steps == 3
    assert max(norms) > 5.0  # the clip acted
    ref = load_flax_params(copy.deepcopy(te), jax.tree_util.tree_map(np.asarray, params))
    diffs = np.concatenate([(p.detach() - r.detach()).abs().numpy().ravel()
                            for p, r in zip(te.net.parameters(), ref.net.parameters())])
    assert diffs.max() <= 2 * 3 * LR
    assert np.mean(diffs > 1e-5) <= 0.01


@pytest.mark.parametrize("norm", [0.5, 5.0, 50.0])
def test_clip_matches_optax(norm):
    """Below, at and above max_norm = 5."""
    rng = np.random.default_rng(int(norm))
    tree = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    scale = norm / math.sqrt(sum(float((a**2).sum()) for a in tree))
    tree = [a * np.float32(scale) for a in tree]
    want, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(a) for a in tree], None)
    got = [torch.tensor(a) for a in tree]
    clip_by_global_norm_(got, 5.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


@pytest.mark.parametrize("warmup_frac, decay_epochs", [(0.02, None), (0.0, None), (0.3, 3)])
def test_cosine_schedule_matches_optax(warmup_frac, decay_epochs):
    """The learning rate of each step, read back from the JAX trainer's
    optax chain as the Adam update of a constant unit gradient."""
    kw = dict(learning_rate=1e-3, max_num_epochs=5, clip_max_norm=None, lr_schedule="cosine",
              lr_warmup_frac=warmup_frac, lr_decay_epochs=decay_epochs, lr_final_factor=0.01)
    steps_per_epoch = 4
    tx = JaxNPE(prior=None)._make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=steps_per_epoch)
    schedule = NPE._make_schedule(TrainConfig(**kw), steps_per_epoch)
    p = {"w": jnp.zeros(())}
    state = tx.init(p)
    for step in range(5 * steps_per_epoch + 3):
        updates, state = tx.update({"w": jnp.ones(())}, state, p)
        lr = -float(updates["w"])
        assert math.isclose(schedule(step), lr, rel_tol=1e-4, abs_tol=1e-12), (step, schedule(step), lr)


def test_early_stopping_matches_jax():
    losses = [5.0, 4.0, 4.5, 3.9, 3.95, 4.1, 4.2, 4.3, 3.8, 3.85, 3.9, 4.0, 4.1, 4.2]
    for patience in (1, 2, 3, 4):
        outcome = []
        for tr in (JaxNPE(prior=None), NPE(prior=None, device="cpu")):
            stop = None
            for epoch, v in enumerate(losses):
                params = epoch if isinstance(tr, JaxNPE) else (lambda e=epoch: e)
                if tr._converged(v, params, patience):
                    stop = epoch
                    break
            outcome.append((stop, tr._best_params, tr._best_val_loss))
        assert outcome[0] == outcome[1], (patience, outcome)


def test_save_load_and_resume(tmp_path):
    """A trained trainer pickles without its builder closure; the loaded one
    serves the same posterior and resumes training with its optimizer."""
    task = get_task("two_moons", device="cpu")
    g = torch.Generator().manual_seed(0)
    theta, x = simulate_for_sbi(task.simulator, task.prior, 300, generator=g)
    trainer = NPE(prior=task.prior, density_estimator=_torch_nsf(), device="cpu")
    trainer.append_simulations(theta, x).train(max_num_epochs=2, generator=g)
    trainer.save(tmp_path / "npe.pkl")
    loaded = NPE.load(tmp_path / "npe.pkl")
    th = theta[:20]
    with torch.no_grad():
        want = trainer.build_posterior().log_prob(th, x=x[0], norm_posterior=False)
        got = loaded.build_posterior().log_prob(th, x=x[0], norm_posterior=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    loaded.train(max_num_epochs=1, resume_training=True, generator=g)
    assert loaded._epoch == 3 and loaded._opt_steps == trainer._opt_steps + 1
    with pytest.raises(RuntimeError, match="not serialized"):
        loaded.train(max_num_epochs=1, retrain_from_scratch=True)


def test_two_moons_end_to_end_against_jax():
    """Both packages train two_moons NPE-NSF at the same small budget; the
    port's C2ST against the reference posterior is at most 0.12 above JAX's."""
    num_sims, n = 2_000, 1_000
    train = dict(max_num_epochs=100, stop_after_epochs=15, training_batch_size=100)
    with np.load(pathlib.Path(__file__).parent / "mini_sbibm" / "files" / "two_moons.npz") as f:
        x_o, ref = f["observations"][0], f["reference_samples"][0][:n]

    jtask = jax_get_task("two_moons")
    jtheta, jx = jax_simulate_for_sbi(jtask.simulator, jtask.prior, num_sims, key=jax.random.PRNGKey(1))
    jnpe = JaxNPE(prior=jtask.prior, density_estimator=_jax_nsf())
    jnpe.append_simulations(jtheta, jx).train(key=jax.random.PRNGKey(2), **train)
    s_j = np.asarray(jnpe.build_posterior().sample((n,), x=jnp.asarray(x_o), key=jax.random.PRNGKey(3)))

    task = get_task("two_moons", device="cpu")
    g = torch.Generator().manual_seed(1)
    theta, x = simulate_for_sbi(task.simulator, task.prior, num_sims, generator=g)
    tnpe = NPE(prior=task.prior, density_estimator=_torch_nsf(), device="cpu")
    tnpe.append_simulations(theta, x).train(generator=g, **train)
    s_t = tnpe.build_posterior().sample((n,), x=torch.tensor(x_o), generator=g).numpy()

    assert s_t.shape == (n, 2) and np.isfinite(s_t).all()
    c_j = float(c2st_jax(s_j, ref, key=jax.random.PRNGKey(0)))
    c_t = float(c2st_jax(s_t, ref, key=jax.random.PRNGKey(0)))
    assert c_t <= c_j + 0.12, (c_t, c_j)


def _jax_nsf():
    from sbi_tpu.neural_nets.factory import posterior_nn

    return posterior_nn("nsf", **SMALL)


def _torch_nsf():
    from sbi_tpu_torch.neural_nets import posterior_nn

    return posterior_nn("nsf", device="cpu", generator=torch.Generator().manual_seed(0), **SMALL)
