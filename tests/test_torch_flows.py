"""sbi_tpu_torch's NSF against sbi_tpu's, on the CPU, on bridged weights.

The JAX NSF is built at a small size (hidden 16, 2 transforms) for dim 5
(RQ couplings + LU-linear) and dim 2 (autoregressive splines +
permutation); its parameters are perturbed with numpy noise so the
zero-initialised heads are non-zero, and ``params_bridge`` loads them into
the port's estimator. Both then see the same numpy inputs.

Tolerance on log-prob and on the inverse: 1e-4 absolute. Both are float32
sums over a few layers of matrix products (XLA's and torch's CPU kernels
accumulate in another order) and spline log-dets, which agree to ~1e-5 per
layer (see test_torch_rqs.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.neural_nets.estimators.flows import LULinear as JaxLULinear
from sbi_tpu.neural_nets.net_builders.flow import build_nsf as jax_build_nsf
from sbi_tpu_torch.neural_nets.estimators.flows import (
    LULinear,
    MaskedRQSAutoregressive,
    RQSCoupling,
)
from sbi_tpu_torch.neural_nets.net_builders.flow import build_nsf
from sbi_tpu_torch.utils.params_bridge import load_flax_params
from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
SMALL = dict(hidden_features=16, num_transforms=2)


@functools.lru_cache(maxsize=None)
def make_pair(dim, x_dim=3, seed=0, noise=0.1, n=300):
    """A JAX NSF and the port's NSF with the same (perturbed) weights and
    z-scoring. Returns (jax_est, torch_est, theta, x) with numpy data.
    Cached: callers must not modify what it returns."""
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(n, dim)) * 1.5 + 0.3).astype(np.float32)
    x = (theta[:, :1] + rng.normal(size=(n, x_dim))).astype(np.float32)
    je = jax_build_nsf(jnp.asarray(theta), jnp.asarray(x), key=jax.random.PRNGKey(seed), **SMALL)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + noise * rng.normal(size=a.shape).astype(np.float32),
        je.params,
    )
    je.params = jax.tree_util.tree_map(jnp.asarray, params)
    te = build_nsf(theta, x, device="cpu", **SMALL)
    load_flax_params(
        te, params,
        np.asarray(je.input_transform.loc), np.asarray(je.input_transform.scale),
        np.asarray(je.condition_transform.loc), np.asarray(je.condition_transform.scale),
    )
    return je, te, theta, x


@pytest.mark.parametrize("dim", [2, 5])
def test_structure_and_parameter_count_match_jax(dim):
    je, te, _, _ = make_pair(dim)
    leaves = jax.tree_util.tree_leaves(je.params)
    assert sum(p.numel() for p in te.net.parameters()) == sum(a.size for a in leaves)
    kind = MaskedRQSAutoregressive if dim <= 2 else RQSCoupling
    assert sum(isinstance(l, kind) for l in te.net.layers) == SMALL["num_transforms"]


@pytest.mark.parametrize("dim", [2, 5])
def test_log_prob_matches_jax(dim):
    je, te, theta, x = make_pair(dim)
    rng = np.random.default_rng(7)
    th = (theta[:40] + 0.5 * rng.normal(size=theta[:40].shape)).astype(np.float32)
    lp_j = np.asarray(je.log_prob(jnp.asarray(th[None]), jnp.asarray(x[:40])))
    with torch.no_grad():
        lp_t = te.log_prob(torch.as_tensor(th[None]), torch.as_tensor(x[:40])).numpy()
    assert np.isfinite(lp_t).all()
    np.testing.assert_allclose(lp_t, lp_j, atol=ATOL, rtol=0)
    # loss is -log_prob over a batch
    with torch.no_grad():
        loss = te.loss(torch.as_tensor(th), torch.as_tensor(x[:40])).numpy()
    np.testing.assert_allclose(loss, -lp_j[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("dim", [2, 5])
def test_inverse_matches_jax(dim):
    """The same base noise through the layers in reverse, in z-scored space."""
    je, te, _, x = make_pair(dim)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(64, dim)).astype(np.float32)
    ctx = np.array(je.condition_transform.forward(jnp.asarray(x[:64])))

    def inverse(m, z_, c_):
        h = z_
        for layer in reversed(m.layers):
            h, _ = layer.inverse(h, c_)
        return h

    out_j = np.asarray(je.net.apply(je.params, jnp.asarray(z), jnp.asarray(ctx), method=inverse))
    with torch.no_grad():
        out_t, _ = te.net.inverse(torch.as_tensor(z), torch.as_tensor(ctx))
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dim", [2, 5])
def test_sample_and_log_prob_consistent(dim):
    """Single-pass sample_and_log_prob (inverse log-dets) agrees with
    log_prob (forward log-dets) of the same samples."""
    _, te, _, x = make_pair(dim)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        theta, lp = te.sample_and_log_prob_fn(50, torch.as_tensor(x[:3]), generator=g)
        lp2 = te.log_prob(theta, torch.as_tensor(x[:3]))
    assert theta.shape == (50, 3, dim) and lp.shape == (50, 3)
    np.testing.assert_allclose(lp.numpy(), lp2.numpy(), atol=1e-3, rtol=0)


def test_lu_linear_matches_jax():
    D = 4
    rng = np.random.default_rng(5)
    m = JaxLULinear(dim=D)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, D)), method="forward")
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), params
    )
    t = LULinear(D)
    with torch.no_grad():
        for name in ("lower", "upper", "log_diag", "bias"):
            getattr(t, name).copy_(torch.as_tensor(params["params"][name]))
    x = rng.normal(size=(10, D)).astype(np.float32)
    for method in ("forward", "inverse"):
        y_j, ld_j = m.apply(params, jnp.asarray(x), method=method)
        with torch.no_grad():
            y_t, ld_t = getattr(t, method)(torch.as_tensor(x))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=1e-5)


def test_bridge_rejects_mismatched_params():
    je, te, _, _ = make_pair(5)
    params = jax.tree_util.tree_map(np.asarray, je.params)
    params["params"]["layers_0"]["Dense_0"]["kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(te, params)
