"""sbi_tpu_torch's vector-field nets, embedding nets and estimators against
sbi_tpu's, on the CPU, on the JAX package's weights (perturbed, so that the
zero-initialised layers matter) loaded through ``params_bridge``.

Tolerances:

- embedding nets and vector-field nets: 1e-5 absolute on outputs of order
  1-5 (float32 sums of a few hundred products in another order). The
  nets' time embedding takes the JAX package's frequencies here: its
  float32 ``linspace`` and ``exp`` read up to 8 ulps off the port's
  correctly rounded ones (checked on their own, at 1e-6 relative), which
  at angles up to 1,000 rad moves the sines by 3e-4.
- the SDE schedules (mean, std, drift, diffusion): 1e-6 relative plus
  1e-7 absolute, elementwise float32 math.
- scores, ODE velocities and flow-matching velocities: 1e-5 relative plus
  1e-5 absolute; in raw theta space the score is divided by std_t (down to
  0.01 at t_min for VE) and the z-score scale, so 1e-4 relative there.
- losses at given times and noise (the JAX package's own draws from its
  key, recomputed here): 1e-5 relative plus 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_tpu.neural_nets.embedding_nets import CNNEmbedding as JaxCNN
from sbi_tpu.neural_nets.embedding_nets import FCEmbedding as JaxFC
from sbi_tpu.neural_nets.net_builders import vector_field_nets as jvf
from sbi_tpu_torch.neural_nets import posterior_flow_nn, posterior_nn, posterior_score_nn
from sbi_tpu_torch.neural_nets.embedding_nets import CNNEmbedding, FCEmbedding, IdentityEmbedding
from sbi_tpu_torch.neural_nets.net_builders import vector_field_nets as tvf
from sbi_tpu_torch.utils.params_bridge import load_flax_embedding, load_flax_params

from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

NET_ATOL = 1e-5
SCHED_RTOL, SCHED_ATOL = 1e-6, 1e-7
FIELD_RTOL, FIELD_ATOL = 1e-5, 1e-5
RAW_SCORE_RTOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
JAX_FREQS = np.asarray(jnp.exp(jnp.linspace(0.0, np.log(1000.0), 16)))
TIMES = np.array([1e-3, 0.05, 0.3, 0.5, 0.77, 0.95, 1.0], np.float32)


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def perturbed(params, seed=0, std=0.1):
    """The JAX parameters plus N(0, std^2) noise, so zero-initialised
    layers (AdaLN modulation, the AdaMLP head) are not zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + std * rng.standard_normal(a.shape).astype(np.float32)),
        params)


def with_jax_freqs(module):
    """``module`` (a net, or its time embedding) with the JAX package's
    float32 frequencies."""
    emb = getattr(module, "time_embedding", module)
    with torch.no_grad():
        emb.freqs.copy_(torch.tensor(JAX_FREQS))
    return module


def data(dim=2, x_shape=(3,), n=64, seed=0):
    rng = np.random.default_rng(seed)
    theta = (rng.standard_normal((n, dim)) * 1.5 + 0.3).astype(np.float32)
    x = (rng.standard_normal((n,) + x_shape) * 2.0 - 1.0).astype(np.float32)
    x[:, ...] += theta[:, :1].reshape((n,) + (1,) * len(x_shape))
    return theta, x


def embedding_pair(kind):
    """(JAX embedding, port embedding, x_shape) of one kind."""
    if kind == "fc":
        return JaxFC(output_dim=5, num_hiddens=12), FCEmbedding(output_dim=5, num_hiddens=12), (7,)
    shape, c = {"cnn1d": ((32,), 1), "cnn2d": ((8, 8), 1), "cnn2d_c3": ((8, 8), 3)}[kind]
    kw = dict(input_shape=shape, in_channels=c, out_channels_per_layer=(4, 6), output_dim=5,
              num_linear_units=20)
    return JaxCNN(**kw), CNNEmbedding(**kw), (int(np.prod(shape)) * c,)


def vf_pair(kind="fm", net="mlp", embedding=None, dim=2, x_shape=(3,), hidden=16, seed=0, **kw):
    """(JAX estimator, port estimator with the JAX weights, theta, x):
    ``kind`` "fm" (flow matching) or an sde_type."""
    theta, x = data(dim, x_shape, seed=seed)
    jemb = temb = None
    if embedding is not None:
        jemb, temb, x_shape = embedding_pair(embedding)
        theta, x = data(dim, x_shape, seed=seed)
    if kind == "fm":
        je = jvf.build_flow_matching_estimator(theta, x, net=net, hidden_features=hidden,
                                               embedding_net=jemb, key=jax.random.PRNGKey(seed),
                                               **kw)
        te = posterior_flow_nn(model=net, hidden_features=hidden, embedding_net=temb,
                               device="cpu", **kw)(theta, x)
    else:
        je = jvf.build_score_estimator(theta, x, sde_type=kind, net=net, hidden_features=hidden,
                                       embedding_net=jemb, key=jax.random.PRNGKey(seed))
        te = posterior_score_nn(model=net, sde_type=kind, hidden_features=hidden,
                                embedding_net=temb, device="cpu")(theta, x)
    je.params = perturbed(je.params, seed)
    it, ct = je.input_transform, je.condition_transform
    load_flax_params(te, np_tree(je.params), it.loc, it.scale, ct.loc, ct.scale)
    with_jax_freqs(te.net)
    return je, te, theta, x


def close(got, want, rtol, atol, msg=""):
    def arr(a):
        return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    np.testing.assert_allclose(arr(got), arr(want), rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# Embedding nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fc", "cnn1d", "cnn2d", "cnn2d_c3"])
def test_embedding_parity(kind):
    jm, tm, x_shape = embedding_pair(kind)
    x = np.random.default_rng(1).standard_normal((9,) + x_shape).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm(torch.tensor(x))  # the lazy first layer takes its width
    used = load_flax_embedding(tm, np_tree(params)["params"])
    assert used == len(jax.tree_util.tree_leaves(params))
    close(tm(torch.tensor(x)), jm.apply(params, jnp.asarray(x)), 0, NET_ATOL)


def test_cnn_reads_channels_last():
    """The 2-D CNN reads a flat x as (H, W, C) and flattens its features
    channels last: permuting the flat input's channel axis changes the
    output, and the JAX package agrees on an (B, H, W, C) input too."""
    jm, tm, x_shape = embedding_pair("cnn2d_c3")
    x = np.random.default_rng(2).standard_normal((4, 8, 8, 3)).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    load_flax_embedding(tm, np_tree(params)["params"])
    close(tm(torch.tensor(x)), jm.apply(params, jnp.asarray(x)), 0, NET_ATOL)
    swapped = np.ascontiguousarray(np.moveaxis(x, -1, 1))
    assert not np.allclose(tm(torch.tensor(swapped)).detach().numpy(),
                           tm(torch.tensor(x)).detach().numpy(), atol=1e-3)


def test_embedding_shapes_and_identity():
    x = torch.randn(5, 4, 3)
    assert IdentityEmbedding()(x).shape == (5, 12)
    assert FCEmbedding(output_dim=6, num_layers=0)(x).shape == (5, 6)
    assert FCEmbedding(output_dim=6)(x).shape == (5, 6)
    # 1-D, odd length: each max-pool drops the remainder (31 -> 15 -> 7).
    cnn = CNNEmbedding(input_shape=(31,), out_channels_per_layer=(2, 3), output_dim=4)
    assert cnn.linears[0].in_features == 7 * 3 and cnn(torch.randn(2, 31)).shape == (2, 4)
    with pytest.raises(ValueError, match="1D or 2D"):
        CNNEmbedding(input_shape=(2, 2, 2))


@pytest.mark.parametrize("model", ["nsf", "maf"])
@pytest.mark.parametrize("embedding", ["fc", "cnn1d"])
def test_embeddings_in_flows(model, embedding):
    """The embedding nets serve as ``posterior_nn(embedding_net=...)``: the
    flow trains its weights with the conditioner's."""
    _, emb, x_shape = embedding_pair(embedding)
    theta, x = data(2, x_shape)
    est = posterior_nn(model, hidden_features=8, num_transforms=2, embedding_net=emb,
                       device="cpu")(theta, x)
    assert est.net.embedding_net is emb
    loss = est.loss(torch.tensor(theta[:8]), torch.tensor(x[:8])).mean()
    loss.backward()
    assert torch.isfinite(loss) and all(p.grad is not None for p in emb.parameters())
    samples = est.sample((3,), torch.tensor(x[:2]))
    assert samples.shape == (3, 2, 2) and bool(torch.isfinite(samples).all())


# ---------------------------------------------------------------------------
# Vector-field nets
# ---------------------------------------------------------------------------


def test_time_embedding_frequencies():
    """The port's frequencies are the float64 ones rounded to float32; the
    JAX package's float32 linspace and exp read within 1e-6 of them."""
    freqs = tvf.SinusoidalTimeEmbedding(32).freqs
    want = np.exp(np.linspace(0.0, np.log(1000.0), 16)).astype(np.float32)
    np.testing.assert_array_equal(freqs.numpy(), want)
    np.testing.assert_allclose(JAX_FREQS, want, rtol=1e-6)
    t = torch.tensor(TIMES)
    emb = with_jax_freqs(tvf.SinusoidalTimeEmbedding(32))(t)
    close(emb, jvf.SinusoidalTimeEmbedding(32).apply({}, jnp.asarray(TIMES)), 0, NET_ATOL)


@pytest.mark.parametrize("net", ["mlp", "ada_mlp"])
@pytest.mark.parametrize("embedding", [None, "cnn1d"])
def test_vector_field_net_parity(net, embedding):
    je, te, theta, x = vf_pair("fm", net=net, embedding=embedding)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((11, 2)).astype(np.float32)
    t = rng.uniform(0, 1, 11).astype(np.float32)
    c = np.asarray(je.condition_transform.forward(jnp.asarray(x[:11])))
    want = je.net.apply(je.params, jnp.asarray(z), jnp.asarray(c), jnp.asarray(t))
    got = te.net(torch.tensor(z), torch.tensor(c), torch.tensor(t))
    close(got, want, 0, NET_ATOL)
    # embed once, then the field: the same numbers
    close(te.net.field(torch.tensor(z), te.net.embed(torch.tensor(c))[:1].expand(11, -1),
                       torch.tensor(t)),
          je.net.apply(je.params, jnp.asarray(z), jnp.asarray(np.repeat(c[:1], 11, 0)),
                       jnp.asarray(t)), 0, NET_ATOL)


def test_builders_refuse_and_check():
    theta, x = data()
    with pytest.raises(NotImplementedError, match="later slice"):
        posterior_flow_nn(model="transformer", device="cpu")(theta, x)
    with pytest.raises(NotImplementedError, match="later slice"):
        posterior_score_nn(model="transformer", device="cpu")(theta, x)
    with pytest.raises(ValueError, match="transform_to_unconstrained"):
        posterior_flow_nn(z_score_theta="transform_to_unconstrained", device="cpu")(theta, x)
    with pytest.raises(ValueError, match="sde_type"):
        posterior_score_nn(sde_type="cosine", device="cpu")(theta, x)
    est = posterior_score_nn(z_score_theta="none", z_score_x="structured", device="cpu")(theta, x)
    assert type(est.input_transform).__name__ == "IdentityTransform"
    assert float(est.condition_transform.scale.std()) == 0.0  # one scalar scale
    # the VE default of NPSE, t_min 1e-3 for every score estimator
    assert type(est).__name__ == "VEScoreEstimator" and est.t_min == 1e-3
    assert (est.sigma_min, est.sigma_max) == (0.01, 10.0)
    vp = posterior_score_nn(sde_type="vp", device="cpu")(theta, x)
    assert (vp.beta_min, vp.beta_max) == (0.1, 20.0)
    assert list(vp.solve_schedule(3)) == pytest.approx([1.0, 0.5005, 1e-3])


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sde", ["vp", "subvp", "ve"])
def test_schedules(sde):
    je, te, _, _ = vf_pair(sde)
    t, jt = torch.tensor(TIMES), jnp.asarray(TIMES)
    z = np.random.default_rng(4).standard_normal((len(TIMES), 2)).astype(np.float32)
    for name in ("mean_t_fn", "std_fn"):
        close(getattr(te, name)(t), getattr(je, name)(jt), SCHED_RTOL, SCHED_ATOL, name)
    for name in ("drift_fn", "diffusion_fn"):
        got = getattr(te, name)(torch.tensor(z), t).expand(len(TIMES), 2)
        want = jnp.broadcast_to(getattr(je, name)(jnp.asarray(z), jt), (len(TIMES), 2))
        close(got, want, SCHED_RTOL, SCHED_ATOL, name)


@pytest.mark.parametrize("sde", ["vp", "subvp", "ve"])
@pytest.mark.parametrize("time", [1e-3, 0.4, 1.0])
def test_score_estimator_fields(sde, time):
    je, te, theta, x = vf_pair(sde, net="ada_mlp" if sde == "subvp" else "mlp")
    n = 10
    z = np.random.default_rng(5).standard_normal((n, 2)).astype(np.float32)
    cz = je.condition_transform.forward(jnp.asarray(x[:n]))
    tcz = te._embed_condition(torch.tensor(x[:n]))
    close(te.score_z_fn(torch.tensor(z), tcz, time), je.score_z_fn(je.params, jnp.asarray(z), cz, time),
          FIELD_RTOL, FIELD_ATOL, "score_z_fn")
    close(te.ode_z_fn(torch.tensor(z), tcz, time), je.ode_z_fn(je.params, jnp.asarray(z), cz, time),
          FIELD_RTOL, FIELD_ATOL, "ode_z_fn")
    close(te.ode_fn(torch.tensor(z), torch.tensor(x[:n]), time),
          je.ode_fn(je.params, jnp.asarray(z), jnp.asarray(x[:n]), time), FIELD_RTOL, FIELD_ATOL)
    # the score in raw theta space, at a (B,) time
    tb = np.full(n, time, np.float32)
    want = je.score(jnp.asarray(theta[:n]), jnp.asarray(x[:n]), jnp.asarray(tb))
    got = te.score(torch.tensor(theta[:n]), torch.tensor(x[:n]), torch.tensor(tb))
    close(got, want, RAW_SCORE_RTOL, FIELD_ATOL, "raw score")
    # embedded once: the samplers' path
    emb = te.embed_condition(tcz)
    close(te.score_z_fn(torch.tensor(z), emb, time, embedded=True),
          je.score_z_fn(je.params, jnp.asarray(z), cz, time), FIELD_RTOL, FIELD_ATOL)


@pytest.mark.parametrize("baseline", [False, True])
def test_flow_matching_fields(baseline):
    je, te, theta, x = vf_pair("fm", net="mlp", embedding="fc", gaussian_baseline=baseline)
    assert te.gaussian_baseline is baseline
    n = 10
    z = np.random.default_rng(6).standard_normal((n, 2)).astype(np.float32)
    for time in (0.0, 0.3, 0.999, 1.0):
        close(te.forward(torch.tensor(z), torch.tensor(x[:n]), time),
              je.forward(jnp.asarray(z), jnp.asarray(x[:n]), time), FIELD_RTOL, FIELD_ATOL)
        # the score conversion, 1 - t clipped at noise_scale = 1e-3
        close(te.score(torch.tensor(z), torch.tensor(x[:n]), time),
              je.score(jnp.asarray(z), jnp.asarray(x[:n]), time), RAW_SCORE_RTOL, FIELD_ATOL)
        cz = je.condition_transform.forward(jnp.asarray(x[:n]))
        close(te.score_z_fn(torch.tensor(z), te._embed_condition(torch.tensor(x[:n])), time),
              je.score_z_fn(je.params, jnp.asarray(z), cz, time), RAW_SCORE_RTOL, FIELD_ATOL)
    close(te.std_fn(torch.tensor(TIMES)), je.std_fn(jnp.asarray(TIMES)), SCHED_RTOL, SCHED_ATOL)


@pytest.mark.parametrize("kind", ["fm", "fm_baseline", "vp", "subvp", "ve"])
def test_losses_at_given_times(kind):
    """Both losses on the JAX package's own draws: its key split as the
    loss splits it, the noise passed to the port."""
    kw = {"gaussian_baseline": True} if kind == "fm_baseline" else {}
    je, te, theta, x = vf_pair("fm" if kind.startswith("fm") else kind, **kw)
    n, key = 16, jax.random.PRNGKey(11)
    times = np.random.default_rng(7).uniform(0.01, 0.99, n).astype(np.float32)
    want = je.loss_fn(je.params, jnp.asarray(theta[:n]), jnp.asarray(x[:n]), key,
                      times=jnp.asarray(times))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (n, 2)))
    got = te.loss(torch.tensor(theta[:n]), torch.tensor(x[:n]), times=torch.tensor(times),
                  noise=torch.tensor(noise))
    close(got, want, LOSS_RTOL, LOSS_ATOL)
    # drawn by the port: (B,) finite, and the gradient reaches every weight
    g = torch.Generator().manual_seed(0)
    loss = te.loss(torch.tensor(theta[:n]), torch.tensor(x[:n]), generator=g)
    loss.mean().backward()
    assert loss.shape == (n,) and bool(torch.isfinite(loss).all())
    assert all(p.grad is not None for p in te.net.parameters())


def test_condition_dropout_zeroes_rows():
    _, te, theta, x = vf_pair("vp")
    te.condition_dropout = 1.0 - 1e-7  # every row dropped
    n = 8
    times = torch.full((n,), 0.5)
    noise = torch.randn(n, 2, generator=torch.Generator().manual_seed(1))
    dropped = te.loss(torch.tensor(theta[:n]), torch.tensor(x[:n]), times=times, noise=noise)
    te.condition_dropout = 0.0
    z, _ = te.input_transform.forward_and_log_det(torch.tensor(theta[:n]))
    z_t = te.mean_t_fn(times)[:, None] * z + te.std_fn(times)[:, None] * noise
    eps_hat = te.net(z_t, torch.zeros(n, 3), times)
    close(dropped, ((eps_hat - noise) ** 2).mean(-1), 1e-6, 1e-7)
