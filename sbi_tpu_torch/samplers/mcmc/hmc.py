"""Hamiltonian Monte Carlo and NUTS over a batch of chains.

PyTorch counterpart of ``sbi_tpu/samplers/mcmc/hmc.py``: the leapfrog
integrator, HMC with an optionally jittered trajectory length, the
iterative-doubling multinomial NUTS (``run_nuts``), the jittered-length
surrogate (``run_nuts_jittered``), and the shared warmup (dual-averaging
step size, diagonal mass from an EMA of the chains' variance).

Differences from the JAX package, none of which changes what is computed:

- The chains are one (C, D) batch, not a ``vmap`` of a per-chain step. A
  leapfrog calls the potential once for all chains and takes the gradient
  with ``torch.autograd.grad`` of the sum of their values (the chains are
  independent, so row c of the gradient is chain c's).
- A chain's state carries its potential and gradient, so a step starts
  from them instead of evaluating the potential again, and the leapfrog
  keeps its last evaluation instead of repeating it.
- NUTS runs the chains in lockstep. Each doubling builds every live
  chain's subtree with 2^depth leapfrogs; a chain whose subtree turned or
  diverged, or whose trajectory stopped, keeps its state (``torch.where``)
  while the others go on (its leapfrogs run on, unread). The checkpoint
  slots follow the leaf index, which
  is the same for every chain, so their choice is host arithmetic. The host
  reads the device once per doubling after the first, to stop when every
  chain has stopped (``_all_done``): at most ``max_tree_depth - 1`` host
  syncs a step, none inside a subtree. Given the same draws, each chain
  builds the tree the JAX package's chain builds.
- The random draws (momenta, acceptance, trajectory lengths, NUTS's
  directions and multinomial picks) come from a ``torch.Generator``, not
  JAX's keys: the streams differ.
- ``max_sweeps_per_program`` bounds a compiled TPU program's length in the
  JAX package. Nothing is compiled here, so sampling runs as one loop (the
  same steps as any blocking of it), and the argument only rounds warmup
  up to whole blocks, for parity with the JAX package's equal chunks: 25
  warmup steps at 10 a block adapt for 30.
- The warmup keeps no EMA of the chains' mean: the JAX package computes
  one and never reads it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ...utils.sbiutils import next_generator

# Dual averaging (Hoffman & Gelman 2014), as ``_adaptive_warmup_chunk``.
_MU = math.log(10.0 * 0.1)
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75
_LOG_EPS0 = math.log(0.1)
_DIVERGENCE = -1000.0  # a NUTS leaf whose energy error is below this diverges


def _value_and_grad(potential_fn: Callable) -> Callable:
    """theta (C, D) -> (potential (C,), its gradient (C, D)), both
    detached; gradients are recorded here whatever the caller's mode."""

    def fn(theta):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            lp = potential_fn(th)
            if not lp.requires_grad:  # a potential that is constant in theta
                return lp, torch.zeros_like(th)
            (grad,) = torch.autograd.grad(lp.sum(), th)
        return lp.detach(), grad

    return fn


class _Draws:
    """The random draws of the steps, from one generator on the chains'
    device. Tests hand the steps another object with these methods to
    replay the JAX package's draws."""

    def __init__(self, generator: torch.Generator, num_chains: int, dim: int, device):
        self.g, self.C, self.D, self.device = generator, num_chains, dim, device

    def momentum(self):
        return torch.randn((self.C, self.D), generator=self.g, device=self.device)

    def accept(self):
        return torch.rand(self.C, generator=self.g, device=self.device)

    def num_steps(self, high: int):
        return torch.randint(1, high + 1, (self.C,), generator=self.g, device=self.device)

    def direction(self, depth: int):
        return torch.rand(self.C, generator=self.g, device=self.device) < 0.5

    def leaves(self, depth: int):
        return torch.rand((1 << depth, self.C), generator=self.g, device=self.device)

    def merge(self, depth: int):
        return torch.rand(self.C, generator=self.g, device=self.device)


def _leapfrog1(theta, mom, grad, half_eps, eps_inv_mass, logp_grad_fn):
    """One leapfrog step of every chain: (theta, mom, logp, grad)."""
    mom = torch.addcmul(mom, half_eps, grad)
    theta = torch.addcmul(theta, eps_inv_mass, mom)
    lp, grad = logp_grad_fn(theta)
    return theta, torch.addcmul(mom, half_eps, grad), lp, grad


def _leapfrog(theta, mom, grad, step_size, inv_mass, logp_grad_fn, num_steps, max_steps=None):
    """``num_steps`` leapfrog steps; returns (theta, mom, logp, grad).

    ``num_steps`` is an int, or a (C,) tensor of per-chain lengths, each
    from 1 to ``max_steps``: then every chain takes ``max_steps`` steps in
    lockstep, and a chain past its own length keeps its state."""
    per_chain = isinstance(num_steps, torch.Tensor)
    step_size = torch.as_tensor(step_size, dtype=theta.dtype, device=theta.device)
    half_eps = 0.5 * step_size
    eps_inv_mass = step_size * inv_mass
    lp = None
    for i in range(max_steps if per_chain else num_steps):
        th1, m1, lp1, g1 = _leapfrog1(theta, mom, grad, half_eps, eps_inv_mass, logp_grad_fn)
        if per_chain and i > 0:
            live = num_steps > i
            theta = torch.where(live[:, None], th1, theta)
            mom = torch.where(live[:, None], m1, mom)
            grad = torch.where(live[:, None], g1, grad)
            lp = torch.where(live, lp1, lp)
        else:
            theta, mom, lp, grad = th1, m1, lp1, g1
    if lp is None:
        lp, grad = logp_grad_fn(theta)
    return theta, mom, lp, grad


def _energy(lp, mom, inv_mass):
    """Negative Hamiltonian: logp - 0.5 * sum(inv_mass * mom^2), per chain."""
    return lp - 0.5 * (inv_mass * mom * mom).sum(-1)


def _momentum(draws, inv_mass):
    """Momenta N(0, M) with M = 1 / inv_mass."""
    return draws.momentum() * torch.sqrt(1.0 / inv_mass)


def _make_hmc_step(logp_grad_fn: Callable, num_leapfrog: int, jitter_steps: bool) -> Callable:
    """The HMC step of all chains: ``step(state, step_size, inv_mass,
    draws) -> (state, acceptance probability (C,))``, the state being
    (theta, logp, grad)."""

    def hmc_step(state, step_size, inv_mass, draws):
        theta, lp0, g0 = state
        mom = _momentum(draws, inv_mass)
        h0 = _energy(lp0, mom, inv_mass)
        u = draws.accept()
        if jitter_steps:
            # A length uniform in [1, num_leapfrog] per chain: randomized
            # HMC has the same stationary distribution and breaks resonances.
            n_steps = draws.num_steps(num_leapfrog)
        else:
            n_steps = num_leapfrog
        th1, m1, lp1, g1 = _leapfrog(theta, mom, g0, step_size, inv_mass, logp_grad_fn,
                                     n_steps, num_leapfrog)
        log_alpha = torch.clamp(_energy(lp1, m1, inv_mass) - h0, max=0.0)
        log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
        accept = torch.log(u) < log_alpha
        state = (torch.where(accept[:, None], th1, theta), torch.where(accept, lp1, lp0),
                 torch.where(accept[:, None], g1, g0))
        return state, torch.exp(log_alpha)

    return hmc_step


def _is_uturn(theta_later, theta_earlier, mom_later, mom_earlier, inv_mass):
    """Generalized U-turn criterion between the two ends of a trajectory
    segment (velocities v = M^-1 m; Hoffman & Gelman 2014, Eq. 9), over
    the last axis."""
    dtheta = theta_later - theta_earlier
    return ((dtheta * (inv_mass * mom_earlier)).sum(-1) < 0.0) | (
        (dtheta * (inv_mass * mom_later)).sum(-1) < 0.0)


def _all_done(done: torch.Tensor) -> bool:
    """Whether every chain's NUTS trajectory has stopped: the step's one
    host sync per doubling."""
    return bool(done.all())


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _build_subtree(edge, depth, direction, live0, h0, step_size, inv_mass, u_leaves,
                   logp_grad_fn, max_depth):
    """2^depth leapfrog steps of every chain from ``edge`` (theta, mom,
    grad) in ``direction`` (C,), with progressive multinomial sampling and
    the popcount-indexed checkpoint U-turn checks of ``run_nuts``. A chain
    counts only while it is live: in ``live0`` and before the leaf at
    which its subtree turns or diverges (the JAX package's loop stops
    there). Returns (new edge, (proposal, its logp, its grad), log weight,
    turned or diverged, sum of acceptance probabilities, number of leaves),
    per chain; the edge and proposal only matter where the subtree neither
    turned nor diverged."""
    th, m, g = edge
    eps = (direction * step_size)[:, None]
    half_eps, eps_inv_mass = 0.5 * eps, eps * inv_mass
    half_inv_mass = 0.5 * inv_mass
    log_u = torch.log(u_leaves)
    prop, prop_lp, prop_g = th, torch.zeros_like(h0), g
    log_w = torch.full_like(h0, -math.inf)
    s_alpha, n_alpha = torch.zeros_like(h0), torch.zeros_like(h0)
    live = live0
    ckpt_th = th.new_zeros((max_depth,) + tuple(th.shape))
    ckpt_v = th.new_zeros((max_depth,) + tuple(th.shape))  # velocities inv_mass * mom
    for n in range(1 << depth):
        # A chain that is not live runs on unmasked: nothing of it is read.
        th, m, lp, g = _leapfrog1(th, m, g, half_eps, eps_inv_mass, logp_grad_fn)
        # The energy error, a NaN as -inf: that leaf diverges, takes no
        # weight and adds no acceptance.
        w_leaf = torch.nan_to_num(torch.addmv(lp - h0, m * m, half_inv_mass, alpha=-1.0),
                                  nan=-math.inf)
        live_f = live.to(h0.dtype)
        s_alpha = torch.addcmul(s_alpha, torch.exp(torch.clamp(w_leaf, max=0.0)), live_f)
        n_alpha = n_alpha + live_f
        new_log_w = torch.logaddexp(log_w, w_leaf)
        take = live & (log_u[n] < w_leaf - new_log_w)
        prop = torch.where(take[:, None], th, prop)
        prop_lp = torch.where(take, lp, prop_lp)
        prop_g = torch.where(take[:, None], g, prop_g)
        log_w = torch.where(live, new_log_w, log_w)
        stop = w_leaf < _DIVERGENCE
        pc = _popcount(n)
        if n % 2 == 0:
            # An even leaf opens subtrees: its slot holds their left end.
            slot = min(pc, max_depth - 1)
            ckpt_th[slot] = th
            ckpt_v[slot] = inv_mass * m
        else:
            # An odd leaf with j trailing one-bits closes j subtrees, whose
            # left ends sit in slots popcount(n) - j .. popcount(n) - 1.
            j = _popcount(n & ~(n + 1))
            lo, hi = max(pc - j, 0), min(pc - 1, max_depth - 1)
            dtheta = th - ckpt_th[lo:hi + 1]
            turning = ((dtheta * ckpt_v[lo:hi + 1]).sum(-1) < 0.0) | (
                (dtheta * (inv_mass * m)).sum(-1) < 0.0)
            stop = stop | turning.any(0)
        live = live & ~stop
    return (th, m, g), (prop, prop_lp, prop_g), log_w, live0 & ~live, s_alpha, n_alpha


def _make_nuts_step(logp_grad_fn: Callable, max_depth: int) -> Callable:
    """The NUTS step of all chains in lockstep (see the module docstring):
    ``step(state, step_size, inv_mass, draws) -> (state, mean acceptance
    probability of each chain's leaves (C,))``."""

    def nuts_step(state, step_size, inv_mass, draws):
        theta, lp0, g0 = state
        mom = _momentum(draws, inv_mass)
        h0 = _energy(lp0, mom, inv_mass)
        minus = plus = (theta, mom, g0)
        prop = (theta, lp0, g0)
        log_w = torch.zeros_like(lp0)  # the root leaf's: h0 - h0
        s_alpha, n_alpha = torch.zeros_like(lp0), torch.zeros_like(lp0)
        done = torch.zeros_like(lp0, dtype=torch.bool)
        for depth in range(max_depth):
            if depth > 0 and _all_done(done):
                break
            forward = draws.direction(depth)
            direction = torch.where(forward, 1.0, -1.0)
            active = ~done
            edge = tuple(torch.where(forward[:, None], p, q) for p, q in zip(plus, minus))
            new_edge, prop_sub, log_w_sub, bad, sa, na = _build_subtree(
                edge, depth, direction, active, h0, step_size, inv_mass, draws.leaves(depth),
                logp_grad_fn, max_depth)
            s_alpha, n_alpha = s_alpha + sa, n_alpha + na
            # A turning or diverging subtree is rejected whole and stops
            # the doubling; otherwise it extends the trajectory.
            ok = active & ~bad
            grow_plus, grow_minus = (ok & forward)[:, None], (ok & ~forward)[:, None]
            plus = tuple(torch.where(grow_plus, new, old) for new, old in zip(new_edge, plus))
            minus = tuple(torch.where(grow_minus, new, old) for new, old in zip(new_edge, minus))
            # Biased progressive sampling across the doubling.
            take = ok & (torch.log(draws.merge(depth)) < log_w_sub - log_w)
            prop = (torch.where(take[:, None], prop_sub[0], prop[0]),
                    torch.where(take, prop_sub[1], prop[1]),
                    torch.where(take[:, None], prop_sub[2], prop[2]))
            log_w = torch.where(ok, torch.logaddexp(log_w, log_w_sub), log_w)
            full_turn = _is_uturn(plus[0], minus[0], plus[1], minus[1], inv_mass)
            done = done | (active & (bad | full_turn))
        return prop, s_alpha / torch.clamp(n_alpha, min=1.0)

    return nuts_step


# ---------------------------------------------------------------------------
# Warmup and sampling
# ---------------------------------------------------------------------------


def _initial_carry(state):
    """(state, log step size, its running average, h_bar, mass EMA, t)."""
    theta = state[0]
    log_eps = torch.full((), _LOG_EPS0, device=theta.device)
    return (state, log_eps, log_eps.clone(), torch.zeros((), device=theta.device),
            torch.ones(theta.shape[1], device=theta.device), 0.0)


def _adaptive_warmup_chunk(carry, target_accept, step_fn, n_steps, draws):
    """Advance the warmup carry by ``n_steps`` steps: one step size for all
    chains, adapted by dual averaging on the chains' mean acceptance, and
    the inverse mass from an EMA (0.9 / 0.1) of the chains' population
    variance + 1e-6, clipped at 1e-4. No host sync."""
    state, log_eps, log_eps_bar, h_bar, m2_var, t = carry
    for _ in range(n_steps):
        state, alphas = step_fn(state, torch.exp(log_eps), torch.clamp(m2_var, min=1e-4), draws)
        t = t + 1.0
        eta = 1.0 / (t + _T0)
        h_bar = (1.0 - eta) * h_bar + eta * (target_accept - alphas.mean())
        log_eps = _MU - math.sqrt(t) / _GAMMA * h_bar
        w = t ** (-_KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        batch_var = state[0].var(dim=0, correction=0) + 1e-6
        m2_var = 0.9 * m2_var + 0.1 * batch_var
    return state, log_eps, log_eps_bar, h_bar, m2_var, t


def _adaptive_warmup(state, target_accept, step_fn, warmup_steps, draws,
                     max_sweeps_per_program=None):
    """Warmup from ``state``; returns (state, step size, inverse mass)."""
    carry = _initial_carry(state)
    n = max(warmup_steps, 1)
    if max_sweeps_per_program is not None and n > max_sweeps_per_program:
        # Whole blocks, as the JAX package's compiled chunks (parity only):
        # steps beyond warmup_steps continue the (converging) adaptation.
        n = -(-n // max_sweeps_per_program) * max_sweeps_per_program
    carry = _adaptive_warmup_chunk(carry, target_accept, step_fn, n, draws)
    state, _, log_eps_bar, _, m2_var, _ = carry
    return state, torch.exp(log_eps_bar), torch.clamp(m2_var, min=1e-4)


def _adaptive_sample(state, step_size, inv_mass, step_fn, n_steps, draws, out):
    """``n_steps`` steps from ``state``, writing each step's theta into
    ``out[i]``; returns the last state."""
    for i in range(n_steps):
        state, _ = step_fn(state, step_size, inv_mass, draws)
        out[i] = state[0]
    return state


def _run_adaptive(step_fn, state, num_samples, thin, warmup_steps, target_accept, draws,
                  max_sweeps_per_program=None) -> torch.Tensor:
    """Warmup, then ``num_samples * thin`` recorded steps, every ``thin``-th
    kept: (num_samples, C, D). ``step_fn(state, step_size, inv_mass,
    draws) -> (state, acceptance (C,))`` advances all chains; state[0] is
    theta (C, D)."""
    state, step_size, inv_mass = _adaptive_warmup(
        state, target_accept, step_fn, warmup_steps, draws, max_sweeps_per_program)
    theta = state[0]
    n_total = num_samples * thin
    draws_out = theta.new_empty((n_total,) + tuple(theta.shape))
    _adaptive_sample(state, step_size, inv_mass, step_fn, n_total, draws, draws_out)
    if thin > 1:
        draws_out = draws_out[thin - 1::thin]
    return draws_out[:num_samples]


def _start(potential_fn, inits, generator):
    inits = torch.as_tensor(inits, dtype=torch.float32)
    logp_grad_fn = _value_and_grad(potential_fn)
    lp, grad = logp_grad_fn(inits)
    C, D = inits.shape
    draws = _Draws(next_generator(generator, inits.device), C, D, inits.device)
    return logp_grad_fn, (inits, lp, grad), draws


@torch.no_grad()
def run_hmc(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    inits: torch.Tensor,
    num_samples: int,
    thin: int = 1,
    warmup_steps: int = 200,
    num_leapfrog: int = 16,
    target_accept: float = 0.8,
    jitter_steps: bool = False,
    generator: Optional[torch.Generator] = None,
    max_sweeps_per_program: Optional[int] = None,
) -> torch.Tensor:
    """HMC of all chains at once; returns (num_samples, C, D).

    ``potential_fn``: (B, D) -> (B,) log density, differentiable; it runs
    on the device of ``inits`` (C, D)."""
    logp_grad_fn, state, draws = _start(potential_fn, inits, generator)
    step = _make_hmc_step(logp_grad_fn, int(num_leapfrog), bool(jitter_steps))
    return _run_adaptive(step, state, num_samples, thin, warmup_steps, target_accept, draws,
                         max_sweeps_per_program)


@torch.no_grad()
def run_nuts(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    inits: torch.Tensor,
    num_samples: int,
    thin: int = 1,
    warmup_steps: int = 200,
    max_tree_depth: int = 6,
    target_accept: float = 0.8,
    generator: Optional[torch.Generator] = None,
    max_sweeps_per_program: Optional[int] = None,
) -> torch.Tensor:
    """Tree-based multinomial NUTS with iterative doubling, all chains in
    lockstep (module docstring); returns (num_samples, C, D).

    Per step: doubling goes on to ``max_tree_depth``; each subtree of
    2^depth leaves is built leaf by leaf with progressive multinomial
    sampling. Sub-subtree U-turns use the popcount-indexed checkpoints
    (O(max_tree_depth) slots): leaf n (0-based, even) is stored at slot
    popcount(n); at odd leaf n with j trailing one-bits the U-turn is
    checked against slots popcount(n) - j .. popcount(n) - 1, the left ends
    of every complete subtree that ends at n. Divergences (energy error
    below -1000) reject the subtree."""
    logp_grad_fn, state, draws = _start(potential_fn, inits, generator)
    step = _make_nuts_step(logp_grad_fn, int(max_tree_depth))
    return _run_adaptive(step, state, num_samples, thin, warmup_steps, target_accept, draws,
                         max_sweeps_per_program)


def run_nuts_jittered(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    inits: torch.Tensor,
    num_samples: int,
    thin: int = 1,
    warmup_steps: int = 200,
    max_tree_depth: int = 6,
    target_accept: float = 0.8,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Jittered-trajectory multinomial HMC (the JAX package's round-1 NUTS
    surrogate, kept for cross-validation): ``run_hmc`` with lengths
    uniform in [1, 2^(max_tree_depth - 1)], the shorter chains masked."""
    return run_hmc(potential_fn, inits, num_samples, thin=thin, warmup_steps=warmup_steps,
                   num_leapfrog=int(2 ** (max_tree_depth - 1)), target_accept=target_accept,
                   jitter_steps=True, generator=generator)
