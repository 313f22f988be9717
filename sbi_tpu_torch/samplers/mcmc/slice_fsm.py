"""Batched-FSM vectorized slice sampler: one potential evaluation per iteration.

PyTorch counterpart of ``sbi_tpu/samplers/mcmc/slice_fsm.py``, itself the
reference's ``SliceSamplerVectorized`` state machine
(``sbi/samplers/mcmc/slice_numpy.py:353-620``). Every chain carries its own
phase: 0 = stepping out the lower end of its bracket, 1 = the upper end,
2 = shrinkage. Each iteration evaluates the potential once, for all chains
at their own proposal points, and moves each chain's state machine on by
one step. A chain that accepts (or runs out of shrink steps) moves to its
next coordinate and draws a new slice level and bracket at once; a chain
that finishes its last coordinate has finished a sweep, which is recorded
after ``n_skip`` sweeps.

How the GPU version differs from the TPU one:

- **The loop condition.** JAX runs the state machine as one
  ``lax.while_loop`` whose condition reads ``sweeps.min()`` on the device.
  In eager PyTorch a condition read on the host is a device-to-host sync,
  which would stall the host once per iteration. Here the iteration count
  is a Python int, and the loop runs in blocks of ``SYNC_EVERY`` iterations
  with no host sync inside; after each block one sync reads whether every
  chain has recorded its sweeps (``_all_recorded``). ``max_total`` is held
  exactly: the last block is shortened to it. Iterations past the point
  where the last chain finished are harmless to the draws, since recording
  is gated on ``sweeps < n_skip + n_record``: only the carried end state
  ``x`` moves on, as chains that finish early already do in JAX while they
  wait for the slowest one.
- **Per-chain reads and writes.** The TPU version writes every per-chain
  indexed access as a one-hot masked vector op (dynamic scatters serialize
  on the TPU). Here the coordinate read and write are a ``gather`` and a
  ``scatter`` by each chain's ``dim``, and the sample record reads, masks
  and writes only the (C, D) rows at ``[rec_idx, arange(C)]`` instead of
  rewriting the whole (n_record, C, D) buffer each iteration.
- **No program cache.** JAX keeps one compiled program per potential;
  eager PyTorch has nothing to compile, so the chunked mode
  (``max_sweeps_per_program``) takes a short last chunk rather than a full
  one.
- **No autograd.** Every entry point runs under ``torch.no_grad()``: a
  potential built on an estimator whose parameters require grad would
  otherwise record a graph in every iteration, and the spline would go
  through its ``autograd.Function`` instead of straight to the kernel.

The random draws follow JAX's: per iteration one uniform per chain for the
shrinkage proposal, and one exponential (the slice level) and one uniform
(the bracket's position) per chain, used where a chain starts a new
coordinate. They come from one ``torch.Generator`` on the chains' device,
``DRAW_BLOCK`` iterations at a time; draws are not comparable across
frameworks, so parity with JAX is statistical.

An iteration is ~55 elementwise, gather and scatter ops on (C,) and (C, D)
tensors besides the potential; in eager PyTorch each is a launch and some
host time, which is what an iteration costs at the sizes of the MCMC
path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ...utils.sbiutils import next_generator

_LOWER, _UPPER, _SHRINK = 0, 1, 2

# Iterations per block between two reads of the loop condition on the host.
# A larger block saves syncs and may run up to SYNC_EVERY - 1 iterations past
# the last chain's final sweep (each one potential evaluation).
SYNC_EVERY = 32
# Iterations whose random draws are taken from the generator at once.
DRAW_BLOCK = 32


class _Draws:
    """Per iteration and chain: a uniform for the shrinkage proposal, an
    exponential for a new slice level and a uniform for a new bracket's
    position. Drawn ``DRAW_BLOCK`` iterations at a time (three ops a block
    rather than three an iteration), independently of ``SYNC_EVERY``."""

    def __init__(self, generator, C: int, device):
        self.generator, self.C, self.device = generator, C, device
        self.i = DRAW_BLOCK

    def next(self):
        if self.i == DRAW_BLOCK:
            self.u = torch.rand((DRAW_BLOCK, 3, self.C), generator=self.generator,
                                device=self.device)
            self.e = -torch.log1p(-self.u[:, 1])
            self.i = 0
        i = self.i
        self.i += 1
        return self.u[i, 0], self.e[i], self.u[i, 2]


class _Chains:
    """The state machine's carry for C chains in D dimensions. ``dim`` is a
    (C, 1) column, ``w`` the slice width of each chain's coordinate, and
    ``rec`` counts finished sweeps from 1 - n_skip: a sweep that finishes at
    rec in [1, n_record] is recorded in row rec of ``samples``, whose rows 0
    and n_record + 1 take every other write and are dropped."""

    __slots__ = ("x", "lp", "dim", "w", "phase", "log_y", "lx", "ux", "iters", "rec",
                 "samples", "chain_idx")


def _fsm_iteration(s: _Chains, potential_fn, widths, draws: _Draws, n_record: int,
                   max_steps_out: int, max_shrink: int) -> None:
    """One step of every chain's state machine, with one potential
    evaluation; updates ``s`` in place and reads nothing back to the host.

    Each chain does exactly one of: expand its bracket (phase 0 or 1, above
    the slice), advance to the next phase (0 or 1, below it), accept
    (phase 2, above), shrink (phase 2, below) or cap out (phase 2, below,
    ``max_shrink`` shrinks done)."""
    u, e, u_bracket = draws.next()
    lx, ux, phase, iters, w = s.lx, s.ux, s.phase, s.iters, s.w
    prop = torch.addcmul(lx, ux - lx, u)  # shrinkage proposal
    # The point each chain evaluates: its lower end, its upper end, or prop.
    eval_col = torch.stack((lx, ux, prop), 1).gather(1, phase[:, None])
    x_eval = s.x.gather(1, s.dim)[:, 0]  # the current coordinate value
    x_eval_full = s.x.scatter(1, s.dim, eval_col)
    lp_eval = potential_fn(x_eval_full)  # the one batched evaluation
    above = lp_eval > s.log_y

    stepping = phase < _SHRINK
    expand = stepping & above & (iters < max_steps_out)
    advance = stepping ^ expand
    shrinking = ~stepping
    accept = shrinking & above
    miss = shrinking ^ accept
    capped = miss & (iters >= max_shrink)
    shrink_more = miss ^ capped
    expand_l = expand & (phase == _LOWER)
    expand_u = expand ^ expand_l
    shrink_l = shrink_more & (prop < x_eval)
    shrink_u = shrink_more ^ shrink_l
    new_lx = torch.where(shrink_l, prop, lx - w * expand_l)
    new_ux = torch.where(shrink_u, prop, ux + w * expand_u)

    # Coordinate update on accept; a capped chain keeps its point.
    new_x = torch.where(accept[:, None], x_eval_full, s.x)
    new_lp = torch.where(accept, lp_eval, s.lp)
    done = accept | capped
    finished = done & (s.dim[:, 0] == s.x.shape[1] - 1)

    # Record finished sweeps: one write per chain, out of range into the
    # rows that are dropped.
    row = torch.where(finished, s.rec.clamp(0, n_record + 1), 0)
    s.samples.index_put_((row, s.chain_idx), new_x)
    s.rec = s.rec + finished

    # Transitions (LOWER -> UPPER -> SHRINK is phase + 1), then a new slice
    # level and bracket where a coordinate is done.
    new_dim = torch.where(finished[:, None], 0, s.dim + done[:, None])
    s.phase = torch.where(done, _LOWER, phase + advance)
    s.iters = torch.where(done | advance, 0, iters + 1)
    s.w = widths[new_dim[:, 0]]
    lx_n = torch.addcmul(new_x.gather(1, new_dim)[:, 0], u_bracket, s.w, value=-1.0)
    s.log_y = torch.where(done, new_lp - e, s.log_y)
    s.lx = torch.where(done, lx_n, new_lx)
    s.ux = torch.where(done, lx_n + s.w, new_ux)
    s.x, s.lp, s.dim = new_x, new_lp, new_dim


def _all_recorded(sweeps: torch.Tensor, target: int) -> bool:
    """The loop condition: whether every chain's sweep count has reached
    ``target``. The sampler's one host sync per block."""
    return int(sweeps.min()) >= target


def _fsm_phase(potential_fn, generator, widths, inits, n_record: int, n_skip: int,
               max_steps_out: int, max_shrink: int, max_total: int):
    """One FSM phase: record ``n_record`` sweeps per chain after skipping
    ``n_skip``, in at most ``max_total`` iterations. Returns the
    (n_record, C, D) draws and the chains' end points."""
    C, D = inits.shape
    device = inits.device
    draws = _Draws(generator, C, device)
    s = _Chains()
    s.x = inits
    s.lp = potential_fn(inits)
    s.dim = torch.zeros((C, 1), dtype=torch.long, device=device)
    s.w = widths[s.dim[:, 0]]
    _, e, u_bracket = draws.next()
    s.log_y = s.lp - e
    s.lx = torch.addcmul(inits[:, 0], u_bracket, s.w, value=-1.0)
    s.ux = s.lx + s.w
    s.phase = torch.full((C,), _LOWER, dtype=torch.long, device=device)
    s.iters = torch.zeros(C, dtype=torch.long, device=device)
    s.rec = torch.full((C,), 1 - n_skip, dtype=torch.long, device=device)
    s.samples = torch.zeros((n_record + 2, C, D), device=device)
    s.chain_idx = torch.arange(C, device=device)

    it_total = 0
    while it_total < max_total:
        block = min(SYNC_EVERY, max_total - it_total)
        for _ in range(block):
            _fsm_iteration(s, potential_fn, widths, draws, n_record, max_steps_out, max_shrink)
        it_total += block
        if _all_recorded(s.rec, n_record + 1):
            break
    return s.samples[1:n_record + 1], s.x


def _per_sweep_cap(D: int, max_steps_out: int, max_shrink: int) -> int:
    """The iterations one sweep may take: per coordinate both step-outs, the
    shrink steps and a few transitions."""
    return D * (2 * max_steps_out + max_shrink + 4)


def _tuned_widths(warm: torch.Tensor) -> torch.Tensor:
    """Twice the population std (ddof 0, as ``jnp.std``) of the recorded
    warmup draws per dimension, + 1e-3."""
    return 2.0 * warm.reshape(-1, warm.shape[-1]).std(dim=0, correction=0) + 1e-3


def _initial_widths(init_width, D: int, device) -> torch.Tensor:
    """(D,) widths from a number (filled on the device: a copy from the host
    would be a sync) or from a tensor."""
    if isinstance(init_width, (int, float)):
        return torch.full((D,), float(init_width), device=device)
    width = torch.as_tensor(init_width, dtype=torch.float32).to(device)
    return torch.broadcast_to(width, (D,)).clone()


class SliceFSMState(NamedTuple):
    """Carried chain state: positions (C, D) and slice widths (D,)."""

    x: torch.Tensor
    widths: torch.Tensor


@torch.no_grad()
def slice_fsm_advance(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    state: SliceFSMState,
    num_sweeps: int,
    max_steps_out: int = 50,
    max_shrink: int = 100,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, SliceFSMState]:
    """Advance warmed chains by ``num_sweeps`` sweeps. Returns ``(draws,
    new_state)`` with draws of shape (num_sweeps, C, D); thinning is the
    caller's concern."""
    generator = next_generator(generator, state.x.device)
    cap = (num_sweeps + 1) * _per_sweep_cap(state.x.shape[1], max_steps_out, max_shrink)
    draws, x_new = _fsm_phase(potential_fn, generator, state.widths, state.x, num_sweeps, 0,
                              max_steps_out, max_shrink, cap)
    return draws, SliceFSMState(x=x_new, widths=state.widths)


@torch.no_grad()
def slice_fsm_warmup(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    inits: torch.Tensor,
    warmup_steps: int = 200,
    init_width=1.0,
    max_steps_out: int = 50,
    max_shrink: int = 100,
    tune_width: bool = True,
    generator: Optional[torch.Generator] = None,
    max_sweeps_per_program: Optional[int] = None,
) -> SliceFSMState:
    """Warm up C chains and return resumable state.

    ``warmup_steps`` sweeps run at the initial widths; the second half
    (``max(warmup_steps // 2, 1)`` sweeps) is recorded and the widths are
    tuned from it. With ``warmup_steps <= 0`` the widths stay at their start
    (an empty warmup has no std to tune from). With
    ``max_sweeps_per_program`` below ``warmup_steps`` the warmup runs in
    chunks of at most that many sweeps, every sweep recorded and the split
    applied afterwards.
    """
    inits = torch.as_tensor(inits, dtype=torch.float32)
    generator = next_generator(generator, inits.device)
    C, D = inits.shape
    widths0 = _initial_widths(init_width, D, inits.device)
    if warmup_steps <= 0:
        return SliceFSMState(x=inits, widths=widths0)
    n_warm_record = max(warmup_steps // 2, 1)
    n_warm_skip = warmup_steps - n_warm_record
    chunk = max_sweeps_per_program
    if chunk is not None and warmup_steps > chunk:
        state = SliceFSMState(x=inits, widths=widths0)
        parts = []
        for start in range(0, warmup_steps, chunk):
            draws_c, state = slice_fsm_advance(
                potential_fn, state, min(chunk, warmup_steps - start),
                max_steps_out=max_steps_out, max_shrink=max_shrink, generator=generator,
            )
            parts.append(draws_c)
        warm, x_cur = torch.cat(parts)[n_warm_skip:], state.x
    else:
        warm_cap = (n_warm_record + 1) * 2 * _per_sweep_cap(D, max_steps_out, max_shrink)
        warm, x_cur = _fsm_phase(potential_fn, generator, widths0, inits, n_warm_record,
                                 n_warm_skip, max_steps_out, max_shrink, warm_cap)
    widths = _tuned_widths(warm) if tune_width else widths0
    return SliceFSMState(x=x_cur, widths=widths)


@torch.no_grad()
def run_slice_vectorized_fsm(
    potential_fn: Callable[[torch.Tensor], torch.Tensor],
    inits: torch.Tensor,
    num_samples: int,
    thin: int = 1,
    warmup_steps: int = 200,
    init_width=1.0,
    max_steps_out: int = 50,
    max_shrink: int = 100,
    tune_width: bool = True,
    generator: Optional[torch.Generator] = None,
    max_sweeps_per_program: Optional[int] = None,
) -> torch.Tensor:
    """Run C chains; return (num_samples, C, D) draws after warmup and
    thinning (``draws[thin - 1::thin]`` of the recorded sweeps).

    ``potential_fn`` maps (C, D) to (C,) log densities. ``generator`` lies
    on the device of ``inits``. ``max_sweeps_per_program`` splits the warmup
    and the recording sweeps into runs of at most that many sweeps, with the
    chains' state carried between them (``slice_fsm_warmup`` /
    ``slice_fsm_advance``); thinning then applies to the joined stream.
    """
    inits = torch.as_tensor(inits, dtype=torch.float32)
    generator = next_generator(generator, inits.device)
    state = slice_fsm_warmup(
        potential_fn, inits, warmup_steps=warmup_steps, init_width=init_width,
        max_steps_out=max_steps_out, max_shrink=max_shrink, tune_width=tune_width,
        generator=generator, max_sweeps_per_program=max_sweeps_per_program,
    )
    n_total = num_samples * thin
    chunk = max_sweeps_per_program or n_total
    parts = []
    for start in range(0, n_total, chunk):
        draws_c, state = slice_fsm_advance(
            potential_fn, state, min(chunk, n_total - start), max_steps_out=max_steps_out,
            max_shrink=max_shrink, generator=generator,
        )
        parts.append(draws_c)
    draws = torch.cat(parts) if len(parts) > 1 else parts[0]
    if thin > 1:
        draws = draws[thin - 1::thin]
    return draws[:num_samples]
