#!/usr/bin/env python3
"""Smoke test of sbi_tpu_torch on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the RQ-spline CUDA kernels (the spline in both directions and its
backward) from ``sbi_tpu_torch/csrc/rqs.cu`` and holds them against their
plain PyTorch versions: values against ``rational_quadratic_spline_plain``,
gradients against autograd through it, edge cases included, and a stress
case against float64. Then it drives the port's main path through its
public entry points:

- serving: an SLCP posterior at full width (5 coupling transforms, hidden
  50, 10 bins) that answers ``sample``, ``log_prob``, ``sample_batched``
  and ``leakage_correction``, and a two_moons posterior (autoregressive
  branch); weights random, from ``--seed``, each head perturbed so the
  splines are far from the identity;
- training: SLCP NPE at full width on 10,000 simulations for a few epochs
  (steps/s, the device-busy share of a step and the spline kernels' share
  of it), two_moons NPE trained to early stopping and scored by C2ST
  against the reference posteriors in ``tests/mini_sbibm/files``, and a
  2-round SNPE-C run on two_moons, and the four-line recipe with its
  defaults (a MAF, on cuda);
- NLE and MCMC: the vectorized slice sampler on bench.py's headline target
  (1,000 chains on a 5-D correlated Gaussian: samples/s, FSM iterations,
  host syncs, and the effect of the sync block's length) and on SLCP's
  exact likelihood (C2ST against ``slcp_ref.npz``); SLCP NLE at full width
  (training steps/s, then 1,000 chains through the NSF likelihood:
  samples/s, the device-busy share, and five forward launches per potential
  evaluation); two_moons NLE trained to early stopping and scored by C2ST;
  ``MCMCPosterior.sample_batched`` over 8 observations, and
  ``DirectPosterior.sample_batched``'s MCMC fill of starved observations;
- ensembles: the spline's vmap rule (the TPU kernel's ``custom_vmap``
  merge) at the ensemble step's shape, one launch per vmapped call and bit
  for bit the members' separate calls (checked and timed with the kernels,
  before the main paths); npe-nsf-ens8 at full width
  (gaussian_linear, 30,000 simulations, 8 NSF members trained by
  ``train_ensemble`` as one vmapped step: a deterministic step check
  against single-model steps, ensemble and member steps/s, 5 + 5 spline
  launches a step, the mixture posterior's C2ST against
  ``gaussian_linear.npz``, ``sample_batched``, ``log_prob`` and
  ``weight_by_evidence``); an SLCP NLE product of experts of 4 members
  sampled by 1,000 slice chains (samples/s, no host sync inside a block,
  five launches per potential evaluation for all members);
- the MDN family, which reaches no kernel and must launch none: NPE with
  an MDN on the 10-D linear Gaussian (BASELINE config 1: C2ST per
  observation against the analytic posterior, gated on the mean and on
  each beside a control scored in the same run, train steps/s, ``sample``
  and ``log_prob`` rates, ``MoG.sample`` with every host sync refused), an
  ensemble of MDNs, two rounds of NPE-C with the non-atomic MoG loss (one
  step with every host sync refused) and two rounds of NPE-A;
- vector fields, which reach no kernel and must launch none: FMPE and
  NPSE-VE on the 2-D linear Gaussian (C2ST against the analytic posterior,
  ``log_prob``, ``sample_batched``, ODE sampling), FMPE with a CNN
  embedding on a 32-D x (BASELINE config 4: C2ST gated beside a control,
  train steps/s, the device-busy share of an epoch, ODE sample and
  ``log_prob`` rates, a training step, diffusion steps and RK4 steps with
  every host sync refused), and bench.py's ``diffuser_sampling`` (500
  reverse-SDE steps for 1,024 samples: samples/s, host us a step, device
  operations a step, the busy share);
- the NRE family, which reaches no kernel and must launch none: two_moons
  NRE_B at the round-2 recipe (30,000 simulations, a ResNet classifier,
  10 atoms; train steps/s and the busy share of an epoch), observations
  0-2 by ``MCMCPosterior.sample_batched`` scored by C2ST beside a control
  that must fail the gate, ``nre_slice_samples_per_sec`` (1,000 chains
  through the classifier: host us and device operations an FSM
  iteration), ``sample_with="rejection"`` and ``"importance"`` on the same
  ratio (C2ST, acceptance rate, ESS, PSIS k-hat; the rejection ascent with
  every host sync refused); NRE_A, NRE_C and BNRE on the 2-D linear
  Gaussian (the JAX package's slow tests); two rounds of SNRE_B; an NRE_B
  ensemble whose potential must take the stacked (one-vmap) route, with
  one ensemble step with every host sync refused.

Every phase prints one JSON line; any failure raises and the script exits
non-zero. The kernel launch counters are zeroed just before the main path
and read just after, and the path fails unless every kernel was launched.
The last two lines are the ``kernels`` summary and ``{"ok": true,
"device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
REPLACES = "sbi_tpu/ops/rqs_pallas.py:137"
# The backward replaces _bwd, the jax.vjp of the jnp reference (XLA, not
# Pallas) that the TPU kernel's custom_vjp takes its gradients from.
REPLACES_BACKWARD = "sbi_tpu/ops/rqs_pallas.py:229"
SOURCE = "sbi_tpu_torch/csrc/rqs.cu"
# The TPU kernel's custom_vmap merge, ported as the vmap rules of the
# spline's autograd Functions: a vmapped call launches these kernels once.
VMAP_RULE = "sbi_tpu/ops/rqs_pallas.py:180"
# Tolerances of kernel vs plain version, at spline parameters of std 0.3
# (wider than the main path's conditioners give). Both compute in float32;
# the softmax sums and cumulative knots are summed in another order, so
# knots differ by a few ulp of tail_bound. An input within that distance of
# a knot may fall in the neighbouring bin, which moves y and log|det| only
# by rounding because the spline is C1 across knots.
PARAM_STD = 0.3
Y_ATOL, Y_RTOL, LD_ATOL = 1e-5, 1e-5, 1e-4
# Stress case, parameters of std 1: some bins are ~500x steeper than wide,
# and a knot that moves by one ulp moves y by ~1e-4 in any float32
# implementation. There the kernel is held to the plain version run in
# float64: its error may be at most STRESS_FACTOR times the float32 plain
# version's own error (+ 1e-6).
STRESS_FACTOR = 4.0
# From K = 64 on, bins are 2B/K wide and a knot sums up to K float32 terms,
# so the log-det of two float32 versions differs by more than LD_ATOL
# (2.3e-4 between kernel and plain at K = 64, std 0.3). Those cases are
# held to float64 as the stress case is.
LARGE_K = 64
# Backward kernel vs autograd through the plain version, same inputs and
# fixed random upstream gradients, at PARAM_STD. d log|det| / dx is a
# difference of terms of order 10 (the spline's second derivative over its
# first), so float32 rounding of the knots leaves ~1e-4 absolute there;
# large gradients (up to ~100) differ by ~5e-5 relative.
GRAD_ATOL, GRAD_RTOL = 1e-3, 1e-4
# The gradient of log|det| jumps across a knot (the spline is C1, not C2),
# and two float32 versions' knots differ by a few ulp, so at an input that
# close to a knot they may take neighbouring bins. Elements within KNOT_GAP
# of a knot (float32 plain knots; float64 ones where held to float64) are
# held to finiteness only, and counted.
KNOT_GAP = 1e-4
# Where gradients are held to float64 (the stress case, K >= LARGE_K), the
# rule of STRESS_FACTOR applies at this quantile of each gradient's errors.
GRAD_QUANTILE = 0.999
ROUND_TRIP_ATOL = 1e-3  # noise -> data -> noise through 5 spline layers
SAMPLE_LP_ATOL = 1e-3  # single-pass sample_and_log_prob vs log_prob
# Kernel timing sizes, (conditioner rows, transformed dims) at K = 10: one
# 10,000-row proposal batch of two_moons (2) and of SLCP's couplings (3),
# a 100,000-row log_prob of SLCP, and one potential evaluation of 1,000
# MCMC chains through SLCP's NLE likelihood (4 of x's 8 dims per coupling).
TIMING_SIZES = ((10_000, 2), (10_000, 3), (100_000, 3), (1_000, 4))
# The backward's sizes: a training batch of SLCP's couplings (200 x 3), an
# atomic-loss batch of two_moons (200 rows x 10 atoms x 2), and the
# 100,000 x 3 of the forward's largest size.
BACKWARD_SIZES = ((200, 3), (2_000, 2), (100_000, 3))
# two_moons C2ST bar after NPE-NSF on 10,000 simulations (sbi_tpu read
# 0.5319 mean there, bm_results_round2.csv, with sklearn's C2ST).
C2ST_MEAN_MAX, C2ST_EACH_MAX = 0.60, 0.65
FLUSH_BYTES = 2 * 50 * 10**6  # twice the 50 MB L2, written before a cold call
# Vectorized slice sampling, bench.py's headline (bench.py:40-92): 1,000
# chains on a 5-D Gaussian with correlation 0.5, warmup 50, 100 samples a
# chain. The draws' mean must be within 0.1 of 0 per coordinate and their
# covariance within 0.1 of the target's.
SLICE_CHAINS, SLICE_DIM, SLICE_WARMUP, SLICE_SAMPLES, SLICE_RHO = 1_000, 5, 50, 100, 0.5
SLICE_MEAN_ATOL, SLICE_COV_ATOL = 0.1, 0.1
# SLCP's exact likelihood, as tests/test_fixture_equivalence.py samples it:
# 100 chains, warmup 300, 40 samples a chain, thin 4; C2ST of the first
# 1,000 draws against 1,000 reference samples, below 0.6 per observation.
SLCP_CHAINS, SLCP_WARMUP, SLCP_PER_CHAIN, SLCP_THIN, SLCP_C2ST_MAX = 100, 300, 40, 4, 0.6
# NLE on SLCP (bench.py:124-126): 1,000 chains, warmup 10, 5 samples a chain.
NLE_CHAINS, NLE_WARMUP, NLE_SAMPLES = 1_000, 10, 5
# two_moons NLE-NSF on 10,000 simulations, at most 60 epochs, 100 chains,
# warmup 100 (tests/test_bm.py:135-136), 5,000 draws against 5,000
# reference samples per observation. sbi_tpu's single-round NLE read 0.5842 mean
# (bm_results_round1.csv:6: 2,000 simulations, the default MAF, sklearn's
# C2ST), another budget and classifier: a reference point, not the bar.
NLE_C2ST_MEAN_MAX, NLE_C2ST_EACH_MAX = 0.62, 0.68
# sample_batched's column b against sample() at observation b, 1,000 draws a
# side, one per chain: C2ST at most 0.6 (about 4 standard deviations above
# 0.5 for 400 held-out points; another observation's draws read near 1).
BATCHED_C2ST_MAX = 0.6
# Ensembles. npe-nsf-ens8 (scripts/bm_round5.py:376-413): gaussian_linear
# (10-D), 30,000 simulations, posterior_nn("nsf", hidden_features=100,
# num_transforms=5, interleave_affine=True), 8 members trained as one vmapped
# step, batch 200 (135 steps an epoch). The cut is epochs, never width or
# members: at most ENS_EPOCHS (the members' validation loss was lowest at
# epoch 2 or 3 in runs of 8 and 20 epochs on the H100, and rose after).
# sbi_tpu read C2ST 0.5111 there after full training (bm_results_round5.csv,
# n = 4,000, sklearn's C2ST); the bar here is the mixture's mean over
# observations 0-2 of gaussian_linear.npz, 4,000 draws a side.
ENS_MEMBERS, ENS_SIMS, ENS_HIDDEN, ENS_BATCH, ENS_EPOCHS = 8, 30_000, 100, 200, 5
ENS_C2ST_MEAN_MAX, ENS_C2ST_EACH_MAX, ENS_DRAWS = 0.60, 0.65, 4_000
ENS_PROFILED_STEPS = 20
# One vmapped step from a common start against each member's own
# single-model step on the same batch. The spline's per-element math does
# not depend on the launch, but the conditioners' GEMMs run batched (one
# bmm for all members) against one mm a member, which sums in another
# order: losses within 1e-5 relative, each gradient tensor within 1e-4 of
# its largest element. Adam's first step moves an element by ~lr * sign(g),
# so an element whose gradient is at the rounding noise may move either
# way: parameters after the step within 2 lr, and 99% of elements within
# 1e-6.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_PARAM_TIGHT, STEP_TIGHT_SHARE = 1e-5, 1e-4, 1e-6, 0.99
# SLCP NLE-NSF product of experts (the nle-*-poe16 family of
# bm_round5.py, cut to 4 members and 10,000 simulations): full width
# (hidden 50, 5 transforms), a few epochs, then the nle_slcp sampling
# configuration.
POE_MEMBERS, POE_SIMS, POE_EPOCHS = 4, 10_000, 3
# The MDN family. BASELINE config 1 at tests/test_linear_gaussian_npe.py:127-151:
# 10-D linear Gaussian (shift -1, covariance 0.3 I, prior N(0, I)), 10,000
# simulations, posterior_nn("mdn", num_components=5, hidden_features=100),
# batch 200, to patience (capped at MDN_MAX_EPOCHS). The data, the
# observations (x_o = 0 and two x drawn from the simulator) and MDN_DRAWS
# draws from the analytic posterior at each are drawn with numpy from
# --seed (mdn_data), so scripts/mdn_10d_jax_vs_torch.py trains the JAX
# package on the same inputs. C2ST (c2st_torch) per observation, printed
# beside that test's 0.62 (0.5 + 0.12) and the 0.55 north star; neither
# package meets 0.62 at the second simulated x, a tail draw of the
# simulator (squared Mahalanobis distance 21.6 against 10 on average;
# SBI_TPU_MDN_10D). The control is the analytic posterior with its mean
# moved by MDN_CONTROL_SHIFT_SD posterior standard deviations in every
# coordinate, scored in the same run. MDN_C2ST_MEAN_GATE, on the mean over
# the observations, lies between the JAX package's worst mean (0.6867) and
# the control's, and the control must fail it: moved by 0.5 sd, it read a
# mean of 0.752-0.798 on an H100, too near the gate for that check to hold
# in every run. MDN_C2ST_EACH_GATE, on each, lies above the JAX package's
# worst single reading (0.7825) and catches a broken observation. Then tests/test_linear_gaussian_npe.py:94-124
# on 2-D (two rounds of 1,200 simulations, MDN net and proposal, the
# non-atomic loss): C2ST at most 0.65; NPE-A on the same task (1 component,
# then 10); and an ensemble of MDN_MEMBERS MDNs on the 10-D data for
# MDN_ENS_EPOCHS epochs.
MDN_DIM, MDN_SIMS, MDN_COMPONENTS, MDN_HIDDEN, MDN_BATCH = 10, 10_000, 5, 100, 200
MDN_SHIFT, MDN_LIK_VAR = -1.0, 0.3
MDN_MAX_EPOCHS, MDN_C2ST_EACH_MAX, MDN_C2ST_NORTH_STAR, MDN_DRAWS = 200, 0.62, 0.55, 1_000
MDN_C2ST_MEAN_GATE, MDN_C2ST_EACH_GATE, MDN_CONTROL_SHIFT_SD = 0.74, 0.85, 0.75
MDN_RATE_DRAWS = 100_000
MOG_ROUND_SIMS, MOG_C2ST_MAX = 1_200, 0.65
MDN_MEMBERS, MDN_ENS_EPOCHS = 4, 3
# The JAX package on mdn_data(0) over 12 initialisations, on the CPU, by
# c2st_torch: per observation the mean, least and most, and the most of the
# mean over the observations; the mean by sklearn's C2ST beside them.
SBI_TPU_MDN_10D = {"c2st_mean": [0.5923, 0.6150, 0.7231], "c2st_min": [0.5575, 0.5625, 0.6300],
                   "c2st_max": [0.6325, 0.6750, 0.7825], "c2st_mean_over_observations_max": 0.6867,
                   "sklearn_c2st_mean": [0.5728, 0.5884, 0.6910], "initialisations": 12,
                   "source": "scripts/mdn_10d_jax_vs_torch.py --inits 6, then --first-init 6 --inits 6"}
SBI_TPU_NLE_TWO_MOONS = {"c2st_mean": 0.5842, "c2st": [0.5535, 0.6445, 0.5545],
                         "simulations": 2000, "density_estimator": "maf",
                         "classifier": "sklearn", "source": "bm_results_round1.csv:6"}
# Vector fields. tests/test_vector_field.py:18-54: the 2-D linear Gaussian
# (shift -1, covariance 0.3 I, prior N(0, I)), 3,000 simulations, batch 100,
# stop_after_epochs 30 (capped here at VF_MAX_EPOCHS), 1,000 draws at
# x_o = 0 scored by C2ST against as many analytic-posterior draws, gated
# at that test's 0.62 (0.5 + 0.12) for FMPE and NPSE-VE; log_prob of 20
# reference draws; sample_batched over three observations in 100 steps.
# BASELINE config 4 (tests/test_vector_field.py:218-265): D = 2, x = A theta
# + 0.3 + N(0, I) with a 32 x 2 sinusoidal design A, 4,000 simulations,
# CNNEmbedding(input_shape=(32,), output_dim=16, out_channels_per_layer=(32,
# 64), num_linear_units=100), hidden 128, batch 200, patience 30, at most
# 300 epochs; C2ST at x_o = 0.3 (theta = 0) gated at that test's 0.65 (0.5
# + 0.15), beside a control, the analytic posterior moved VF_CONTROL_SHIFT_SD
# posterior standard deviations in every coordinate, which must fail it.
# Data and reference draws come from numpy (vf_data, cnn_data), so the JAX
# package can train on the same inputs. bench.py:369-399's
# diffuser_sampling: VP, theta 5-D, x 8-D, fresh weights, 500 steps, 1,024
# samples.
VF_SIMS, VF_BATCH, VF_PATIENCE, VF_MAX_EPOCHS, VF_DRAWS, VF_C2ST_MAX = 3_000, 100, 30, 400, 1_000, 0.62
VF_BATCHED_STEPS = 100
CNN_SIMS, CNN_L, CNN_BATCH, CNN_PATIENCE, CNN_MAX_EPOCHS, CNN_C2ST_MAX = 4_000, 32, 200, 30, 300, 0.65
CNN_HIDDEN, CNN_RATE_DRAWS, VF_CONTROL_SHIFT_SD = 128, 1_000, 1.0
DIFFUSER_THETA_DIM, DIFFUSER_X_DIM, DIFFUSER_STEPS, DIFFUSER_SAMPLES = 5, 8, 500, 1_024
STRICT_DIFFUSER_STEPS, STRICT_RK4_STEPS = 5, 3
# NRE. two_moons NRE_B at scripts/bm_round2.py:377-380's recipe: 30,000
# simulations, the default classifier (ResNet, hidden 50, 2 blocks), 10
# atoms, batch 200. The recipe's patience of 150 epochs is cut to the
# trainer's default of 20, and training to at most NRE_MAX_EPOCHS.
# Observations 0-2 of two_moons.npz in one MCMCPosterior.sample_batched run
# (200 chains, warmup 300, thin 3), NRE_DRAWS draws each against as many
# reference draws by c2st_torch, gated on the mean (NRE_C2ST_MEAN_MAX) and
# on each (NRE_C2ST_EACH_MAX). The target mean of 0.60
# (NRE_C2ST_MEAN_TARGET, printed beside it) lies inside both packages'
# spread: on the same numpy inputs, trained to the same patience and scored
# by the same exact draws and c2st_torch, the JAX package's means read
# 0.538-0.581 over five initialisations (up to 0.6175 at one
# observation), the port's 0.567-0.590 over eight
# (scripts/nre_two_moons_jax_vs_torch.py), and this phase reads 0.602 at
# --seed 0 (the same in two runs on an H100).
# The mean gate sits above the JAX package's worst mean plus the 0.03 that
# the slice sampler's draws read above or below exact ones, and below the
# control's 0.78. The chains
# start from NRE_INIT_CANDIDATES prior draws resampled per observation, as
# MCMCPosterior.sample's do: from sample_batched's default of 1,024, which
# the JAX package shares, the posterior (~0.3% of the prior box) holds a
# handful of candidates and the means read 0.593-0.631 over three
# trainings, against 0.562-0.594 from 10,000 and 0.577-0.589 by rejection
# sampling (scripts/nre_two_moons_patience.py, PERF.md section 6). The
# control, which must fail the gate, is NRE_DRAWS other reference draws
# jittered by N(0, NRE_CONTROL_JITTER^2 I): it read means of 0.785-0.786
# on the CPU (0.72-0.75 at observation 0), the reference against itself
# 0.48-0.49. The JAX package read 0.5165 at the full recipe
# (bm_results_round2.csv:15, sklearn's C2ST). The sampling rate is
# nle_slcp's configuration on the trained ratio at observation 0.
NRE_SIMS, NRE_BATCH, NRE_ATOMS, NRE_MAX_EPOCHS = 30_000, 200, 10, 300
NRE_CHAINS, NRE_WARMUP, NRE_THIN, NRE_DRAWS, NRE_INIT_CANDIDATES = 200, 300, 3, 2_000, 10_000
NRE_C2ST_MEAN_MAX, NRE_C2ST_EACH_MAX, NRE_CONTROL_JITTER = 0.62, 0.65, 0.15
NRE_C2ST_MEAN_TARGET = 0.60
SBI_TPU_NRE_TWO_MOONS = {"c2st_mean": 0.5165, "c2st": [0.4848, 0.53, 0.5347], "simulations": 30_000,
                         "patience": 150, "classifier": "sklearn",
                         "source": "bm_results_round2.csv:15"}
# sample_with="rejection" and "importance" on the same ratio at observation
# 0: NRE_IS_DRAWS draws each, the same gate and control. SIR draws one
# winner from each block of NRE_SIR_OVERSAMPLING prior draws: the
# posterior holds well under 1% of the prior box, so the default block of
# 32 rarely holds a posterior draw at all.
NRE_IS_DRAWS, NRE_SIR_OVERSAMPLING, NRE_PSIS_DRAWS = 1_000, 2_048, 10_000
# tests/test_nle_nre.py:18-69's slow tests: the 2-D linear Gaussian (shift
# -1, covariance 0.3 I, prior N(0, I)), 2,500 simulations, batch 100, to
# patience (capped here at NRE_LG_MAX_EPOCHS); 100 chains, warmup 100,
# 1,000 draws at x_o = 0 against the analytic posterior: C2ST within
# 0.5 +- 0.1 (check_c2st) for NRE_A and NRE_C; BNRE's mean posterior
# variance above half the true 0.3 / 1.3.
NRE_LG_SIMS, NRE_LG_BATCH, NRE_LG_MAX_EPOCHS, NRE_LG_CHAINS = 2_500, 100, 300, 100
NRE_LG_WARMUP, NRE_LG_DRAWS, NRE_LG_C2ST_TOL = 100, 1_000, 0.1
# Two rounds of SNRE_B on two_moons (2 x 2,000 simulations, the second
# drawn from the first posterior at observation 0), and an NRE_B ensemble
# on the linear Gaussian's data, cut to a few epochs.
SNRE_ROUND_SIMS, SNRE_EPOCHS = 2_000, (60, 30)
NRE_ENS_MEMBERS, NRE_ENS_EPOCHS = 4, 5


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line for a phase, with the seconds since the script began."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Kernel vs plain version
# ---------------------------------------------------------------------------


def spline_inputs(torch, n, K, device, gen, std=PARAM_STD, strided=True, lead=0, pad=0):
    """x (n,) ~ N(0, 1.5^2), and w, h, d ~ N(0, std^2) as slices of one
    (n, 3K-1 + pad) tensor (as the conditioner hands them to the spline; the
    tensor starts ``lead`` floats into its buffer) or as separate tensors."""
    x = 1.5 * torch.randn(n, generator=gen, device=device)
    if strided:
        P = 3 * K - 1 + pad
        buf = std * torch.randn(lead + n * P, generator=gen, device=device)
        p = buf[lead:].view(n, P)
        return x, p[:, :K], p[:, K:2 * K], p[:, 2 * K:3 * K - 1]
    w = std * torch.randn(n, K, generator=gen, device=device)
    h = std * torch.randn(n, K, generator=gen, device=device)
    d = std * torch.randn(n, K - 1, generator=gen, device=device)
    return x, w, h, d


def compare(torch, rqs, x, w, h, d, inverse, tail_bound=3.0, consts=None):
    consts = consts or (rqs.DEFAULT_MIN_BIN_WIDTH, rqs.DEFAULT_MIN_BIN_HEIGHT,
                        rqs.DEFAULT_MIN_DERIVATIVE)
    with torch.no_grad():
        y, ld = rqs.rational_quadratic_spline(x, w, h, d, inverse, tail_bound, *consts)
        y0, ld0 = rqs.rational_quadratic_spline_plain(x, w, h, d, inverse, tail_bound, *consts)
    torch.cuda.synchronize() if x.is_cuda else None
    err_y = float((y - y0).abs().max()) if x.numel() else 0.0
    err_ld = float((ld - ld0).abs().max()) if x.numel() else 0.0
    ok = bool(torch.allclose(y, y0, atol=Y_ATOL, rtol=Y_RTOL)) and bool(
        torch.allclose(ld, ld0, atol=LD_ATOL, rtol=0.0))
    return ok, err_y, err_ld


def within_float64(torch, rqs, x, w, h, d, inverse, tail_bound=3.0):
    """Kernel and float32 plain version, each against the plain version in
    float64: the kernel's max error in y and in log|det| may be at most
    STRESS_FACTOR times the float32 plain version's own (+ 1e-6)."""
    with torch.no_grad():
        yk, lk = rqs.rational_quadratic_spline(x, w, h, d, inverse, tail_bound)
        yp, lp = rqs.rational_quadratic_spline_plain(x, w, h, d, inverse, tail_bound)
        y64, l64 = rqs.rational_quadratic_spline_plain(
            *(t.double() for t in (x, w, h, d)), inverse, tail_bound)
    errs = {k: float((a.double() - b).abs().max()) for k, a, b in (
        ("kernel_y", yk, y64), ("kernel_ld", lk, l64),
        ("plain_y", yp, y64), ("plain_ld", lp, l64))}
    ok = all(errs[f"kernel_{q}"] <= STRESS_FACTOR * errs[f"plain_{q}"] + 1e-6 for q in ("y", "ld"))
    return ok, errs


def spline_grads(torch, fn, x, w, h, d, gy, gl, inverse, tail_bound, consts):
    """Gradients of (x, w, h, d) under upstream (gy, gl), through ``fn``.
    The leaves alias the inputs' storage with their strides, so slices of
    one row stay slices of one row."""
    leaves = [t.detach().requires_grad_(True) for t in (x, w, h, d)]
    y, ld = fn(*leaves, inverse, tail_bound, *consts)
    return torch.autograd.grad((y, ld), leaves, (gy, gl))


def near_knot(torch, rqs, x, w, h, inverse, tail_bound, consts, dtype):
    """Elements within KNOT_GAP of a knot of the plain version, computed in
    ``dtype``: width knots forward, height knots inverse."""
    min_bin = consts[1] if inverse else consts[0]
    _, knots = rqs._knots((h if inverse else w).to(dtype), min_bin, tail_bound)
    return (knots - x.to(dtype)[..., None]).abs().amin(-1) < KNOT_GAP


def _grad_errors(torch, got, want, far, quantile=None):
    """|got - want| per gradient over the elements ``far`` from a knot: the
    max, or the given quantile."""
    errs = {}
    for name, a, b in zip("xwhd", got, want):
        keep = far if a.dim() == far.dim() else far[..., None].expand_as(a)
        err = (a.double()[keep] - b.double()[keep]).abs()
        if err.numel() == 0:
            errs[name] = 0.0
        elif quantile is None:
            errs[name] = float(err.max())
        else:  # torch.quantile takes at most 2^24 elements
            errs[name] = float(torch.quantile(err[: 1 << 24], quantile))
    return errs


def grad_compare(torch, rqs, x, w, h, d, inverse, tail_bound, consts, gen):
    """Backward kernel vs autograd through the float32 plain version, within
    GRAD_ATOL + GRAD_RTOL |g| away from knots, finite everywhere."""
    gy = torch.randn(x.shape, generator=gen, device=x.device)
    gl = torch.randn(x.shape, generator=gen, device=x.device)
    got = spline_grads(torch, rqs.rational_quadratic_spline, x, w, h, d, gy, gl, inverse, tail_bound, consts)
    want = spline_grads(torch, rqs.rational_quadratic_spline_plain, x, w, h, d, gy, gl, inverse,
                        tail_bound, consts)
    far = ~near_knot(torch, rqs, x, w, h, inverse, tail_bound, consts, torch.float32)
    ok = all(bool(torch.isfinite(a).all()) for a in got)
    for a, b in zip(got, want):
        keep = far if a.dim() == far.dim() else far[..., None].expand_as(a)
        ok = ok and bool(torch.allclose(a[keep], b[keep], atol=GRAD_ATOL, rtol=GRAD_RTOL))
    return ok, _grad_errors(torch, got, want, far), int((~far).sum())


def grads_within_float64(torch, rqs, x, w, h, d, inverse, tail_bound, consts, gen):
    """Backward kernel and float32 autograd through the plain version, each
    against autograd through the plain version in float64, away from the
    float64 knots: per gradient, the kernel's error at the GRAD_QUANTILE of
    elements may be at most STRESS_FACTOR times the float32 plain version's
    own (+ 1e-7). The max errors are reported, not held: they sit at a few
    ill-conditioned elements (gradients of 1e3-1e4 next to a knot), where
    either float32 version may be the worse by several times."""
    gy = torch.randn(x.shape, generator=gen, device=x.device)
    gl = torch.randn(x.shape, generator=gen, device=x.device)
    args = (gy, gl, inverse, tail_bound, consts)
    got = spline_grads(torch, rqs.rational_quadratic_spline, x, w, h, d, *args)
    plain = spline_grads(torch, rqs.rational_quadratic_spline_plain, x, w, h, d, *args)
    exact = spline_grads(torch, rqs.rational_quadratic_spline_plain,
                         *(t.double() for t in (x, w, h, d, gy, gl)), inverse, tail_bound, consts)
    far = ~near_knot(torch, rqs, x, w, h, inverse, tail_bound, consts, torch.float64)
    kernel, own = _grad_errors(torch, got, exact, far), _grad_errors(torch, plain, exact, far)
    q_kernel = _grad_errors(torch, got, exact, far, GRAD_QUANTILE)
    q_own = _grad_errors(torch, plain, exact, far, GRAD_QUANTILE)
    ok = all(bool(torch.isfinite(a).all()) for a in got) and all(
        q_kernel[k] <= STRESS_FACTOR * q_own[k] + 1e-7 for k in q_kernel)
    return ok, {"kernel": kernel, "plain": own, f"kernel_q{GRAD_QUANTILE}": q_kernel,
                f"plain_q{GRAD_QUANTILE}": q_own}, int((~far).sum())


def kernel_checks(torch, rqs, device, n_main, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    grad_gen = torch.Generator(device=device).manual_seed(seed + 5)  # upstream gradients
    B = 3.0
    results = []

    def run(name, x, w, h, d, inverse, consts=None):
        consts = consts or (rqs.DEFAULT_MIN_BIN_WIDTH, rqs.DEFAULT_MIN_BIN_HEIGHT,
                            rqs.DEFAULT_MIN_DERIVATIVE)
        large = w.shape[-1] >= LARGE_K
        ok, ey, eld = compare(torch, rqs, x, w, h, d, inverse, B, consts)
        if large:
            ok, _ = within_float64(torch, rqs, x, w, h, d, inverse, B)
        held = grads_within_float64 if large else grad_compare
        grad_ok, grad_err, near = held(torch, rqs, x, w, h, d, inverse, B, consts, grad_gen)
        results.append({"case": name, "inverse": inverse, "n": int(x.numel()),
                        "K": int(w.shape[-1]), "max_abs_err_y": ey,
                        "max_abs_err_ld": eld, "ok": ok, "grad_max_abs_err": grad_err,
                        "grad_near_knot": near, "grad_ok": grad_ok})
        check(ok, f"kernel != plain in case {name} (inverse={inverse}): "
                  f"y err {ey}, ld err {eld}")
        check(grad_ok, f"backward kernel != plain in case {name} (inverse={inverse}): {grad_err}")
        # The large-K cases, held to float64, stay out of the summary's
        # max_abs_err, which is against the plain version at the tolerances.
        if large:
            return 0.0
        backward_worst[0] = max(backward_worst[0], *grad_err.values())
        return max(ey, eld)

    worst = {False: 0.0, True: 0.0}
    backward_worst = [0.0]
    launches = (rqs.forward_launches, rqs.inverse_launches, rqs.backward_launches)
    for inverse in (False, True):
        x, w, h, d = spline_inputs(torch, n_main, 10, device, gen)
        worst[inverse] = max(worst[inverse], run("main_strided", x, w, h, d, inverse))
        # (rows, n_trans, 3K-1) as the coupling layer produces it: SLCP's
        # posterior at the main size, and SLCP's NLE likelihood (4 of x's 8
        # dims) at one potential evaluation of 1,000 chains, at the 10,000
        # init candidates and at a training batch of 200.
        for rows, n_trans in ((n_main // 3, 3), (NLE_CHAINS, 4), (10_000, 4), (200, 4)):
            p = PARAM_STD * torch.randn(rows, n_trans, 29, generator=gen, device=device)
            xr = 1.5 * torch.randn(rows, n_trans, generator=gen, device=device)
            name = "coupling_layout" if n_trans == 3 else f"coupling_layout_{rows}x{n_trans}"
            worst[inverse] = max(worst[inverse], run(
                name, xr, p[..., :10], p[..., 10:20], p[..., 20:], inverse))
        # Tile edges: n = 1, and n not a multiple of any tile size, in both
        # tile loads (one row span, and separate tensors).
        for n in (1, 33, 300_001, 1_000_003):
            for strided in (True, False):
                xs, ws, hs, ds = spline_inputs(torch, n, 10, device, gen, strided=strided)
                name = f"n={n}_{'one_span' if strided else 'separate'}"
                worst[inverse] = max(worst[inverse], run(name, xs, ws, hs, ds, inverse))
        # Span bases 1, 2 and 3 floats past a 16-byte boundary.
        for lead in (1, 2, 3):
            xs, ws, hs, ds = spline_inputs(torch, 30_001, 10, device, gen, lead=lead)
            worst[inverse] = max(worst[inverse], run(f"base+{lead}_floats", xs, ws, hs, ds, inverse))
        # Rows padded to 32 floats: equal strides, but not one span.
        xs, ws, hs, ds = spline_inputs(torch, 30_000, 10, device, gen, pad=3)
        worst[inverse] = max(worst[inverse], run("padded_rows", xs, ws, hs, ds, inverse))
        edge = torch.tensor([-B, B, -B - 1e-3, B + 1e-3, -10.0, 10.0, 0.0,
                             -B + 1e-6, B - 1e-6], device=device)
        _, we, he, de = spline_inputs(torch, edge.numel(), 10, device, gen)
        worst[inverse] = max(worst[inverse], run("at_and_beyond_bounds", edge, we, he, de, inverse))
        x4, w4, h4, d4 = spline_inputs(torch, 4099, 4, device, gen)
        worst[inverse] = max(worst[inverse], run(
            "K=4_nondefault_constants", x4, w4, h4, d4, inverse, (1e-2, 5e-3, 1e-2)))
        x10, w10, h10, d10 = spline_inputs(torch, 30_000, 10, device, gen)
        worst[inverse] = max(worst[inverse], run(
            "K=10_nondefault_constants", x10, w10, h10, d10, inverse, (1e-2, 5e-3, 1e-2)))
        # K outside the K = 10 instance: the generic kernel, both tile loads,
        # up to the largest K (the smallest tile).
        for K, n in ((2, 20_000), (4, 20_000), (7, 30_000), (64, 30_000), (rqs.MAX_BINS, 3_000)):
            for strided in (True, False):
                xk, wk, hk, dk = spline_inputs(torch, n, K, device, gen, strided=strided)
                name = f"K={K}_{'one_span' if strided else 'separate'}"
                worst[inverse] = max(worst[inverse], run(name, xk, wk, hk, dk, inverse))
    # Check launches are not launches of the main path.
    rqs.forward_launches, rqs.inverse_launches, rqs.backward_launches = launches
    return results, worst, backward_worst[0]


def stress_check(torch, rqs, device, n, seed):
    """Parameters of std 1: kernels and the float32 plain version, each
    against the plain version in float64 (values, and gradients away from
    the knots)."""
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    consts = (rqs.DEFAULT_MIN_BIN_WIDTH, rqs.DEFAULT_MIN_BIN_HEIGHT, rqs.DEFAULT_MIN_DERIVATIVE)
    launches = (rqs.forward_launches, rqs.inverse_launches, rqs.backward_launches)
    out = {}
    for inverse in (False, True):
        x, w, h, d = spline_inputs(torch, n, 10, device, gen, std=1.0)
        ok, errs = within_float64(torch, rqs, x, w, h, d, inverse)
        check(ok, f"stress (inverse={inverse}): kernel error vs float64 above "
                  f"{STRESS_FACTOR} x the plain version's: {errs}")
        grad_ok, grad_errs, near = grads_within_float64(torch, rqs, x, w, h, d, inverse, 3.0, consts, gen)
        check(grad_ok, f"stress (inverse={inverse}): backward kernel error vs float64 above "
                       f"{STRESS_FACTOR} x the plain version's: {grad_errs}")
        out["inverse" if inverse else "forward"] = {**errs, "gradients": grad_errs,
                                                    "grad_near_knot": near}
    rqs.forward_launches, rqs.inverse_launches, rqs.backward_launches = launches
    return out


def time_ms(torch, fn, iters=100, warmup=10, before=None):
    """Wall time per call of ``iters`` calls back to back, by CUDA events:
    the host's work per call included wherever it exceeds the device's.
    With ``before`` (an L2 flush), each call is timed by its own pair of
    events and ``before`` runs outside them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if before is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def device_ms(torch, fn, iters=20, warmup=3, before=None, match=None):
    """Device time per call, by torch.profiler, over ``iters`` calls. With
    ``match``, each call launches exactly one operation whose name contains
    it (a kernel, or a library call's kernel) and the result is the mean
    time of those operations; else it is the summed time of all device
    operations per call. ``before`` (an L2 flush) runs before each call and
    is not counted then."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):  # a session now and then drops device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and (match is None or match in e.name)]
        total = sum(e.device_time_total for e in ops)
        # A dropped event leaves a mean of one kernel per call unbiased, but
        # not a sum over a call's kernels: there, a count that is not a
        # multiple of the calls means some were dropped.
        if match is not None and iters // 2 <= len(ops) <= iters:
            return total / len(ops) / 1e3
        if match is None and ops and len(ops) % iters == 0:
            return total / iters / 1e3
    check(False, "the profiler lost device operations in three sessions")


def spline_bound_ms(n, K):
    """Least time for the spline on n elements: bytes (x, 3K-1 params in;
    y, ld out; float32) over HBM bandwidth vs float32 operations (about
    25K+40 per element: softmaxes, cumulative knots, softplus, bin search,
    rational-quadratic evaluation) over the float32 peak."""
    bytes_moved = n * 4 * (1 + (3 * K - 1) + 2)
    ops = n * (25 * K + 40)
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_timings(torch, rqs, device, seed):
    """Kernel times at the main path's sizes (``TIMING_SIZES``, K = 10), warm
    and cold L2, and the plain version at the largest. Cold: a write of
    ``FLUSH_BYTES`` before each call, outside the timed span. The
    n = 300,000 figures also stand under the summary keys ``ms``,
    ``call_ms``, ``plain_ms`` and ``plain_call_ms``, which the kernels line
    reads and which earlier runs recorded."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    flush_buf = torch.empty(FLUSH_BYTES // 4, device=device)
    flush = lambda: flush_buf.fill_(1.0)
    inputs = {}
    for rows, dims in TIMING_SIZES:
        p = PARAM_STD * torch.randn(rows, dims, 29, generator=gen, device=device)
        x = 1.5 * torch.randn(rows, dims, generator=gen, device=device)
        inputs[rows * dims] = (x, p[..., :10], p[..., 10:20], p[..., 20:])
    out = {}
    fwd, inv = rqs.forward_launches, rqs.inverse_launches
    with torch.no_grad():
        for inverse in (False, True):
            t = {"K": 10, "sizes": {}}
            for n, args in inputs.items():
                call = lambda: rqs.rational_quadratic_spline(*args, inverse)
                bound, by = spline_bound_ms(n, 10)
                t["sizes"][str(n)] = {
                    "bound_ms": bound, "bound_by": by,
                    "warm": {"device_ms": device_ms(torch, call, match="rqs"),
                             "time_ms": time_ms(torch, call)},
                    "cold": {"device_ms": device_ms(torch, call, before=flush, match="rqs"),
                             "time_ms": time_ms(torch, call, before=flush)},
                }
            n = max(inputs)
            big, plain = t["sizes"][str(n)], lambda: rqs.rational_quadratic_spline_plain(
                *inputs[n], inverse)
            t.update(n=n, bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                     ms=big["warm"]["device_ms"], call_ms=big["warm"]["time_ms"],
                     plain_ms=device_ms(torch, plain), plain_call_ms=time_ms(torch, plain))
            out[inverse] = t
    # Timing launches are not launches of the main path.
    rqs.forward_launches, rqs.inverse_launches = fwd, inv
    return out


def backward_bound_ms(n, K):
    """Least time for the spline's backward on n elements: bytes (x, 3K-1
    parameters and the two upstream gradients in; 3K gradients out;
    float32) over HBM bandwidth vs float32 operations (about 41K+120 per
    element: the forward's 25K+40, the softmax adjoints' ~16K and ~80 for
    the reverse of the chosen bin) over the float32 peak."""
    bytes_moved = n * 4 * ((1 + (3 * K - 1) + 2) + 3 * K)
    ops = n * (41 * K + 120)
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def backward_timings(torch, rqs, device, seed):
    """The backward kernel alone at ``BACKWARD_SIZES`` (K = 10, the forward
    direction's gradient, as training runs it), warm and cold L2, and its
    plain version (``rational_quadratic_spline_vjp_plain``) at each size.
    The n = 300,000 figures also stand under ``ms`` and ``plain_ms``."""
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    flush_buf = torch.empty(FLUSH_BYTES // 4, device=device)
    flush = lambda: flush_buf.fill_(1.0)
    consts = (3.0, rqs.DEFAULT_MIN_BIN_WIDTH, rqs.DEFAULT_MIN_BIN_HEIGHT, rqs.DEFAULT_MIN_DERIVATIVE)
    launches = rqs.backward_launches
    out = {"K": 10, "sizes": {}}
    with torch.no_grad():
        for rows, dims in BACKWARD_SIZES:
            p = PARAM_STD * torch.randn(rows, dims, 29, generator=gen, device=device)
            x = 1.5 * torch.randn(rows, dims, generator=gen, device=device)
            gy = torch.randn(rows, dims, generator=gen, device=device)
            gl = torch.randn(rows, dims, generator=gen, device=device)
            args = (x, p[..., :10], p[..., 10:20], p[..., 20:], gy, gl)
            call = lambda: rqs._launch_backward(*args, (True,) * 4, False, *consts)
            plain = lambda: rqs.rational_quadratic_spline_vjp_plain(*args, False, *consts)
            n = rows * dims
            bound, by = backward_bound_ms(n, 10)
            out["sizes"][str(n)] = {
                "bound_ms": bound, "bound_by": by,
                "warm": {"device_ms": device_ms(torch, call, match="rqs_backward"),
                         "time_ms": time_ms(torch, call)},
                "cold": {"device_ms": device_ms(torch, call, before=flush, match="rqs_backward"),
                         "time_ms": time_ms(torch, call, before=flush)},
                "plain_ms": device_ms(torch, plain), "plain_call_ms": time_ms(torch, plain),
            }
    n = max(r * c for r, c in BACKWARD_SIZES)
    big = out["sizes"][str(n)]
    out.update(n=n, bound_ms=big["bound_ms"], bound_by=big["bound_by"],
               ms=big["warm"]["device_ms"], plain_ms=big["plain_ms"])
    rqs.backward_launches = launches  # timing launches are not the main path's
    return out


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def count_calls(obj, name):
    """Count calls of ``obj.name`` (one flow pass each) through an instance
    attribute that wraps the method."""
    orig = getattr(obj, name)
    box = [0]

    def wrapped(*args, **kwargs):
        box[0] += 1
        return orig(*args, **kwargs)

    object.__setattr__(obj, name, wrapped)
    return box


def perturb_heads(torch, est, gen, std=0.03):
    """Give every zero-initialised spline head N(0, std^2) weights, so the
    splines are far from the identity while most of the random posterior's
    mass stays inside SLCP's prior box. At std 0.1 almost none of it does
    for some observations, and rejection sampling starves."""
    from sbi_tpu_torch.neural_nets.estimators.flows import MaskedRQSAutoregressive, RQSCoupling

    with torch.no_grad():
        for layer in est.net.layers:
            if isinstance(layer, RQSCoupling):
                head = layer.dense[-1]
            elif isinstance(layer, MaskedRQSAutoregressive):
                head = layer.made.masked[-1]
            else:
                continue
            head.weight.copy_(std * torch.randn(head.weight.shape, generator=gen,
                                                device=head.weight.device))


def flow_checks(torch, est, x_o, gen, n):
    """Round trip noise -> data -> noise, and single-pass
    sample_and_log_prob against log_prob of the same samples."""
    net = est.net
    with torch.no_grad():
        zc = est._embed_condition(x_o)
        z = torch.randn(n, est.input_shape[0], generator=gen, device=x_o.device)
        ctx = zc.repeat(n, 1)
        data, _ = net.inverse(z, ctx)
        h = data
        for layer in net.layers:
            h, _ = layer(h, ctx)
        rt_err = float((h - z).abs().max())
        theta, lp1 = est.sample_and_log_prob_fn(n, x_o, generator=gen)
        lp2 = est.log_prob(theta, x_o)
        lp_err = float((lp1 - lp2).abs().max())
    check(rt_err <= ROUND_TRIP_ATOL, f"round trip error {rt_err}")
    check(lp_err <= SAMPLE_LP_ATOL, f"sample_and_log_prob vs log_prob error {lp_err}")
    return rt_err, lp_err


def sync_time(torch, fn):
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    return out, time.perf_counter() - t0


def slcp_path(torch, rqs, device, seed, num_sims=10_000, num_samples=100_000,
              num_obs=64, batched_samples=256, hidden=50):
    from sbi_tpu_torch.inference.posteriors import DirectPosterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.simulators import get_task, slcp_simulator

    gen = torch.Generator(device=device).manual_seed(seed)
    task = get_task("slcp", device=device)
    theta = task.prior.sample((num_sims,), generator=gen)
    x = slcp_simulator(theta, generator=gen)
    est = posterior_nn("nsf", hidden_features=hidden, device=device,
                       generator=torch.Generator().manual_seed(seed))(theta, x)
    perturb_heads(torch, est, gen)
    n_params = sum(p.numel() for p in est.net.parameters())
    post = DirectPosterior(est, task.prior)
    x_o = slcp_simulator(task.prior.sample((1,), generator=gen), generator=gen)
    xs = slcp_simulator(task.prior.sample((num_obs,), generator=gen), generator=gen)
    inv_passes = count_calls(est.net, "inverse")
    fwd_passes = count_calls(est.net, "log_prob")
    n_spline = sum(1 for l in est.net.layers if type(l).__name__ == "RQSCoupling")

    f0, i0 = rqs.forward_launches, rqs.inverse_launches
    post.sample((1000,), x=x_o, generator=gen)  # warm-up: library handles, allocator
    samples, t_sample = sync_time(torch, lambda: post.sample((num_samples,), x=x_o, generator=gen))
    check(rqs.inverse_launches - i0 == n_spline * inv_passes[0],
          f"sample: {rqs.inverse_launches - i0} inverse launches for {inv_passes[0]} flow passes")
    leak, t_leak = sync_time(torch, lambda: post.leakage_correction(x_o, generator=gen))
    with torch.no_grad():
        lp, t_lp = sync_time(torch, lambda: post.log_prob(samples, x=x_o))
    batched, t_batched = sync_time(torch, lambda: post.sample_batched(
        (batched_samples,), x=xs, generator=gen, starvation_policy="raise"))
    check(rqs.forward_launches - f0 == n_spline * fwd_passes[0],
          f"{rqs.forward_launches - f0} forward launches for {fwd_passes[0]} passes")
    check(rqs.inverse_launches - i0 == n_spline * inv_passes[0],
          f"{rqs.inverse_launches - i0} inverse launches for {inv_passes[0]} passes")

    check(tuple(samples.shape) == (num_samples, 5), f"sample shape {tuple(samples.shape)}")
    check(tuple(batched.shape) == (batched_samples, num_obs, 5), f"batched shape {tuple(batched.shape)}")
    for name, t in (("samples", samples), ("log_prob", lp), ("batched", batched), ("leakage", leak)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(bool(task.prior.within_support(samples).all()), "sample outside the prior")
    check(bool(task.prior.within_support(batched.reshape(-1, 5)).all()), "batched sample outside the prior")
    check(0.0 < float(leak) <= 1.0, f"leakage correction {float(leak)}")
    rt_err, lp_err = flow_checks(torch, est, x_o, gen, min(num_samples, 10_000))
    emit("slcp", params=n_params, num_transforms=n_spline, hidden=hidden,
         samples=num_samples, sample_s=t_sample, samples_per_s=num_samples / t_sample,
         log_prob_s=t_lp, log_probs_per_s=num_samples / t_lp,
         sample_batched_s=t_batched, batched_obs=num_obs, batched_samples=batched_samples,
         leakage_s=t_leak, leakage=float(leak),
         inverse_passes=inv_passes[0], forward_passes=fwd_passes[0],
         round_trip_max_err=rt_err, sample_log_prob_max_err=lp_err)


def two_moons_path(torch, rqs, device, seed, num_sims=10_000, num_samples=10_000, hidden=50):
    from sbi_tpu_torch.inference.posteriors import DirectPosterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.simulators import get_task, two_moons_simulator

    gen = torch.Generator(device=device).manual_seed(seed + 10)
    task = get_task("two_moons", device=device)
    theta = task.prior.sample((num_sims,), generator=gen)
    x = two_moons_simulator(theta, generator=gen)
    est = posterior_nn("nsf", hidden_features=hidden, device=device,
                       generator=torch.Generator().manual_seed(seed + 10))(theta, x)
    perturb_heads(torch, est, gen)
    post = DirectPosterior(est, task.prior)
    x_o = torch.zeros(1, 2, device=device)
    inv_passes = count_calls(est.net, "inverse")
    fwd_passes = count_calls(est.net, "log_prob")
    n_spline = sum(1 for l in est.net.layers if type(l).__name__ == "MaskedRQSAutoregressive")

    f0, i0 = rqs.forward_launches, rqs.inverse_launches
    post.sample((1000,), x=x_o, generator=gen)  # warm-up
    samples, t_sample = sync_time(torch, lambda: post.sample((num_samples,), x=x_o, generator=gen))
    with torch.no_grad():
        lp, t_lp = sync_time(torch, lambda: post.log_prob(samples, x=x_o))
    # Each autoregressive inverse runs dim = 2 sequential spline passes.
    check(rqs.inverse_launches - i0 == 2 * n_spline * inv_passes[0],
          f"{rqs.inverse_launches - i0} inverse launches for {inv_passes[0]} passes")
    check(rqs.forward_launches - f0 == n_spline * fwd_passes[0],
          f"{rqs.forward_launches - f0} forward launches for {fwd_passes[0]} passes")
    check(tuple(samples.shape) == (num_samples, 2), f"sample shape {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()) and bool(torch.isfinite(lp).all()), "non-finite output")
    check(bool(task.prior.within_support(samples).all()), "sample outside the prior")
    rt_err, lp_err = flow_checks(torch, est, x_o, gen, num_samples)
    emit("two_moons", params=sum(p.numel() for p in est.net.parameters()),
         num_transforms=n_spline, samples=num_samples, sample_s=t_sample,
         samples_per_s=num_samples / t_sample, log_prob_s=t_lp,
         log_probs_per_s=num_samples / t_lp, inverse_passes=inv_passes[0],
         forward_passes=fwd_passes[0], round_trip_max_err=rt_err,
         sample_log_prob_max_err=lp_err)


def spline_layers(net):
    return sum(1 for l in net.layers if type(l).__name__ in ("RQSCoupling", "MaskedRQSAutoregressive"))


def device_events(torch, fn):
    """Run ``fn`` under torch.profiler, device activity only: wall seconds
    and the device operations. The host's operator events, a million in an
    MCMC run, took the profiler minutes to collect and are not read here."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # A user annotation (such as the optimizer's step range) is reported as
    # a device event too, and is no work of its own.
    return wall, [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]


def profile_shares(torch, fn):
    """``fn``'s wall seconds, device-busy seconds (summed device time of its
    kernels), the spline kernels' device seconds, forward and backward, and
    its device operations (``device_events``)."""
    wall, ops = device_events(torch, fn)
    busy = sum(e.device_time_total for e in ops) / 1e6
    check(busy > 0, "the profiler recorded no device operation")
    bwd = sum(e.device_time_total for e in ops if "rqs_backward_kernel" in e.name) / 1e6
    fwd = sum(e.device_time_total for e in ops if "rqs_kernel" in e.name) / 1e6
    return wall, busy, fwd, bwd, len(ops)


def slcp_training(torch, rqs, device, seed, num_sims=10_000, epochs=4):
    """SLCP NPE at full width: a warm-up epoch that builds the NSF, then
    ``epochs`` epochs timed and one profiled; the loss must be finite and
    fall, and every spline of every forward and backward pass must go
    through the kernels."""
    import warnings

    from sbi_tpu_torch.inference import NPE
    from sbi_tpu_torch.simulators import get_task, slcp_simulator

    gen = torch.Generator(device=device).manual_seed(seed + 20)
    task = get_task("slcp", device=device)
    theta = task.prior.sample((num_sims,), generator=gen)
    x = slcp_simulator(theta, generator=gen)
    inference = NPE(prior=task.prior, density_estimator="nsf")
    inference.append_simulations(theta, x)
    f0, b0 = rqs.forward_launches, rqs.backward_launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        inference.train(max_num_epochs=1, generator=gen)  # warm-up; builds the net
        net = inference._neural_net.net
        passes = count_calls(net, "log_prob")
        steps0 = inference._opt_steps
        _, t_train = sync_time(torch, lambda: inference.train(
            max_num_epochs=epochs, resume_training=True, generator=gen))
        steps = inference._opt_steps - steps0
        wall, busy, fwd_s, bwd_s, n_ops = profile_shares(torch, lambda: inference.train(
            max_num_epochs=1, resume_training=True, generator=gen))
    n_spline = spline_layers(net)
    all_steps = inference._opt_steps
    epochs_run = len(inference.summary["training_loss"])
    # Every step is one forward and one backward pass, every epoch one
    # validation pass more (the warm-up's passes ran before the count).
    check(passes[0] == all_steps - steps0 + epochs_run - 1,
          f"{passes[0]} flow passes for {all_steps - steps0} steps")
    check(rqs.forward_launches - f0 == n_spline * (all_steps + epochs_run),
          f"{rqs.forward_launches - f0} forward launches for {all_steps} steps, {epochs_run} epochs")
    check(rqs.backward_launches - b0 == n_spline * all_steps,
          f"{rqs.backward_launches - b0} backward launches for {all_steps} steps")
    losses = inference.summary["training_loss"]
    val = inference.summary["validation_loss"]
    check(all(math.isfinite(v) for v in losses + val), f"non-finite loss {losses} {val}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    emit("slcp_training", params=sum(p.numel() for p in net.parameters()), spline_layers=n_spline,
         simulations=num_sims, batch=200, steps_per_epoch=steps // epochs, epochs_timed=epochs,
         train_s=t_train, steps_per_s=steps / t_train, training_loss=losses, validation_loss=val,
         profiled_epoch={"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
                         "device_ops": n_ops, "spline_forward_s": fwd_s,
                         "spline_backward_s": bwd_s, "spline_forward_share_of_busy": fwd_s / busy,
                         "spline_backward_share_of_busy": bwd_s / busy},
         forward_launches=rqs.forward_launches - f0, backward_launches=rqs.backward_launches - b0)


def reference_posteriors(task_name):
    """Observations and reference posterior samples of ``task_name`` from
    the repository's fixtures, read with numpy."""
    import numpy as np

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "mini_sbibm",
                        "files", f"{task_name}.npz")
    with np.load(path) as f:
        return f["observations"], f["reference_samples"]


def two_moons_training(torch, rqs, device, seed, num_sims=10_000, max_epochs=90):
    """two_moons NPE-NSF on ``num_sims`` simulations trained to early
    stopping (at most ``max_epochs``), then C2ST against the reference
    posterior of each fixture observation. Returns the trainer."""
    import warnings

    from sbi_tpu_torch.inference import NPE, simulate_for_sbi
    from sbi_tpu_torch.simulators import get_task
    from sbi_tpu_torch.utils import c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 30)
    task = get_task("two_moons", device=device)
    theta, x = simulate_for_sbi(task.simulator, task.prior, num_sims, generator=gen)
    inference = NPE(prior=task.prior, density_estimator="nsf")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, t_train = sync_time(torch, lambda: inference.append_simulations(theta, x).train(
            max_num_epochs=max_epochs, generator=gen))
    posterior = inference.build_posterior()
    observations, references = reference_posteriors("two_moons")
    scores = []
    for x_o, ref in zip(observations, references):
        samples = posterior.sample((ref.shape[0],), x=torch.as_tensor(x_o, device=device), generator=gen)
        check(bool(torch.isfinite(samples).all()), "non-finite posterior sample")
        scores.append(float(c2st_torch(samples, torch.as_tensor(ref, device=device), generator=gen)))
    mean = sum(scores) / len(scores)
    epochs = inference.summary["epochs_trained"][-1]
    emit("two_moons_training", simulations=num_sims, epochs=epochs, max_epochs=max_epochs,
         early_stopped=epochs < max_epochs, train_s=t_train,
         steps_per_s=inference._opt_steps / t_train,
         best_validation_loss=inference.summary["best_validation_loss"][-1],
         c2st=scores, c2st_mean=mean, c2st_bar={"mean": C2ST_MEAN_MAX, "each": C2ST_EACH_MAX})
    check(mean <= C2ST_MEAN_MAX and max(scores) <= C2ST_EACH_MAX, f"two_moons C2ST {scores}")
    return inference


def maf_canonical(torch, device, seed, num_sims=2_000, epochs=5):
    """The four-line recipe with its defaults: ``NPE(prior=prior)`` trains
    a MAF on cuda (device=None); its posterior samples inside the prior."""
    import warnings

    from sbi_tpu_torch.inference import NPE, simulate_for_sbi
    from sbi_tpu_torch.simulators import get_task

    gen = torch.Generator(device=device).manual_seed(seed + 50)
    task = get_task("two_moons", device=device)
    theta, x = simulate_for_sbi(task.simulator, task.prior, num_sims, generator=gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        inference = NPE(prior=task.prior)
        _, t = sync_time(torch, lambda: inference.append_simulations(theta, x).train(
            max_num_epochs=epochs, generator=gen))
    posterior = inference.build_posterior()
    samples = posterior.sample((1_000,), x=torch.zeros(2, device=device), generator=gen)
    losses = inference.summary["training_loss"]
    check(type(inference._neural_net.net.layers[0]).__name__ == "MaskedAffineAutoregressive",
          "NPE(prior) did not build a MAF")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"MAF losses {losses}")
    check(bool(task.prior.within_support(samples).all()), "MAF sample outside the prior")
    emit("maf_canonical", simulations=num_sims, epochs=epochs, train_s=t, training_loss=losses,
         device=str(inference._device))


def snpe_two_rounds(torch, rqs, device, seed, num_sims=2_000, epochs=(30, 10)):
    """Two rounds of SNPE-C on two_moons: round 2 draws from the round-1
    posterior at x_o (the inverse kernel) and trains on the atomic loss
    (10 atoms: forward and backward at 200 x 10 x 2 = 4,000 elements)."""
    import warnings

    from sbi_tpu_torch.inference import SNPE_C, simulate_for_sbi
    from sbi_tpu_torch.simulators import get_task

    gen = torch.Generator(device=device).manual_seed(seed + 40)
    task = get_task("two_moons", device=device)
    observations, _ = reference_posteriors("two_moons")
    x_o = torch.as_tensor(observations[0], device=device)
    inference = SNPE_C(prior=task.prior, density_estimator="nsf")
    proposal = task.prior
    rounds = []
    i0, b0 = rqs.inverse_launches, rqs.backward_launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r, max_epochs in enumerate(epochs):
            theta, x = simulate_for_sbi(task.simulator, proposal, num_sims, generator=gen)
            inference.append_simulations(theta, x, proposal=proposal)
            _, t = sync_time(torch, lambda: inference.train(max_num_epochs=max_epochs, generator=gen))
            proposal = inference.build_posterior().set_default_x(x_o)
            rounds.append({"round": r + 1, "train_s": t,
                           "epochs": inference.summary["epochs_trained"][-1],
                           "best_validation_loss": inference.summary["best_validation_loss"][-1]})
    samples = proposal.sample((1_000,), generator=gen)
    losses = inference.summary["training_loss"] + inference.summary["validation_loss"]
    check(all(math.isfinite(v) for v in losses), "non-finite SNPE-C loss")
    check(bool(torch.isfinite(samples).all()), "non-finite SNPE-C sample")
    check(bool(task.prior.within_support(samples).all()), "SNPE-C sample outside the prior")
    check(rqs.inverse_launches > i0 and rqs.backward_launches > b0, "SNPE-C bypassed a kernel")
    emit("snpe_c_two_rounds", simulations_per_round=num_sims, rounds=rounds,
         inverse_launches=rqs.inverse_launches - i0, backward_launches=rqs.backward_launches - b0)


# ---------------------------------------------------------------------------
# NLE and MCMC
# ---------------------------------------------------------------------------


class FsmCounts:
    """Counts the slice sampler's FSM iterations and host syncs in a block
    of code, by wrapping the module's iteration and its loop condition (the
    sampler's one host sync per block). With ``strict``, every other host
    sync in the block raises: ``torch.cuda.set_sync_debug_mode("error")``
    is on except inside the loop condition."""

    def __init__(self, torch, fsm, strict=False):
        self.torch, self.fsm, self.strict = torch, fsm, strict
        self.iterations = self.syncs = 0

    def __enter__(self):
        fsm, torch = self.fsm, self.torch
        self._orig = (fsm._fsm_iteration, fsm._all_recorded)
        step, recorded = self._orig

        def counted_step(*args, **kwargs):
            self.iterations += 1
            return step(*args, **kwargs)

        def counted_sync(*args, **kwargs):
            self.syncs += 1
            if self.strict:
                torch.cuda.set_sync_debug_mode(0)
            try:
                return recorded(*args, **kwargs)
            finally:
                if self.strict:
                    torch.cuda.set_sync_debug_mode("error")

        fsm._fsm_iteration, fsm._all_recorded = counted_step, counted_sync
        if self.strict:
            torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        if self.strict:
            self.torch.cuda.set_sync_debug_mode(0)
        self.fsm._fsm_iteration, self.fsm._all_recorded = self._orig
        return False

    def fields(self, seconds):
        return {"fsm_iterations": self.iterations, "host_syncs": self.syncs,
                "host_us_per_iteration": seconds / max(self.iterations, 1) * 1e6}


def slice_gaussian(torch, fsm, device, seed):
    """bench.py's headline on the port: 1,000 chains on the 5-D correlated
    Gaussian. A short warm-up run (strict: no host sync but the loop
    condition's), then a timed run."""
    from sbi_tpu_torch.samplers.mcmc import run_slice_vectorized

    cov = SLICE_RHO * torch.ones(SLICE_DIM, SLICE_DIM) + (1 - SLICE_RHO) * torch.eye(SLICE_DIM)
    prec = torch.linalg.inv(cov).to(device)

    def potential(t):
        return -0.5 * torch.einsum("bi,ij,bj->b", t, prec, t)

    gen = torch.Generator(device=device).manual_seed(seed + 60)
    inits = torch.randn(SLICE_CHAINS, SLICE_DIM, generator=gen, device=device)

    def run(num_samples=SLICE_SAMPLES):
        return run_slice_vectorized(potential, inits, num_samples=num_samples,
                                    warmup_steps=SLICE_WARMUP, init_width=1.0, generator=gen)

    with FsmCounts(torch, fsm, strict=device.type == "cuda"):
        run(num_samples=10)
    with FsmCounts(torch, fsm) as counts:
        draws, seconds = sync_time(torch, run)
    flat = draws.reshape(-1, SLICE_DIM)
    mean = flat.mean(0)
    emp_cov = torch.cov(flat.T).cpu()
    emit("slice_gaussian", chains=SLICE_CHAINS, dim=SLICE_DIM, rho=SLICE_RHO,
         warmup=SLICE_WARMUP, samples_per_chain=SLICE_SAMPLES, seconds=seconds,
         posterior_samples_per_sec_1k_slice_chains=SLICE_CHAINS * SLICE_SAMPLES / seconds,
         sync_every=fsm.SYNC_EVERY, **counts.fields(seconds), mean=mean.tolist(),
         cov_max_abs_err=float((emp_cov - cov).abs().max()))
    check(draws.shape == (SLICE_SAMPLES, SLICE_CHAINS, SLICE_DIM), f"draws {tuple(draws.shape)}")
    check(bool(torch.isfinite(draws).all()), "non-finite slice draws")
    check(float(mean.abs().max()) < SLICE_MEAN_ATOL, f"slice mean {mean.tolist()}")
    check(bool(torch.allclose(emp_cov, cov, atol=SLICE_COV_ATOL)), f"slice covariance {emp_cov}")


def slcp_exact_slice(torch, fsm, device, seed, num_obs=2):
    """The sampler on a hard multimodal target, without a network:
    ``MCMCPosterior`` over SLCP's exact likelihood plus the prior, in the
    prior's unconstrained space, at the first observations of
    ``slcp_ref.npz``; C2ST against their reference samples."""
    from sbi_tpu_torch.inference import MCMCPosterior
    from sbi_tpu_torch.simulators import get_task
    from sbi_tpu_torch.utils import c2st_torch, mcmc_transform

    gen = torch.Generator(device=device).manual_seed(seed + 70)
    task = get_task("slcp", device=device)
    observations, references = reference_posteriors("slcp_ref")

    def potential(theta, x_o):
        return task.log_likelihood(theta, x_o) + task.prior.log_prob(theta)

    results = []
    for idx in range(num_obs):
        post = MCMCPosterior(potential, proposal=task.prior, theta_transform=mcmc_transform(task.prior),
                             num_chains=SLCP_CHAINS, warmup_steps=SLCP_WARMUP, thin=SLCP_THIN,
                             init_strategy="proposal", device=device)
        x_o = torch.as_tensor(observations[idx], device=device)
        with FsmCounts(torch, fsm) as counts:
            samples, seconds = sync_time(torch, lambda: post.sample(
                (SLCP_CHAINS * SLCP_PER_CHAIN,), x=x_o, generator=gen))
        check(bool(torch.isfinite(samples).all()), "non-finite SLCP sample")
        check(bool(task.prior.within_support(samples).all()), "SLCP sample outside the prior")
        ref = torch.as_tensor(references[idx][:1000], device=device)
        score = float(c2st_torch(samples[:1000], ref, generator=gen))
        results.append({"observation": idx, "c2st": score, "seconds": seconds, **counts.fields(seconds)})
    emit("slcp_exact_slice", chains=SLCP_CHAINS, warmup=SLCP_WARMUP, samples_per_chain=SLCP_PER_CHAIN,
         thin=SLCP_THIN, c2st_max=SLCP_C2ST_MAX, observations=results)
    check(all(r["c2st"] < SLCP_C2ST_MAX for r in results), f"SLCP exact-likelihood C2ST {results}")


def nle_slcp(torch, rqs, fsm, device, seed, num_sims=10_000, epochs=3):
    """BASELINE config 3's hot path at full width: NLE-NSF on SLCP (x 8-D
    through 5 couplings, theta 5-D as the condition) trained for a few
    epochs, then 1,000 chains sampled through the likelihood potential: a
    warm run (strict: no host sync but the loop condition's), a timed run
    and a profiled one. Every potential evaluation, the init candidates'
    one included, is one flow pass and one forward launch per coupling.
    Returns the sampling figures."""
    import warnings

    from sbi_tpu_torch.inference import NLE
    from sbi_tpu_torch.simulators import get_task, slcp_simulator

    gen = torch.Generator(device=device).manual_seed(seed + 80)
    task = get_task("slcp", device=device)
    theta = task.prior.sample((num_sims,), generator=gen)
    x = slcp_simulator(theta, generator=gen)
    inference = NLE(prior=task.prior, density_estimator="nsf")
    inference.append_simulations(theta, x)
    f0, b0 = rqs.forward_launches, rqs.backward_launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        inference.train(max_num_epochs=1, generator=gen)  # warm-up; builds the net
        steps0 = inference._opt_steps
        _, t_train = sync_time(torch, lambda: inference.train(
            max_num_epochs=epochs, resume_training=True, generator=gen))
    steps = inference._opt_steps - steps0
    train_forward, train_backward = rqs.forward_launches - f0, rqs.backward_launches - b0
    check(train_forward > 0 and train_backward > 0, "NLE training bypassed a kernel")
    losses = inference.summary["training_loss"]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"NLE losses {losses}")

    posterior = inference.build_posterior()
    est = posterior.potential_fn.likelihood_estimator
    passes = count_calls(est.net, "log_prob")
    n_spline = spline_layers(est.net)
    x_o = slcp_simulator(task.prior.sample((1,), generator=gen), generator=gen)

    def sample():
        return posterior.sample((NLE_CHAINS * NLE_SAMPLES,), x=x_o, generator=gen,
                                num_chains=NLE_CHAINS, warmup_steps=NLE_WARMUP)

    f1 = rqs.forward_launches
    with FsmCounts(torch, fsm, strict=device.type == "cuda"):
        sample()
    with FsmCounts(torch, fsm) as counts:
        samples, seconds = sync_time(torch, sample)
    t0 = time.perf_counter()
    wall, busy, fwd_s, _, n_ops = profile_shares(torch, sample)
    profiler_s = time.perf_counter() - t0 - wall
    launches = rqs.forward_launches - f1
    check(launches == n_spline * passes[0],
          f"{launches} forward launches for {passes[0]} potential evaluations")
    check(tuple(samples.shape) == (NLE_CHAINS * NLE_SAMPLES, 5), f"NLE samples {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()), "non-finite NLE sample")
    check(bool(task.prior.within_support(samples).all()), "NLE sample outside the prior")
    runs = 3
    emit("nle_slcp", params=sum(p.numel() for p in est.net.parameters()), spline_layers=n_spline,
         simulations=num_sims, epochs_timed=epochs, train_s=t_train, steps_per_s=steps / t_train,
         training_loss=losses, training_forward_launches=train_forward,
         training_backward_launches=train_backward, chains=NLE_CHAINS, warmup=NLE_WARMUP,
         samples_per_chain=NLE_SAMPLES, seconds=seconds,
         nle_slice_samples_per_sec=NLE_CHAINS * NLE_SAMPLES / seconds, **counts.fields(seconds),
         host_ms_per_iteration=seconds / max(counts.iterations, 1) * 1e3,
         potential_evaluations_per_run=passes[0] / runs, forward_launches_per_run=launches / runs,
         forward_launch_n=NLE_CHAINS * 4, init_candidates_launch_n=10_000 * 4,
         profiled_run={"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
                       "device_ops": n_ops, "spline_forward_s": fwd_s,
                       "spline_forward_share_of_busy": fwd_s / busy if busy else None,
                       "profiler_overhead_s": profiler_s})
    return {"nle_slice_samples_per_sec": NLE_CHAINS * NLE_SAMPLES / seconds,
            "fsm_iterations": counts.iterations,
            "host_ms_per_iteration": seconds / max(counts.iterations, 1) * 1e3,
            "device_busy_share": busy / wall}


def nle_two_moons(torch, rqs, device, seed, num_sims=10_000, max_epochs=60, num_chains=100,
                  warmup=100, num_samples=5_000):
    """two_moons NLE-NSF to early stopping (at most ``max_epochs``), then
    ``num_samples`` draws of ``num_chains`` slice chains per observation of
    ``two_moons.npz`` and a C2ST against as many of its reference samples.
    Returns the posterior."""
    import warnings

    from sbi_tpu_torch.inference import NLE, simulate_for_sbi
    from sbi_tpu_torch.simulators import get_task
    from sbi_tpu_torch.utils import c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 90)
    task = get_task("two_moons", device=device)
    theta, x = simulate_for_sbi(task.simulator, task.prior, num_sims, generator=gen)
    inference = NLE(prior=task.prior, density_estimator="nsf")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, t_train = sync_time(torch, lambda: inference.append_simulations(theta, x).train(
            max_num_epochs=max_epochs, generator=gen))
    posterior = inference.build_posterior(
        mcmc_parameters=dict(num_chains=num_chains, warmup_steps=warmup))
    observations, references = reference_posteriors("two_moons")
    scores, sample_s = [], []
    for x_o, ref in zip(observations, references):
        samples, t = sync_time(torch, lambda: posterior.sample(
            (num_samples,), x=torch.as_tensor(x_o, device=device), generator=gen))
        check(bool(torch.isfinite(samples).all()), "non-finite NLE posterior sample")
        check(bool(task.prior.within_support(samples).all()), "NLE sample outside the prior")
        ref = torch.as_tensor(ref[:num_samples], device=device)
        scores.append(float(c2st_torch(samples, ref, generator=gen)))
        sample_s.append(t)
    mean = sum(scores) / len(scores)
    epochs = inference.summary["epochs_trained"][-1]
    emit("nle_two_moons", simulations=num_sims, epochs=epochs, max_epochs=max_epochs,
         early_stopped=epochs < max_epochs, train_s=t_train,
         steps_per_s=inference._opt_steps / t_train,
         best_validation_loss=inference.summary["best_validation_loss"][-1],
         chains=num_chains, warmup=warmup, samples=num_samples, sample_s=sample_s,
         c2st=scores, c2st_mean=mean,
         c2st_bar={"mean": NLE_C2ST_MEAN_MAX, "each": NLE_C2ST_EACH_MAX},
         sbi_tpu_reference=SBI_TPU_NLE_TWO_MOONS)
    check(mean <= NLE_C2ST_MEAN_MAX and max(scores) <= NLE_C2ST_EACH_MAX, f"NLE two_moons C2ST {scores}")
    return posterior


def mcmc_batched(torch, rqs, device, seed, posterior, npe, num_obs=8, num_samples=1_000,
                 num_checked=2, hidden=50, npe_mcmc_samples=300):
    """``MCMCPosterior.sample_batched`` over ``num_obs`` observations of
    ``two_moons_ref.npz`` in one sampler run (each of the first
    ``num_checked`` columns held to a ``sample`` at its observation by
    C2ST; one draw per chain after the warmup, so that the draws are close
    to independent), and ``DirectPosterior.sample_batched`` with a prior
    box that a random NSF posterior never reaches, so that the default
    ``"mcmc"`` policy fills the starved observations; then
    ``npe_mcmc_samples`` draws of the NPE trainer ``npe``'s
    ``build_posterior(sample_with="mcmc")``."""
    from sbi_tpu_torch.inference.posteriors import DirectPosterior
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.simulators import get_task, two_moons_simulator
    from sbi_tpu_torch.utils import BoxUniform, c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 100)
    task = get_task("two_moons", device=device)
    observations, _ = reference_posteriors("two_moons_ref")
    xs = torch.as_tensor(observations[:num_obs], device=device)
    out, t_batched = sync_time(torch, lambda: posterior.sample_batched(
        (num_samples,), x=xs, generator=gen, num_chains=num_samples))
    check(tuple(out.shape) == (num_samples, num_obs, 2), f"sample_batched shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite batched sample")
    check(bool(task.prior.within_support(out.reshape(-1, 2)).all()), "batched sample outside the prior")
    scores = [float(c2st_torch(out[:, b], posterior.sample(
        (num_samples,), x=xs[b], generator=gen, num_chains=num_samples), generator=gen))
        for b in range(num_checked)]
    check(max(scores) <= BATCHED_C2ST_MAX, f"sample_batched vs sample C2ST {scores}")

    theta = task.prior.sample((2_000,), generator=gen)
    est = posterior_nn("nsf", hidden_features=hidden, device=device,
                       generator=torch.Generator().manual_seed(seed + 100))(
        theta, two_moons_simulator(theta, generator=gen))
    far = BoxUniform(20 * torch.ones(2), 21 * torch.ones(2), device=device)
    direct = DirectPosterior(est, far)
    i0, f0 = rqs.inverse_launches, rqs.forward_launches
    fills, t_fill = sync_time(torch, lambda: direct.sample_batched(
        (50,), x=xs[:2], generator=gen, max_total_proposals=512))
    check(rqs.inverse_launches > i0 and rqs.forward_launches > f0, "the starvation fill bypassed a kernel")
    check(tuple(fills.shape) == (50, 2, 2), f"fill shape {tuple(fills.shape)}")
    check(bool(torch.isfinite(fills).all()), "non-finite MCMC fill")
    check(bool(far.within_support(fills.reshape(-1, 2)).all()), "MCMC fill outside the prior box")
    fill_forward, fill_inverse = rqs.forward_launches - f0, rqs.inverse_launches - i0

    npe_posterior = npe.build_posterior(sample_with="mcmc",
                                        mcmc_parameters=dict(num_chains=100, warmup_steps=50))
    f0 = rqs.forward_launches
    npe_draws, t_npe = sync_time(torch, lambda: npe_posterior.sample(
        (npe_mcmc_samples,), x=xs[0], generator=gen))
    check(rqs.forward_launches > f0, "NPE's MCMC posterior bypassed the forward kernel")
    check(tuple(npe_draws.shape) == (npe_mcmc_samples, 2), f"NPE MCMC shape {tuple(npe_draws.shape)}")
    check(bool(torch.isfinite(npe_draws).all()), "non-finite NPE MCMC sample")
    check(bool(task.prior.within_support(npe_draws).all()), "NPE MCMC sample outside the prior")
    emit("mcmc_batched", observations=num_obs, samples=num_samples, sample_batched_s=t_batched,
         c2st_vs_sample=scores, starvation_fill_s=t_fill, fill_forward_launches=fill_forward,
         fill_inverse_launches=fill_inverse, npe_mcmc_samples=npe_mcmc_samples, npe_mcmc_s=t_npe,
         npe_mcmc_forward_launches=rqs.forward_launches - f0)


# ---------------------------------------------------------------------------
# Ensembles
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_launches(rqs):
    """Records (kernel, n, tile load) of every kernel launch in the block,
    by wrapping the launchers (which still count)."""
    launches, launch, launch_bwd = [], rqs._launch, rqs._launch_backward

    def forward(x, w, h, d, inverse, *rest):
        launches.append(("inverse" if inverse else "forward", int(x.numel()), rqs.tile_load(w, h, d)))
        return launch(x, w, h, d, inverse, *rest)

    def backward(x, w, h, d, *rest):
        launches.append(("backward", int(x.numel()), rqs.tile_load(w, h, d)))
        return launch_bwd(x, w, h, d, *rest)

    rqs._launch, rqs._launch_backward = forward, backward
    try:
        yield launches
    finally:
        rqs._launch, rqs._launch_backward = launch, launch_bwd


def ensemble_merge(torch, rqs, device, seed):
    """The spline's vmap rule (the counterpart of ``_rqs_flat_fn``) at the
    ensemble step's shape: ``torch.func.vmap`` over ENS_MEMBERS members of
    (ENS_BATCH, 5) elements, parameters as slices of one (..., 29) row, both
    directions, without and with ``grad``. Each vmapped call must launch
    its kernel once; its values and gradients must equal the members'
    separate kernel calls bit for bit, and hold to the plain version at the
    tolerances of ``kernel_checks``. Then the merged launch's device time
    against ENS_MEMBERS launches of one member, and the host time of a
    merged call against ENS_MEMBERS calls. These launches are checks, not
    the main path's: the counters are restored."""
    gen = torch.Generator(device=device).manual_seed(seed + 105)
    K, rows, dims = ENS_MEMBERS, ENS_BATCH, 5
    consts = (rqs.DEFAULT_MIN_BIN_WIDTH, rqs.DEFAULT_MIN_BIN_HEIGHT, rqs.DEFAULT_MIN_DERIVATIVE)
    x = 1.5 * torch.randn(K, rows, dims, generator=gen, device=device)
    p = PARAM_STD * torch.randn(K, rows, dims, 29, generator=gen, device=device)
    gy = torch.randn(K, rows, dims, generator=gen, device=device)
    gl = torch.randn(K, rows, dims, generator=gen, device=device)
    saved = (rqs.forward_launches, rqs.inverse_launches, rqs.backward_launches)

    def spline(inverse):
        return lambda x_, p_: rqs.rational_quadratic_spline(
            x_, p_[..., :10], p_[..., 10:20], p_[..., 20:], inverse)

    def grad_of(inverse):
        def f(x_, p_, gy_, gl_):
            y, ld = spline(inverse)(x_, p_)
            return (y * gy_).sum() + (ld * gl_).sum()
        return torch.func.grad(f, argnums=(0, 1))

    def counts():
        return rqs.forward_launches, rqs.inverse_launches, rqs.backward_launches

    out = {}
    with recorded_launches(rqs) as loads:
        for inverse in (False, True):
            direction = "inverse" if inverse else "forward"
            c0 = counts()
            with torch.no_grad():
                y_v, ld_v = torch.func.vmap(spline(inverse))(x, p)
            c1 = counts()
            gx_v, gp_v = torch.func.vmap(grad_of(inverse))(x, p, gy, gl)
            c2 = counts()
            spline_at = 1 if inverse else 0
            check(c1[spline_at] - c0[spline_at] == 1 and sum(c1) - sum(c0) == 1,
                  f"vmapped {direction} call: launches {c0} -> {c1}")
            check(c2[spline_at] - c1[spline_at] == 1 and c2[2] - c1[2] == 1 and sum(c2) - sum(c1) == 2,
                  f"vmapped {direction} grad: launches {c1} -> {c2}")
            with torch.no_grad():
                sep = [spline(inverse)(x[k], p[k]) for k in range(K)]
            y_s, ld_s = torch.stack([a for a, _ in sep]), torch.stack([b for _, b in sep])
            g_s = [grad_of(inverse)(x[k], p[k], gy[k], gl[k]) for k in range(K)]
            gx_s, gp_s = torch.stack([a for a, _ in g_s]), torch.stack([b for _, b in g_s])
            bitwise = {"values": bool(torch.equal(y_v, y_s) and torch.equal(ld_v, ld_s)),
                       "gradients": bool(torch.equal(gx_v, gx_s) and torch.equal(gp_v, gp_s))}
            check(all(bitwise.values()), f"vmapped {direction} != separate kernel calls: {bitwise}")
            w, h, d = p[..., :10], p[..., 10:20], p[..., 20:]
            ok, err_y, err_ld = compare(torch, rqs, x, w, h, d, inverse)
            check(ok, f"vmapped {direction}: kernel != plain (y {err_y}, ld {err_ld})")
            want = spline_grads(torch, rqs.rational_quadratic_spline_plain, x, w, h, d, gy, gl,
                                inverse, 3.0, consts)
            got = (gx_v, gp_v[..., :10], gp_v[..., 10:20], gp_v[..., 20:])
            far = ~near_knot(torch, rqs, x, w, h, inverse, 3.0, consts, torch.float32)
            grad_ok = all(bool(torch.isfinite(a).all()) for a in got)
            for a, b in zip(got, want):
                keep = far if a.dim() == far.dim() else far[..., None].expand_as(a)
                grad_ok = grad_ok and bool(torch.allclose(a[keep], b[keep], atol=GRAD_ATOL,
                                                          rtol=GRAD_RTOL))
            check(grad_ok, f"vmapped {direction} gradients != plain")
            out[direction] = {"bitwise_equal_to_separate_calls": bitwise,
                              "vs_plain": {"max_abs_err_y": err_y, "max_abs_err_ld": err_ld,
                                           "grad_max_abs_err": _grad_errors(torch, got, want, far),
                                           "grad_near_knot": int((~far).sum())},
                              "launches_per_vmapped_call": c1[spline_at] - c0[spline_at],
                              "launches_per_vmapped_grad_call": {"spline": c2[spline_at] - c1[spline_at],
                                                                 "backward": c2[2] - c1[2]}}
    check(all(load == "one_span" for _, n, load in loads if n == K * rows * dims),
          f"merged launches took the strided tile load: {loads}")

    n = K * rows * dims
    merged = torch.func.vmap(spline(False))
    with torch.no_grad():
        merged_call = lambda: merged(x, p)
        separate = lambda: [spline(False)(x[k], p[k]) for k in range(K)]
        timing = {
            "n_merged": n, "n_each": rows * dims, "members": K,
            "bound_ms": spline_bound_ms(n, 10)[0],
            "merged_device_ms": device_ms(torch, merged_call, match="rqs"),
            "separate_device_ms": device_ms(torch, separate),
            "merged_call_ms": time_ms(torch, merged_call),
            "separate_calls_ms": time_ms(torch, separate),
        }
    vgrad = torch.func.vmap(grad_of(False))
    timing.update(
        backward_bound_ms=backward_bound_ms(n, 10)[0],
        merged_grad_call_ms=time_ms(torch, lambda: vgrad(x, p, gy, gl)),
        separate_grad_calls_ms=time_ms(torch, lambda: [grad_of(False)(x[k], p[k], gy[k], gl[k])
                                                        for k in range(K)]))
    rqs.forward_launches, rqs.inverse_launches, rqs.backward_launches = saved
    emit("ensemble_merge", shape=[K, rows, dims, 29], tile_load=sorted(set(l for _, _, l in loads)),
         tolerance={"values_and_gradients_vs_separate_calls": "bitwise",
                    "vs_plain": "as kernel_vs_plain"}, **out, timing=timing)
    return timing


def ensemble_step_check(torch, builder, theta, x, device, gen, lr=5e-4):
    """One vmapped ensemble step (``ensemble_step``, what ``train_ensemble``
    runs) from a common start against each member's single-model step on
    the same batch: loss, clipped gradients and parameters after Adam, at
    the tolerances STEP_*. The clip is set between the smallest and the
    largest member's gradient norm, so that it scales some members and
    leaves others."""
    from sbi_tpu_torch.inference.trainers.base import (
        clip_by_global_norm_,
        ensemble_grad_and_loss,
        ensemble_step,
    )
    from sbi_tpu_torch.neural_nets.estimators.base import stack_nets

    K = ENS_MEMBERS
    ests = [builder(theta, x) for _ in range(K)]
    for est in ests[1:]:
        est.input_transform, est.condition_transform = ests[0].input_transform, ests[0].condition_transform
    params = stack_nets([e.net for e in ests])
    template = ests[0]
    grad_and_loss = ensemble_grad_and_loss(
        template.net, lambda th, xx, m: -template.log_prob(th[None], xx)[0])
    idx = torch.randint(theta.shape[0], (K, ENS_BATCH), generator=gen, device=device)
    batch = (theta[idx], x[idx], torch.ones(K, ENS_BATCH, device=device))
    with torch.no_grad():
        grads, _ = grad_and_loss(params, *batch)
        norms = torch.linalg.vector_norm(torch.cat([g.reshape(K, -1) for g in grads.values()], 1), dim=1)
    norms = norms.tolist()
    clip = math.sqrt(min(norms) * max(norms))
    check(min(norms) < clip < max(norms), f"member gradient norms {norms}")
    adam = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=True)
    opt = torch.optim.Adam(list(params.values()), **adam)
    losses = ensemble_step(grad_and_loss, params, opt, batch, clip).tolist()
    worst = {"loss_rel": 0.0, "grad_rel": 0.0, "param_abs": 0.0, "param_tight_share": 1.0}
    for k, est in enumerate(ests):
        named = dict(est.net.named_parameters())
        loss = -est.log_prob(batch[0][k][None], batch[1][k])[0].mean()
        g = torch.autograd.grad(loss, list(named.values()))
        clip_by_global_norm_(list(g), clip)
        for p_, g_ in zip(named.values(), g):
            p_.grad = g_
        torch.optim.Adam(list(named.values()), **adam).step()
        lk = float(loss.detach())
        worst["loss_rel"] = max(worst["loss_rel"], abs(losses[k] - lk) / abs(lk))
        tight = total = 0
        for (name, p_), g_ in zip(named.items(), g):
            scale = float(g_.abs().max()) or 1.0
            worst["grad_rel"] = max(worst["grad_rel"], float((params[name].grad[k] - g_).abs().max()) / scale)
            diff = (params[name][k] - p_.detach()).abs()
            worst["param_abs"] = max(worst["param_abs"], float(diff.max()))
            tight += int((diff <= STEP_PARAM_TIGHT).sum())
            total += diff.numel()
        worst["param_tight_share"] = min(worst["param_tight_share"], tight / total)
    check(worst["loss_rel"] <= STEP_LOSS_RTOL and worst["grad_rel"] <= STEP_GRAD_RTOL
          and worst["param_abs"] <= 2 * lr and worst["param_tight_share"] >= STEP_TIGHT_SHARE,
          f"vmapped step != single-model steps: {worst}")
    return {"member_grad_norms": norms, "clip": clip,
            "members_clipped": sum(n >= clip for n in norms), "max_err": worst,
            "tolerance": {"loss_rtol": STEP_LOSS_RTOL, "grad_rtol_of_max": STEP_GRAD_RTOL,
                          "param_atol": 2 * lr, "param_tight": STEP_PARAM_TIGHT,
                          "param_tight_share": STEP_TIGHT_SHARE}}


def npe_ens8(torch, rqs, device, seed, epochs=ENS_EPOCHS):
    """npe-nsf-ens8 at full width: the deterministic step check, then
    ``NPE(...).train_ensemble`` (at most ``epochs`` epochs), a single model
    at the same width for one epoch and a warm-up, profiled vmapped steps,
    the mixture ``EnsemblePosterior`` scored by C2ST against
    ``gaussian_linear.npz``, one member's C2ST, and ``sample_batched``,
    ``log_prob(individually=True)`` and ``weight_by_evidence`` once each."""
    import warnings

    from sbi_tpu_torch.inference import NPE
    from sbi_tpu_torch.inference.trainers.base import ensemble_grad_and_loss, ensemble_step
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.neural_nets.estimators.base import functional
    from sbi_tpu_torch.simulators import get_task
    from sbi_tpu_torch.utils import c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 110)
    task = get_task("gaussian_linear", device=device)
    theta = task.prior.sample((ENS_SIMS,), generator=gen)
    x = task.simulator(theta, generator=gen)
    builder = posterior_nn("nsf", hidden_features=ENS_HIDDEN, num_transforms=5,
                           interleave_affine=True, device=device)
    step_check = ensemble_step_check(torch, builder, theta, x, device, gen)

    inference = NPE(prior=task.prior, density_estimator=builder)
    inference.append_simulations(theta, x)
    f0, b0 = rqs.forward_launches, rqs.backward_launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        members, t_train = sync_time(torch, lambda: inference.train_ensemble(
            num_members=ENS_MEMBERS, training_batch_size=ENS_BATCH, max_num_epochs=epochs,
            epoch_chunk=1, stop_after_epochs=100, generator=gen))  # a summary entry an epoch
    epochs_run = inference.summary["epochs_trained"][-1]
    n_train = ENS_SIMS - int(0.1 * ENS_SIMS)
    per_epoch = n_train // ENS_BATCH
    steps = epochs_run * per_epoch
    n_spline = spline_layers(members[0].net)
    check(rqs.forward_launches - f0 == n_spline * (steps + epochs_run),
          f"{rqs.forward_launches - f0} forward launches for {steps} steps, {epochs_run} epochs")
    check(rqs.backward_launches - b0 == n_spline * steps,
          f"{rqs.backward_launches - b0} backward launches for {steps} steps")
    durations = inference.summary["epoch_durations_sec"][-epochs_run:]
    timed = sorted(durations[1:]) or durations
    epoch_s = timed[len(timed) // 2]
    losses, val = inference.summary["training_loss"], inference.summary["validation_loss"]
    check(all(math.isfinite(v) for v in losses + val) and losses[-1] < losses[0],
          f"ensemble losses {losses}")

    single = NPE(prior=task.prior, density_estimator=builder)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single.append_simulations(theta, x).train(max_num_epochs=2, generator=gen)
    single_epoch_s = single.summary["epoch_durations_sec"][-1]

    # Vmapped steps as train_ensemble runs them, from its stacked state:
    # the spline launches and their sizes, and a profiled window.
    params = {k: v.clone() for k, v in inference._ensemble_stacked_state.items()}
    opt = torch.optim.Adam(list(params.values()), lr=5e-4, foreach=True)
    template = members[0]  # run under each member's parameters, as train_ensemble does
    grad_and_loss = ensemble_grad_and_loss(template.net, inference._ensemble_loss_fn(template))
    val_fn = inference._ensemble_val_loss_fn(template)
    member_val = torch.func.vmap(functional(template.net, lambda *b: val_fn(*b).mean()))
    batches = [torch.randint(ENS_SIMS, (ENS_MEMBERS, ENS_BATCH), generator=gen, device=device)
               for _ in range(ENS_PROFILED_STEPS)]
    masks = torch.ones(ENS_MEMBERS, ENS_BATCH, device=device)

    def run_steps():
        for idx in batches:
            ensemble_step(grad_and_loss, params, opt, (theta[idx], x[idx], masks), 5.0)

    with recorded_launches(rqs) as step_launches:
        idx = batches[0]
        ensemble_step(grad_and_loss, params, opt, (theta[idx], x[idx], masks), 5.0)
    vidx = inference._val_indices.expand(ENS_MEMBERS, -1)
    with recorded_launches(rqs) as val_launches, torch.no_grad():
        member_val(params, theta[vidx], x[vidx], masks[:, :1].expand_as(vidx))
    n_step = ENS_MEMBERS * ENS_BATCH * 5
    n_val = ENS_MEMBERS * vidx.shape[1] * 5
    check(step_launches == [("forward", n_step, "one_span")] * n_spline
          + [("backward", n_step, "one_span")] * n_spline, f"step launches {step_launches}")
    check(val_launches == [("forward", n_val, "one_span")] * n_spline, f"validation launches {val_launches}")
    _, t_steps = sync_time(torch, run_steps)
    wall, busy, fwd_s, bwd_s, n_ops = profile_shares(torch, run_steps)

    post = inference.build_ensemble_posterior()
    check(post.potential_fn.vmapped, "the ensemble posterior evaluates members one by one")
    observations, references = reference_posteriors("gaussian_linear")
    scores, sample_s = [], []
    for x_o, ref in zip(observations, references):
        x_o = torch.as_tensor(x_o, device=device)
        samples, t = sync_time(torch, lambda: post.sample((ENS_DRAWS,), x=x_o, generator=gen))
        check(tuple(samples.shape) == (ENS_DRAWS, 10) and bool(torch.isfinite(samples).all()),
              "ensemble samples")
        scores.append(float(c2st_torch(samples, torch.as_tensor(ref[:ENS_DRAWS], device=device),
                                       generator=gen)))
        sample_s.append(t)
    member0 = inference.build_posterior(density_estimator=members[0])
    x0 = torch.as_tensor(observations[0], device=device)
    member_c2st = float(c2st_torch(member0.sample((ENS_DRAWS,), x=x0, generator=gen),
                                   torch.as_tensor(references[0][:ENS_DRAWS], device=device),
                                   generator=gen))

    xs = torch.cat([torch.as_tensor(observations, device=device),
                    task.simulator(task.prior.sample((5,), generator=gen), generator=gen)])
    batched, t_batched = sync_time(torch, lambda: post.sample_batched((1_000,), x=xs, generator=gen))
    check(tuple(batched.shape) == (1_000, 8, 10) and bool(torch.isfinite(batched).all()),
          f"ensemble sample_batched {tuple(batched.shape)}")
    th = task.prior.sample((1_000,), generator=gen)
    with torch.no_grad():
        lps = post.log_prob(th, x=x0, individually=True)
        lp = post.log_prob(th, x=x0)
    check(tuple(lps.shape) == (ENS_MEMBERS, 1_000) and bool(torch.isfinite(lps).all()),
          "log_prob(individually=True)")
    mix = torch.logsumexp(lps + torch.log(post.weights)[:, None], 0)
    check(bool(torch.allclose(lp, mix, atol=1e-5)), "mixture log_prob")
    logz, t_evidence = sync_time(torch, lambda: post.weight_by_evidence(
        x=x0, num_samples=100_000, generator=gen))
    check(bool(torch.isfinite(logz).all()) and bool(torch.allclose(
        post.weights, torch.softmax(logz, 0), atol=1e-6)), f"weight_by_evidence {logz.tolist()}")

    mean = sum(scores) / len(scores)
    emit("npe_ens8", members=ENS_MEMBERS, simulations=ENS_SIMS, hidden=ENS_HIDDEN, batch=ENS_BATCH,
         params_per_member=sum(p.numel() for p in members[0].net.parameters()),
         spline_layers=n_spline, steps_per_epoch=per_epoch, epochs=epochs_run, max_epochs=epochs,
         train_s=t_train, epoch_s_median=epoch_s, ensemble_steps_per_s=per_epoch / epoch_s,
         member_steps_per_s=ENS_MEMBERS * per_epoch / epoch_s,
         single_model_epoch_s=single_epoch_s, single_model_steps_per_s=per_epoch / single_epoch_s,
         training_loss=losses, validation_loss=val,
         best_validation_loss=inference.summary["best_validation_loss"][-1],
         step_check=step_check,
         step_launches=[[k, n] for k, n, _ in step_launches],
         validation_launches=[[k, n] for k, n, _ in val_launches],
         tile_load=sorted(set(l for _, _, l in step_launches + val_launches)),
         profiled_steps={"steps": ENS_PROFILED_STEPS, "steps_per_s": ENS_PROFILED_STEPS / t_steps,
                         "wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
                         "device_ops_per_step": n_ops / ENS_PROFILED_STEPS,
                         "spline_forward_s": fwd_s, "spline_backward_s": bwd_s},
         c2st=scores, c2st_mean=mean, c2st_bar={"mean": ENS_C2ST_MEAN_MAX, "each": ENS_C2ST_EACH_MAX},
         member0_c2st_obs0=member_c2st, sample_s=sample_s, sample_batched_s=t_batched,
         evidence_s=t_evidence, log_evidence=logz.tolist(), weights=post.weights.tolist(),
         sbi_tpu_reference={"c2st_mean": 0.5111, "source": "bm_results_round5.csv",
                            "classifier": "sklearn"})
    check(mean <= ENS_C2ST_MEAN_MAX and max(scores) <= ENS_C2ST_EACH_MAX, f"ensemble C2ST {scores}")


def nle_poe_slcp(torch, rqs, fsm, device, seed, single):
    """SLCP NLE-NSF, POE_MEMBERS members at full width trained for a few
    epochs with ``train_ensemble``, then the product of experts sampled as
    ``nle_slcp`` samples one model (1,000 chains, warmup 10, 5 draws a
    chain): a strict warm run (no host sync but the loop condition's), a
    timed run and a profiled one. Every potential evaluation is one flow
    pass for all members, one forward launch per coupling. ``single``: the
    single-model figures of ``nle_slcp`` in this run."""
    import warnings

    from sbi_tpu_torch.inference import NLE
    from sbi_tpu_torch.simulators import get_task, slcp_simulator

    gen = torch.Generator(device=device).manual_seed(seed + 120)
    task = get_task("slcp", device=device)
    theta = task.prior.sample((POE_SIMS,), generator=gen)
    x = slcp_simulator(theta, generator=gen)
    inference = NLE(prior=task.prior, density_estimator="nsf")
    inference.append_simulations(theta, x)
    f0, b0 = rqs.forward_launches, rqs.backward_launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        members, t_train = sync_time(torch, lambda: inference.train_ensemble(
            num_members=POE_MEMBERS, max_num_epochs=POE_EPOCHS, epoch_chunk=1, generator=gen))
    epochs_run = inference.summary["epochs_trained"][-1]
    steps = epochs_run * ((POE_SIMS - POE_SIMS // 10) // 200)
    n_spline = spline_layers(members[0].net)
    check(rqs.forward_launches - f0 == n_spline * (steps + epochs_run)
          and rqs.backward_launches - b0 == n_spline * steps,
          f"PoE training launches {rqs.forward_launches - f0}, {rqs.backward_launches - b0}")
    losses = inference.summary["training_loss"]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"PoE losses {losses}")

    posterior = inference.build_ensemble_posterior("product")
    check(posterior.potential_fn.vmapped, "the PoE evaluates members one by one")
    net = posterior.posteriors[0].potential_fn.likelihood_estimator.net
    passes = count_calls(net, "log_prob")
    x_o = slcp_simulator(task.prior.sample((1,), generator=gen), generator=gen)

    def sample():
        return posterior.sample((NLE_CHAINS * NLE_SAMPLES,), x=x_o, generator=gen,
                                num_chains=NLE_CHAINS, warmup_steps=NLE_WARMUP)

    f1 = rqs.forward_launches
    with FsmCounts(torch, fsm, strict=device.type == "cuda"):
        sample()
    with FsmCounts(torch, fsm) as counts:
        samples, seconds = sync_time(torch, sample)
    t0 = time.perf_counter()
    wall, busy, fwd_s, _, n_ops = profile_shares(torch, sample)
    profiler_s = time.perf_counter() - t0 - wall
    launches = rqs.forward_launches - f1
    check(launches == n_spline * passes[0],
          f"{launches} forward launches for {passes[0]} potential evaluations")
    check(tuple(samples.shape) == (NLE_CHAINS * NLE_SAMPLES, 5), f"PoE samples {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()), "non-finite PoE sample")
    check(bool(task.prior.within_support(samples).all()), "PoE sample outside the prior")
    runs = 3
    emit("nle_poe_slcp", members=POE_MEMBERS, simulations=POE_SIMS, spline_layers=n_spline,
         epochs=epochs_run, train_s=t_train, steps_per_s=steps / t_train, training_loss=losses,
         chains=NLE_CHAINS, warmup=NLE_WARMUP, samples_per_chain=NLE_SAMPLES, seconds=seconds,
         poe_slice_samples_per_sec=NLE_CHAINS * NLE_SAMPLES / seconds, **counts.fields(seconds),
         host_ms_per_iteration=seconds / max(counts.iterations, 1) * 1e3,
         strict_no_sync=device.type == "cuda",
         potential_evaluations_per_run=passes[0] / runs, forward_launches_per_run=launches / runs,
         forward_launch_n=POE_MEMBERS * NLE_CHAINS * 4,
         profiled_run={"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
                       "device_ops": n_ops, "spline_forward_s": fwd_s,
                       "profiler_overhead_s": profiler_s},
         single_member_nle_slcp=single)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The MDN family
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def no_host_sync(torch, device):
    """Every host sync in the block raises, on the card
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def device_breakdown(torch, fn, top=5):
    """``fn``'s wall seconds, device-busy seconds and share, device
    operations, and the ``top`` kernels by device time (``device_events``).
    The busy fields are None when the profiler recorded no device event (it
    can drop events after earlier profiled runs)."""
    wall, ops = device_events(torch, fn)
    busy = sum(e.device_time_total for e in ops) / 1e6
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall, "device_busy_s": busy if ops else None,
            "device_busy_share": busy / wall if ops else None, "device_ops": len(ops),
            "top_kernels_s": [[name[:80], t] for name, t in kernels]}


def linear_gaussian_task(torch, device, dim):
    """The prior N(0, I), the simulator (shift -1, covariance 0.3 I) and the
    analytic posterior at an observation."""
    from sbi_tpu_torch.simulators.linear_gaussian import (
        linear_gaussian,
        true_posterior_linear_gaussian_mvn_prior,
    )
    from sbi_tpu_torch.utils import MultivariateNormal

    zeros, eye = torch.zeros(dim, device=device), torch.eye(dim, device=device)
    shift, cov = -torch.ones(dim, device=device), 0.3 * eye
    prior = MultivariateNormal(zeros, covariance_matrix=eye, device=device)

    def simulator(theta, generator=None):
        return linear_gaussian(theta, shift, cov, generator=generator)

    def truth(x_o):
        return true_posterior_linear_gaussian_mvn_prior(x_o, shift, cov, zeros, eye)

    return prior, simulator, truth


def c2st_against_truth(torch, posterior, truth, x_o, gen, n=MDN_DRAWS):
    from sbi_tpu_torch.utils import c2st_torch

    samples = posterior.sample((n,), x=x_o, generator=gen)
    check(samples.shape == (n, x_o.shape[-1]) and bool(torch.isfinite(samples).all()),
          "non-finite MDN posterior sample")
    ref = truth(x_o).sample((n,), generator=gen)
    return float(c2st_torch(samples, ref, generator=gen)), samples


def mdn_data(seed):
    """BASELINE config 1's inputs, drawn with numpy from ``seed``: MDN_SIMS
    theta from N(0, I) and x = theta + MDN_SHIFT + N(0, MDN_LIK_VAR I); the
    observations, x_o = 0 and two x from the simulator; at each, MDN_DRAWS
    draws from the analytic posterior N((x_o - shift) / 1.3, 0.3 / 1.3 I)
    and as many for the control, moved by MDN_CONTROL_SHIFT_SD posterior
    standard deviations in every coordinate; and each observation's squared
    Mahalanobis distance from the mean of x (10 on average)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = MDN_DIM
    theta = rng.standard_normal((MDN_SIMS, D)).astype(np.float32)
    x = (theta + MDN_SHIFT + math.sqrt(MDN_LIK_VAR) * rng.standard_normal((MDN_SIMS, D))
         ).astype(np.float32)
    simulated = (rng.standard_normal((2, D)) + MDN_SHIFT
                 + math.sqrt(MDN_LIK_VAR) * rng.standard_normal((2, D)))
    observations = np.concatenate([np.zeros((1, D)), simulated]).astype(np.float32)
    post_var = 1.0 / (1.0 + 1.0 / MDN_LIK_VAR)
    means = post_var / MDN_LIK_VAR * (observations - MDN_SHIFT)
    refs = [(m + math.sqrt(post_var) * rng.standard_normal((MDN_DRAWS, D))).astype(np.float32)
            for m in means]
    controls = [(m + (MDN_CONTROL_SHIFT_SD + rng.standard_normal((MDN_DRAWS, D)))
                 * math.sqrt(post_var)).astype(np.float32) for m in means]
    mahalanobis_sq = [float(((x_o - MDN_SHIFT) ** 2).sum() / (1.0 + MDN_LIK_VAR))
                      for x_o in observations]
    return theta, x, observations, refs, controls, mahalanobis_sq


def mdn_linear_gaussian_10d(torch, device, seed):
    """BASELINE config 1: NPE with an MDN on the 10-D linear Gaussian to
    patience; C2ST per observation, and the control's, train steps/s, the
    ``sample`` and ``log_prob`` rates at 100,000 draws, and ``MoG.sample``
    with every host sync refused. Returns the data, for the ensemble
    phase."""
    import warnings

    from sbi_tpu_torch.inference import NPE
    from sbi_tpu_torch.neural_nets import posterior_nn
    from sbi_tpu_torch.utils import c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 200)
    prior, _, _ = linear_gaussian_task(torch, device, MDN_DIM)
    theta, x, observations, refs, controls, mahalanobis_sq = mdn_data(seed)
    theta, x, observations = (torch.as_tensor(a, device=device) for a in (theta, x, observations))
    refs, controls = ([torch.as_tensor(a, device=device) for a in arrays] for arrays in (refs, controls))
    inference = NPE(prior=prior, density_estimator=posterior_nn(
        "mdn", num_components=MDN_COMPONENTS, hidden_features=MDN_HIDDEN, device=device))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        _, t_train = sync_time(torch, lambda: inference.append_simulations(theta, x).train(
            training_batch_size=MDN_BATCH, max_num_epochs=MDN_MAX_EPOCHS, generator=gen))
    epochs = inference.summary["epochs_trained"][-1]
    posterior = inference.build_posterior()
    scores, control_scores = [], []
    for x_o, ref, control in zip(observations, refs, controls):
        samples = posterior.sample((MDN_DRAWS,), x=x_o[None], generator=gen)
        check(samples.shape == (MDN_DRAWS, MDN_DIM) and bool(torch.isfinite(samples).all()),
              "non-finite MDN posterior sample")
        scores.append(float(c2st_torch(samples, ref, generator=gen)))
        control_scores.append(float(c2st_torch(control, ref, generator=gen)))
    mean, control_mean = sum(scores) / len(scores), sum(control_scores) / len(control_scores)
    x0 = observations[:1]
    samples, t_sample = sync_time(torch, lambda: posterior.sample((MDN_RATE_DRAWS,), x=x0,
                                                                  generator=gen))
    lp, t_lp = sync_time(torch, lambda: posterior.log_prob(samples, x=x0))
    check(bool(torch.isfinite(samples).all() and torch.isfinite(lp).all()),
          "non-finite MDN sample or log_prob")
    est = posterior.posterior_estimator
    mog = est.get_uncorrected_mog(x0)
    mog.validate()
    with no_host_sync(torch, device):
        draws, t_mog = sync_time(torch, lambda: mog.sample(MDN_RATE_DRAWS, gen))
    check(draws.shape == (MDN_RATE_DRAWS, 1, MDN_DIM) and bool(torch.isfinite(draws).all()),
          "non-finite MoG.sample")
    steps0 = inference._opt_steps
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        epoch_profile = device_breakdown(torch, lambda: inference.train(
            training_batch_size=MDN_BATCH, max_num_epochs=1, resume_training=True, generator=gen))
    epoch_profile["steps"] = inference._opt_steps - steps0
    sample_profile = device_breakdown(torch, lambda: mog.sample(MDN_RATE_DRAWS, gen))
    emit("mdn_linear_gaussian_10d", dim=MDN_DIM, simulations=MDN_SIMS,
         components=MDN_COMPONENTS, hidden=MDN_HIDDEN, batch=MDN_BATCH,
         params=sum(p.numel() for p in est.net.parameters()), epochs=epochs,
         max_epochs=MDN_MAX_EPOCHS, early_stopped=epochs < MDN_MAX_EPOCHS, train_s=t_train,
         steps_per_s=inference._opt_steps / t_train,
         best_validation_loss=inference.summary["best_validation_loss"][-1],
         observations_mahalanobis_sq=mahalanobis_sq,
         c2st=scores, c2st_mean=mean,
         c2st_gate={"mean": MDN_C2ST_MEAN_GATE, "each": MDN_C2ST_EACH_GATE},
         control={"mean_shift_sd": MDN_CONTROL_SHIFT_SD, "c2st": control_scores,
                  "c2st_mean": control_mean},
         c2st_bar_each=MDN_C2ST_EACH_MAX, c2st_north_star=MDN_C2ST_NORTH_STAR,
         c2st_within_bar=[c <= MDN_C2ST_EACH_MAX for c in scores],
         c2st_within_north_star=[c <= MDN_C2ST_NORTH_STAR for c in scores],
         sbi_tpu_reference=SBI_TPU_MDN_10D,
         sample_draws=MDN_RATE_DRAWS, sample_s=t_sample,
         samples_per_s=MDN_RATE_DRAWS / t_sample, log_prob_s=t_lp,
         log_probs_per_s=MDN_RATE_DRAWS / t_lp, mog_sample_s_no_host_sync=t_mog,
         profiled_epoch=epoch_profile, profiled_mog_sample=sample_profile)
    check(control_mean > MDN_C2ST_MEAN_GATE, f"the control passes the mean gate: {control_scores}")
    check(mean <= MDN_C2ST_MEAN_GATE and max(scores) <= MDN_C2ST_EACH_GATE,
          f"10-D MDN C2ST {scores}")
    return prior, theta, x


def snpe_c_mog_two_rounds(torch, device, seed):
    """Two rounds of NPE-C with an MDN net on the 2-D linear Gaussian: the
    second round, proposed by the first round's MDN posterior, takes the
    non-atomic MoG loss. One of its training steps runs with every host
    sync refused; C2ST against the analytic posterior."""
    import warnings

    from sbi_tpu_torch.inference import NPE
    from sbi_tpu_torch.neural_nets import posterior_nn

    gen = torch.Generator(device=device).manual_seed(seed + 210)
    prior, simulator, truth = linear_gaussian_task(torch, device, 2)
    x_o = torch.zeros(1, 2, device=device)
    inference = NPE(prior=prior, density_estimator=posterior_nn("mdn", device=device))
    proposal, rounds = prior, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r in range(2):
            theta = proposal.sample((MOG_ROUND_SIMS,), generator=gen)
            inference.append_simulations(theta, simulator(theta, generator=gen),
                                         proposal=None if r == 0 else proposal)
            _, t = sync_time(torch, lambda: inference.train(
                training_batch_size=100, max_num_epochs=MDN_MAX_EPOCHS, generator=gen))
            proposal = inference.build_posterior().set_default_x(x_o)
            rounds.append({"round": r + 1, "train_s": t,
                           "epochs": inference.summary["epochs_trained"][-1],
                           "non_atomic": inference.use_non_atomic_loss})
    check(inference.use_non_atomic_loss, "round 2 did not take the non-atomic MoG loss")
    # One more round-2 step, every host sync refused: the loss (MoG product
    # of the net's and the proposal's MoGs), its backward, the clip, Adam.
    loss_fn = inference._make_loss_fn(inference._proposal_roundwise[-1], None, False)
    theta, x, _ = inference.get_simulations(inference._round)
    masks = torch.zeros(100, device=device)
    params = [p for p in inference._neural_net.net.parameters() if p.requires_grad]
    torch.cuda.synchronize() if device.type == "cuda" else None
    with no_host_sync(torch, device):
        loss = inference._train_step(loss_fn, (theta[:100], x[:100], masks), gen, params, 5.0, None)
    check(bool(torch.isfinite(loss)), "non-finite MoG loss")
    score, samples = c2st_against_truth(torch, proposal, truth, x_o, gen)
    emit("snpe_c_mog_two_rounds", simulations_per_round=MOG_ROUND_SIMS, rounds=rounds,
         strict_step_loss=float(loss), c2st=score, c2st_bar=MOG_C2ST_MAX)
    check(score <= MOG_C2ST_MAX, f"SNPE-C MoG C2ST {score}")


def snpe_a_two_rounds(torch, device, seed):
    """NPE-A on the 2-D linear Gaussian: one Gaussian component in round 1,
    the head expanded to 10 for the final round, the posterior corrected
    for its NPE-A proposal (10 x 1 pairwise quotients). Samples and
    log-probs must be finite; the C2ST is reported, with no bar."""
    import warnings

    from sbi_tpu_torch.inference import NPE_A, NPE_A_Posterior

    gen = torch.Generator(device=device).manual_seed(seed + 220)
    prior, simulator, truth = linear_gaussian_task(torch, device, 2)
    x_o = torch.zeros(1, 2, device=device)
    inference = NPE_A(prior=prior, num_components=10)
    proposal, rounds = prior, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r in range(2):
            theta = proposal.sample((MOG_ROUND_SIMS,), generator=gen)
            inference.append_simulations(theta, simulator(theta, generator=gen),
                                         proposal=None if r == 0 else proposal)
            _, t = sync_time(torch, lambda: inference.train(
                final_round=r == 1, training_batch_size=100, max_num_epochs=MDN_MAX_EPOCHS,
                generator=gen))
            proposal = inference.build_posterior().set_default_x(x_o)
            rounds.append({"round": r + 1, "train_s": t,
                           "epochs": inference.summary["epochs_trained"][-1],
                           "components": inference._neural_net.net.num_components})
    check(isinstance(proposal, NPE_A_Posterior) and isinstance(proposal.proposal, NPE_A_Posterior),
          "NPE-A did not chain its proposal")
    score, samples = c2st_against_truth(torch, proposal, truth, x_o, gen)
    lp = proposal.log_prob(samples)
    check(bool(torch.isfinite(lp).all()), "non-finite NPE-A log_prob")
    emit("snpe_a_two_rounds", simulations_per_round=MOG_ROUND_SIMS, rounds=rounds, c2st=score,
         c2st_bar=None)


def mdn_ensemble(torch, device, seed, data):
    """``train_ensemble`` of MDN members (the 10-D MDN's width) on the 10-D
    data as one vmapped program; the mixture's ``sample`` and ``log_prob``
    must be finite."""
    import warnings

    from sbi_tpu_torch.inference import NPE
    from sbi_tpu_torch.neural_nets import posterior_nn

    prior, theta, x = data
    gen = torch.Generator(device=device).manual_seed(seed + 230)
    inference = NPE(prior=prior, density_estimator=posterior_nn(
        "mdn", num_components=MDN_COMPONENTS, hidden_features=MDN_HIDDEN, device=device))
    inference.append_simulations(theta, x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        members, t_train = sync_time(torch, lambda: inference.train_ensemble(
            num_members=MDN_MEMBERS, training_batch_size=MDN_BATCH,
            max_num_epochs=MDN_ENS_EPOCHS, generator=gen))
    posterior = inference.build_ensemble_posterior()
    x0 = torch.zeros(1, MDN_DIM, device=device)
    samples = posterior.sample((MDN_DRAWS,), x=x0, generator=gen)
    lp = posterior.log_prob(samples, x=x0)
    check(len(members) == MDN_MEMBERS and bool(torch.isfinite(samples).all())
          and bool(torch.isfinite(lp).all()), "non-finite MDN ensemble sample or log_prob")
    steps = MDN_ENS_EPOCHS * (len(inference._train_indices) // MDN_BATCH)
    emit("mdn_ensemble", members=MDN_MEMBERS, epochs=MDN_ENS_EPOCHS, train_s=t_train,
         ensemble_steps_per_s=steps / t_train, member_steps_per_s=MDN_MEMBERS * steps / t_train,
         validation_loss=inference.summary["validation_loss"])


# ---------------------------------------------------------------------------
# Vector fields: FMPE and NPSE
# ---------------------------------------------------------------------------


def vf_data(seed):
    """The 2-D linear Gaussian's inputs, drawn with numpy from ``seed``:
    VF_SIMS theta from N(0, I), x = theta - 1 + N(0, 0.3 I), and VF_DRAWS
    draws from the analytic posterior at x_o = 0, N((x_o + 1) / 1.3, 0.3 /
    1.3 I)."""
    import numpy as np

    rng = np.random.default_rng(seed + 300)
    theta = rng.standard_normal((VF_SIMS, 2)).astype(np.float32)
    x = (theta + MDN_SHIFT + math.sqrt(MDN_LIK_VAR) * rng.standard_normal((VF_SIMS, 2))
         ).astype(np.float32)
    post_var = 1.0 / (1.0 + 1.0 / MDN_LIK_VAR)
    ref = (post_var / MDN_LIK_VAR * -MDN_SHIFT
           + math.sqrt(post_var) * rng.standard_normal((VF_DRAWS, 2))).astype(np.float32)
    return theta, x, ref


def cnn_data(seed):
    """BASELINE config 4's inputs, drawn with numpy from ``seed``: CNN_SIMS
    theta from N(0, I), x = A theta + 0.3 + N(0, I) with A = [sin(2 pi t),
    cos(4 pi t)] at t = i / 32; x_o = 0.3 (theta = 0); VF_DRAWS draws from
    the analytic posterior N(S A^T (x_o - 0.3), S), S = (I + A^T A)^-1, and as
    many from the control, its mean moved VF_CONTROL_SHIFT_SD posterior
    standard deviations in every coordinate."""
    import numpy as np

    rng = np.random.default_rng(seed + 310)
    t = np.arange(CNN_L) / CNN_L
    A = np.stack([np.sin(2 * np.pi * t), np.cos(4 * np.pi * t)], axis=1)
    theta = rng.standard_normal((CNN_SIMS, 2))
    x = theta @ A.T + 0.3 + rng.standard_normal((CNN_SIMS, CNN_L))
    x_o = np.full((1, CNN_L), 0.3)
    cov = np.linalg.inv(np.eye(2) + A.T @ A)
    mean = cov @ A.T @ (x_o[0] - 0.3)
    chol = np.linalg.cholesky(cov)
    ref = mean + rng.standard_normal((VF_DRAWS, 2)) @ chol.T
    control = (mean + VF_CONTROL_SHIFT_SD * np.sqrt(np.diag(cov))
               + rng.standard_normal((VF_DRAWS, 2)) @ chol.T)
    return tuple(a.astype(np.float32) for a in (theta, x, x_o, ref, control))


def vf_train(torch, inference, theta, x, batch, patience, max_epochs, gen):
    """``append_simulations(...).train(...)`` to patience (capped at
    ``max_epochs``): (seconds, epochs, optimizer steps)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        _, t = sync_time(torch, lambda: inference.append_simulations(theta, x).train(
            training_batch_size=batch, stop_after_epochs=patience, max_num_epochs=max_epochs,
            generator=gen))
    return t, inference.summary["epochs_trained"][-1], inference._opt_steps


def vf_linear_gaussian(torch, device, seed):
    """FMPE and NPSE-VE on the 2-D linear Gaussian (tests/test_vector_field.py):
    C2ST of the default sampler's draws at x_o = 0 (NPSE: the reverse SDE,
    500 steps; FMPE: the ODE) and of the ODE's, gated at VF_C2ST_MAX;
    log_prob of 20 reference draws; sample_batched over three observations,
    means increasing with x."""
    from sbi_tpu_torch.inference import FMPE, NPSE
    from sbi_tpu_torch.utils import MultivariateNormal, c2st_torch

    theta, x, ref = (torch.as_tensor(a, device=device) for a in vf_data(seed))
    prior = MultivariateNormal(torch.zeros(2, device=device),
                               covariance_matrix=torch.eye(2, device=device), device=device)
    x_o = torch.zeros(1, 2, device=device)
    xs = torch.tensor([[-2.0, -2.0], [0.0, 0.0], [2.0, 2.0]], device=device)
    results = {}
    for i, (name, make) in enumerate((("fmpe", lambda: FMPE(prior=prior)),
                                      ("npse_ve", lambda: NPSE(prior=prior, sde_type="ve")))):
        gen = torch.Generator(device=device).manual_seed(seed + 320 + i)
        inference = make()
        t_train, epochs, steps = vf_train(torch, inference, theta, x, VF_BATCH, VF_PATIENCE,
                                          VF_MAX_EPOCHS, gen)
        posterior = inference.build_posterior()
        samples, t_sample = sync_time(torch, lambda: posterior.sample((VF_DRAWS,), x=x_o,
                                                                      generator=gen))
        ode, t_ode = sync_time(torch, lambda: posterior.sample_via_ode((VF_DRAWS,), x=x_o,
                                                                       generator=gen))
        lp = posterior.log_prob(ref[:20], x=x_o)
        batched = posterior.sample_batched((VF_DRAWS // 10,), x=xs, generator=gen,
                                           steps=VF_BATCHED_STEPS)
        check(samples.shape == (VF_DRAWS, 2) and ode.shape == (VF_DRAWS, 2)
              and batched.shape == (VF_DRAWS // 10, 3, 2), f"{name}: shapes")
        for what, t in (("sample", samples), ("ode", ode), ("log_prob", lp), ("batched", batched)):
            check(bool(torch.isfinite(t).all()), f"{name}: non-finite {what}")
        means = batched.mean(0)
        results[name] = {
            "epochs": epochs, "max_epochs": VF_MAX_EPOCHS, "train_s": t_train,
            "steps_per_s": steps / t_train, "sample_with": posterior.sample_with,
            "c2st": float(c2st_torch(samples, ref, generator=gen)),
            "c2st_ode": float(c2st_torch(ode, ref, generator=gen)),
            "sample_s": t_sample, "ode_sample_s": t_ode,
            "batched_means": means.tolist(),
            "batched_means_increase": bool((means[2] > means[1]).all() and (means[1] > means[0]).all()),
            "log_prob_mean": float(lp.mean()),
        }
    emit("vf_linear_gaussian", simulations=VF_SIMS, batch=VF_BATCH, patience=VF_PATIENCE,
         draws=VF_DRAWS, c2st_bar=VF_C2ST_MAX, batched_steps=VF_BATCHED_STEPS, **results)
    for name, r in results.items():
        check(r["c2st"] <= VF_C2ST_MAX and r["c2st_ode"] <= VF_C2ST_MAX, f"{name} C2ST {r}")
        check(r["batched_means_increase"], f"{name}: sample_batched means {r['batched_means']}")


def fmpe_cnn_highdim(torch, device, seed):
    """BASELINE config 4: FMPE with a CNN embedding on a 32-D x, to
    patience. C2ST at x_o against the analytic posterior, gated at
    CNN_C2ST_MAX beside the control; train steps/s; ODE sample and log_prob
    rates at CNN_RATE_DRAWS; a training step and a few RK4 steps (of the
    state, and of the state with the exact divergence) with every host sync
    refused; one profiled epoch."""
    import warnings

    from sbi_tpu_torch.inference import FMPE
    from sbi_tpu_torch.neural_nets import posterior_flow_nn
    from sbi_tpu_torch.neural_nets.embedding_nets import CNNEmbedding
    from sbi_tpu_torch.samplers.ode import odeint_rk4, odeint_with_logdet
    from sbi_tpu_torch.utils import MultivariateNormal, c2st_torch

    theta, x, x_o, ref, control = (torch.as_tensor(a, device=device) for a in cnn_data(seed))
    prior = MultivariateNormal(torch.zeros(2, device=device),
                               covariance_matrix=torch.eye(2, device=device), device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 330)
    embedding = CNNEmbedding(input_shape=(CNN_L,), output_dim=16, out_channels_per_layer=(32, 64),
                             num_linear_units=100)
    inference = FMPE(prior=prior, density_estimator=posterior_flow_nn(
        embedding_net=embedding, hidden_features=CNN_HIDDEN, device=device,
        generator=torch.Generator().manual_seed(seed + 330)))
    t_train, epochs, steps = vf_train(torch, inference, theta, x, CNN_BATCH, CNN_PATIENCE,
                                      CNN_MAX_EPOCHS, gen)
    est = inference._neural_net
    best_validation_loss = inference.summary["best_validation_loss"][-1]
    posterior = inference.build_posterior()
    posterior.sample((100,), x=x_o, generator=gen)  # warm-up
    samples, t_sample = sync_time(torch, lambda: posterior.sample((CNN_RATE_DRAWS,), x=x_o,
                                                                  generator=gen))
    lp, t_lp = sync_time(torch, lambda: posterior.log_prob(samples, x=x_o))
    check(samples.shape == (CNN_RATE_DRAWS, 2) and bool(torch.isfinite(samples).all())
          and bool(torch.isfinite(lp).all()), "config 4: non-finite sample or log_prob")
    score = float(c2st_torch(samples[:VF_DRAWS], ref, generator=gen))
    control_score = float(c2st_torch(control, ref, generator=gen))

    # With every host sync refused: one training step, then RK4 steps.
    params = [p for p in est.net.parameters() if p.requires_grad]
    masks = torch.ones(CNN_BATCH, device=device)
    node = posterior.potential_fn.neural_ode(x_o)
    z0 = torch.randn((CNN_RATE_DRAWS, 2), generator=gen, device=device)
    torch.cuda.synchronize() if device.type == "cuda" else None
    with no_host_sync(torch, device):
        loss = inference._train_step(lambda tb, xb, mb, g: est.loss(tb, xb, generator=g),
                                     (theta[:CNN_BATCH], x[:CNN_BATCH], masks), gen, params,
                                     5.0, None)
        with torch.no_grad():
            z1 = odeint_rk4(node.ode_fn, z0, node.t_noise, node.t_data, STRICT_RK4_STEPS)
            _, logdet = odeint_with_logdet(node.ode_fn, z0[:100], node.t_data, node.t_noise,
                                           STRICT_RK4_STEPS)
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(z1).all())
          and bool(torch.isfinite(logdet).all()), "config 4: non-finite strict step")

    steps0 = inference._opt_steps
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        epoch_profile = device_breakdown(torch, lambda: inference.train(
            training_batch_size=CNN_BATCH, max_num_epochs=1, resume_training=True, generator=gen))
    epoch_profile["steps"] = inference._opt_steps - steps0
    emit("fmpe_cnn_highdim", simulations=CNN_SIMS, x_dim=CNN_L, hidden=CNN_HIDDEN,
         batch=CNN_BATCH, patience=CNN_PATIENCE,
         params=sum(p.numel() for p in est.net.parameters()), epochs=epochs,
         max_epochs=CNN_MAX_EPOCHS, early_stopped=epochs < CNN_MAX_EPOCHS, train_s=t_train,
         steps_per_s=steps / t_train,
         best_validation_loss=best_validation_loss,
         sample_with=posterior.sample_with, c2st=score, c2st_bar=CNN_C2ST_MAX,
         control={"mean_shift_sd": VF_CONTROL_SHIFT_SD, "c2st": control_score},
         ode_sample_draws=CNN_RATE_DRAWS, ode_sample_s=t_sample,
         ode_samples_per_s=CNN_RATE_DRAWS / t_sample, log_prob_s=t_lp,
         log_probs_per_s=CNN_RATE_DRAWS / t_lp,
         sde_samples_per_s=None, sde_note="flow matching defines no SDE: its posterior samples "
                                          "by the ODE (diffuser_sampling times the SDE)",
         strict_step_loss=float(loss), strict_rk4_steps=STRICT_RK4_STEPS,
         profiled_epoch=epoch_profile)
    check(control_score > CNN_C2ST_MAX, f"config 4: the control passes the gate: {control_score}")
    check(score <= CNN_C2ST_MAX, f"config 4 C2ST {score}")


def diffuser_sampling(torch, device, seed):
    """bench.py's diffuser_sampling: a VP score estimator with fresh
    weights (theta 5-D, x 8-D), 500 Euler-Maruyama steps for 1,024 samples.
    samples/s, host us a step, device operations a step and the busy share
    of one profiled run; then STRICT_DIFFUSER_STEPS steps, with and
    without the Langevin corrector, with every host sync refused."""
    from sbi_tpu_torch.neural_nets import posterior_score_nn
    from sbi_tpu_torch.samplers.score import Diffuser

    gen = torch.Generator(device=device).manual_seed(seed + 340)
    theta = torch.randn((512, DIFFUSER_THETA_DIM), generator=gen, device=device)
    x = torch.randn((512, DIFFUSER_X_DIM), generator=gen, device=device)
    est = posterior_score_nn(sde_type="vp", device=device,
                             generator=torch.Generator().manual_seed(seed + 340))(theta, x)
    diffuser, x_o = Diffuser(est), x[:1]

    def run():
        return diffuser.run(DIFFUSER_SAMPLES, x_o, steps=DIFFUSER_STEPS, generator=gen)

    run()  # warm-up
    samples, t = sync_time(torch, run)
    check(samples.shape == (DIFFUSER_SAMPLES, 1, DIFFUSER_THETA_DIM)
          and bool(torch.isfinite(samples).all()), "diffuser_sampling: non-finite samples")
    profile = device_breakdown(torch, run)
    strict = {}
    for corrector in (None, "langevin"):
        d = Diffuser(est, corrector=corrector)
        torch.cuda.synchronize() if device.type == "cuda" else None
        with no_host_sync(torch, device):
            out = d.run(DIFFUSER_SAMPLES, x_o, steps=STRICT_DIFFUSER_STEPS + 1, generator=gen)
        check(bool(torch.isfinite(out).all()), f"diffuser_sampling: non-finite strict run {corrector}")
        strict[str(corrector)] = STRICT_DIFFUSER_STEPS
    emit("diffuser_sampling", sde_type="vp", theta_dim=DIFFUSER_THETA_DIM, x_dim=DIFFUSER_X_DIM,
         steps=DIFFUSER_STEPS, num_samples=DIFFUSER_SAMPLES, run_s=t,
         samples_per_sec=DIFFUSER_SAMPLES / t, host_us_per_step=t / DIFFUSER_STEPS * 1e6,
         device_ops_per_step=profile["device_ops"] / DIFFUSER_STEPS, profiled_run=profile,
         strict_steps_by_corrector=strict)


# ---------------------------------------------------------------------------
# NRE
# ---------------------------------------------------------------------------


def nre_gate(scores):
    return sum(scores) / len(scores) <= NRE_C2ST_MEAN_MAX and max(scores) <= NRE_C2ST_EACH_MAX


def nre_control(torch, ref, n, gen):
    """C2ST of ``n`` reference draws jittered by NRE_CONTROL_JITTER against
    ``n`` others: the control that must fail the gate."""
    from sbi_tpu_torch.utils import c2st_torch

    jittered = ref[n: 2 * n] + NRE_CONTROL_JITTER * torch.randn(n, ref.shape[-1], generator=gen,
                                                                device=ref.device)
    return float(c2st_torch(jittered, ref[:n], generator=gen))


def nre_two_moons(torch, fsm, device, seed):
    """two_moons NRE_B at the round-2 recipe: train steps/s, the device-busy
    share of one profiled epoch (of a copy of the trainer), then observations
    0-2 in one ``sample_batched`` run, scored by C2ST beside the control.
    Returns the trainer."""
    import copy
    import warnings

    from sbi_tpu_torch.inference import NRE_B, simulate_for_sbi
    from sbi_tpu_torch.simulators import get_task
    from sbi_tpu_torch.utils import c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 300)
    task = get_task("two_moons", device=device)
    theta, x = simulate_for_sbi(task.simulator, task.prior, NRE_SIMS, generator=gen)
    inference = NRE_B(prior=task.prior)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Maximum number of epochs reached"
        _, t_train = sync_time(torch, lambda: inference.append_simulations(theta, x).train(
            num_atoms=NRE_ATOMS, training_batch_size=NRE_BATCH, max_num_epochs=NRE_MAX_EPOCHS,
            generator=gen))
        steps, epochs = inference._opt_steps, inference.summary["epochs_trained"][-1]
        net = inference._neural_net.net
        check(type(net).__name__ == "ResNetClassifierModule" and len(net.blocks) == 2
              and net.inp.out_features == 50, f"classifier {net}")
        clone = copy.deepcopy(inference)
        profiled = device_breakdown(torch, lambda: clone.train(
            num_atoms=NRE_ATOMS, training_batch_size=NRE_BATCH, max_num_epochs=1,
            resume_training=True, generator=gen))
    losses = inference.summary["validation_loss"]
    check(all(math.isfinite(v) for v in losses) and min(losses) < losses[0], f"NRE losses {losses}")

    posterior = inference.build_posterior(mcmc_parameters=dict(
        num_chains=NRE_CHAINS, warmup_steps=NRE_WARMUP, thin=NRE_THIN))
    observations, references = reference_posteriors("two_moons")
    xs = torch.as_tensor(observations, device=device)
    with FsmCounts(torch, fsm) as counts:
        draws, t_sample = sync_time(torch, lambda: posterior.sample_batched(
            (NRE_DRAWS,), x=xs, generator=gen, num_chains=NRE_CHAINS,
            num_init_candidates=NRE_INIT_CANDIDATES))
    check(tuple(draws.shape) == (NRE_DRAWS, len(observations), 2), f"NRE draws {tuple(draws.shape)}")
    check(bool(torch.isfinite(draws).all()), "non-finite NRE sample")
    check(bool(task.prior.within_support(draws.reshape(-1, 2)).all()), "NRE sample outside the prior")
    refs = [torch.as_tensor(r, device=device) for r in references]
    scores = [float(c2st_torch(draws[:, i], ref[:NRE_DRAWS], generator=gen)) for i, ref in enumerate(refs)]
    controls = [nre_control(torch, ref, NRE_DRAWS, gen) for ref in refs]
    emit("nre_two_moons", simulations=NRE_SIMS, classifier="resnet", hidden=50, blocks=2,
         atoms=NRE_ATOMS, batch=NRE_BATCH, epochs=epochs, max_epochs=NRE_MAX_EPOCHS,
         patience=20, early_stopped=epochs < NRE_MAX_EPOCHS,
         cut=f"patience 20 (the recipe's 150), at most {NRE_MAX_EPOCHS} epochs",
         train_s=t_train, steps=steps, steps_per_s=steps / t_train,
         best_validation_loss=inference.summary["best_validation_loss"][-1],
         profiled_epoch=profiled, chains=NRE_CHAINS, warmup=NRE_WARMUP, thin=NRE_THIN,
         init_candidates=NRE_INIT_CANDIDATES, draws=NRE_DRAWS, sample_batched_s=t_sample,
         **counts.fields(t_sample), c2st=scores, c2st_mean=sum(scores) / len(scores),
         control_c2st=controls,
         control_c2st_mean=sum(controls) / len(controls), control_jitter=NRE_CONTROL_JITTER,
         c2st_bar={"mean": NRE_C2ST_MEAN_MAX, "each": NRE_C2ST_EACH_MAX},
         target_mean_bar=NRE_C2ST_MEAN_TARGET,
         met_target_mean_bar=sum(scores) / len(scores) <= NRE_C2ST_MEAN_TARGET,
         sbi_tpu_reference=SBI_TPU_NRE_TWO_MOONS)
    check(nre_gate(scores), f"NRE two_moons C2ST {scores}")
    check(not nre_gate(controls), f"the control passed the gate: {controls}")
    return inference


def nre_slice(torch, fsm, device, seed, inference):
    """``nre_slice_samples_per_sec``: nle_slcp's sampling configuration
    (1,000 chains, warmup 10, 5 samples a chain) on the trained ratio at
    observation 0: a warm run with every host sync but the loop
    condition's refused, a timed run and a profiled one."""
    gen = torch.Generator(device=device).manual_seed(seed + 310)
    posterior = inference.build_posterior()
    x_o = torch.as_tensor(reference_posteriors("two_moons")[0][0], device=device)

    def sample():
        return posterior.sample((NLE_CHAINS * NLE_SAMPLES,), x=x_o, generator=gen,
                                num_chains=NLE_CHAINS, warmup_steps=NLE_WARMUP)

    with FsmCounts(torch, fsm, strict=device.type == "cuda"):
        sample()
    with FsmCounts(torch, fsm) as counts:
        samples, seconds = sync_time(torch, sample)
    with FsmCounts(torch, fsm) as profiled_counts:
        profiled = device_breakdown(torch, sample)
    check(tuple(samples.shape) == (NLE_CHAINS * NLE_SAMPLES, 2), f"NRE samples {tuple(samples.shape)}")
    check(bool(torch.isfinite(samples).all()), "non-finite NRE sample")
    emit("nre_slice", chains=NLE_CHAINS, warmup=NLE_WARMUP, samples_per_chain=NLE_SAMPLES,
         seconds=seconds, nre_slice_samples_per_sec=NLE_CHAINS * NLE_SAMPLES / seconds,
         **counts.fields(seconds),
         device_ops_per_iteration=profiled["device_ops"] / max(profiled_counts.iterations, 1),
         profiled_run=profiled)


def nre_rejection_importance(torch, device, seed, inference):
    """``sample_with="rejection"`` and ``"importance"`` (SIR) on the
    trained two_moons ratio at observation 0: C2ST beside the control, the
    acceptance rate, the importance ESS and the PSIS k-hat; the rejection
    sampler's ascent with every host sync refused."""
    from sbi_tpu_torch.samplers.importance import importance_resampling_weights_ess
    from sbi_tpu_torch.samplers.rejection import ascend_log_ratio, rejection_sample
    from sbi_tpu_torch.utils import c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 320)
    observations, references = reference_posteriors("two_moons")
    x_o = torch.as_tensor(observations[0], device=device)
    ref = torch.as_tensor(references[0], device=device)
    rejection = inference.build_posterior(sample_with="rejection")
    importance = inference.build_posterior(
        sample_with="importance",
        importance_sampling_parameters=dict(oversampling_factor=NRE_SIR_OVERSAMPLING))
    out = {}
    for name, posterior in (("rejection", rejection), ("importance", importance)):
        samples, t = sync_time(torch, lambda: posterior.sample((NRE_IS_DRAWS,), x=x_o, generator=gen))
        check(tuple(samples.shape) == (NRE_IS_DRAWS, 2) and bool(torch.isfinite(samples).all()),
              f"{name} samples")
        out[name] = {"seconds": t, "c2st": float(c2st_torch(samples, ref[:NRE_IS_DRAWS], generator=gen))}
    _, rate = rejection_sample(rejection.potential_fn, rejection.proposal, generator=gen,
                               num_samples=NRE_IS_DRAWS)
    _, log_w = importance.sample_with_weights(NRE_PSIS_DRAWS, x=x_o, generator=gen)
    k_hat = importance.evaluate(x=x_o, num_samples=NRE_PSIS_DRAWS, generator=gen)
    start = rejection.proposal.sample((1,), generator=gen)
    with no_host_sync(torch, device):
        end = ascend_log_ratio(rejection.potential_fn, rejection.proposal, start)
    check(bool(torch.isfinite(end).all()), "non-finite ascent")
    control = nre_control(torch, ref, NRE_IS_DRAWS, gen)
    emit("nre_rejection_importance", observation=0, draws=NRE_IS_DRAWS, **out,
         acceptance_rate=float(rate), sir_oversampling=NRE_SIR_OVERSAMPLING,
         importance_ess=float(importance_resampling_weights_ess(log_w)),
         importance_draws=NRE_PSIS_DRAWS, psis_k_hat=k_hat, control_c2st=control,
         ascent_without_host_sync=True,
         c2st_bar={"mean": NRE_C2ST_MEAN_MAX, "each": NRE_C2ST_EACH_MAX})
    check(all(nre_gate([v["c2st"]]) for v in out.values()), f"rejection / importance C2ST {out}")
    check(not nre_gate([control]), f"the control passed the gate: {control}")


def nre_linear_gaussian(torch, device, seed):
    """NRE_A, NRE_C and BNRE at the JAX package's slow-test recipe."""
    import warnings

    from sbi_tpu_torch.inference import BNRE, NRE_A, NRE_C
    from sbi_tpu_torch.utils import c2st_torch

    gen = torch.Generator(device=device).manual_seed(seed + 330)
    prior, simulator, truth = linear_gaussian_task(torch, device, 2)
    theta = prior.sample((NRE_LG_SIMS,), generator=gen)
    x = simulator(theta, generator=gen)
    x_o = torch.zeros(1, 2, device=device)
    ref = truth(x_o).sample((NRE_LG_DRAWS,), generator=gen)
    results = {}
    for cls in (NRE_A, NRE_C, BNRE):
        inference = cls(prior=prior)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, t_train = sync_time(torch, lambda: inference.append_simulations(theta, x).train(
                training_batch_size=NRE_LG_BATCH, max_num_epochs=NRE_LG_MAX_EPOCHS, generator=gen))
        posterior = inference.build_posterior(mcmc_parameters=dict(
            num_chains=NRE_LG_CHAINS, warmup_steps=NRE_LG_WARMUP))
        samples, t_sample = sync_time(torch, lambda: posterior.sample(
            (NRE_LG_DRAWS,), x=x_o, generator=gen))
        check(bool(torch.isfinite(samples).all()), f"non-finite {cls.__name__} sample")
        results[cls.__name__] = {
            "epochs": inference.summary["epochs_trained"][-1], "train_s": t_train,
            "steps_per_s": inference._opt_steps / t_train, "sample_s": t_sample,
            "c2st": float(c2st_torch(samples, ref, generator=gen)),
            "mean_variance": float(samples.var(0).mean())}
    bnre_floor = 0.5 * MDN_LIK_VAR / (1.0 + MDN_LIK_VAR)
    emit("nre_linear_gaussian", simulations=NRE_LG_SIMS, batch=NRE_LG_BATCH,
         max_epochs=NRE_LG_MAX_EPOCHS, chains=NRE_LG_CHAINS, warmup=NRE_LG_WARMUP,
         draws=NRE_LG_DRAWS, c2st_tolerance=NRE_LG_C2ST_TOL, bnre_variance_floor=bnre_floor,
         true_variance=MDN_LIK_VAR / (1.0 + MDN_LIK_VAR), results=results)
    for name in ("NRE_A", "NRE_C"):
        check(abs(results[name]["c2st"] - 0.5) <= NRE_LG_C2ST_TOL, f"{name} C2ST {results[name]}")
    check(results["BNRE"]["mean_variance"] > bnre_floor, f"BNRE variance {results['BNRE']}")
    return prior, simulator, theta, x


def snre_two_rounds(torch, device, seed):
    """Two rounds of SNRE_B on two_moons: the second round's simulations
    come from the first round's posterior at observation 0."""
    import warnings

    from sbi_tpu_torch.inference import SNRE_B
    from sbi_tpu_torch.simulators import get_task

    gen = torch.Generator(device=device).manual_seed(seed + 340)
    task = get_task("two_moons", device=device)
    x_o = torch.as_tensor(reference_posteriors("two_moons")[0][0], device=device)
    inference = SNRE_B(prior=task.prior)
    proposal = task.prior
    t0 = time.perf_counter()
    for epochs in SNRE_EPOCHS:
        theta = proposal.sample((SNRE_ROUND_SIMS,), generator=gen)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            inference.append_simulations(theta, task.simulator(theta, generator=gen),
                                         proposal=proposal).train(max_num_epochs=epochs, generator=gen)
        proposal = inference.build_posterior(
            mcmc_parameters=dict(num_chains=100, warmup_steps=100)).set_default_x(x_o)
    samples = proposal.sample((500,), generator=gen)
    torch.cuda.synchronize() if device.type == "cuda" else None
    check(inference._data_round_index == [0, 1], f"rounds {inference._data_round_index}")
    check(tuple(samples.shape) == (500, 2) and bool(torch.isfinite(samples).all())
          and bool(task.prior.within_support(samples).all()), "SNRE_B round-2 samples")
    emit("snre_two_rounds", simulations_per_round=SNRE_ROUND_SIMS, max_epochs=list(SNRE_EPOCHS),
         epochs=inference.summary["epochs_trained"], seconds=time.perf_counter() - t0)


def nre_ensemble(torch, device, seed, data):
    """An NRE_B ensemble through ``train_ensemble`` on the linear
    Gaussian's data: its posterior's potential must take the stacked (one
    vmap) route and equal the members' own potentials; mixture and
    product-of-experts draws; one ensemble step with every host sync
    refused."""
    import warnings

    from sbi_tpu_torch.inference import NRE_B
    from sbi_tpu_torch.inference.trainers.base import ensemble_grad_and_loss, ensemble_step

    prior, _, theta, x = data
    gen = torch.Generator(device=device).manual_seed(seed + 350)
    inference = NRE_B(prior=prior)
    inference.append_simulations(theta, x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        members, t_train = sync_time(torch, lambda: inference.train_ensemble(
            num_members=NRE_ENS_MEMBERS, training_batch_size=NRE_BATCH,
            max_num_epochs=NRE_ENS_EPOCHS, epoch_chunk=NRE_ENS_EPOCHS, generator=gen))
    x_o = torch.zeros(1, 2, device=device)
    mcmc = dict(num_chains=100, warmup_steps=50)
    posterior = inference.build_ensemble_posterior(mcmc_parameters=mcmc)
    check(posterior.potential_fn.vmapped, "the NRE ensemble's potential is not the stacked route")
    potential = posterior.potential_fn.set_x(x_o)
    th = prior.sample((256,), generator=gen)
    with torch.no_grad():
        stacked = potential.member_potentials(th)
        one_by_one = torch.stack([p.potential_fn(th) for p in posterior.posteriors])
    stacked_err = float((stacked - one_by_one).abs().max())
    check(stacked_err <= 1e-4 * float(one_by_one.abs().max()), f"stacked != members: {stacked_err}")
    samples = posterior.sample((500,), x=x_o, generator=gen)
    poe = inference.build_ensemble_posterior(potential_combination="product")
    poe_samples, t_poe = sync_time(torch, lambda: poe.sample((500,), x=x_o, generator=gen, **mcmc))
    check(bool(torch.isfinite(samples).all()) and bool(torch.isfinite(poe_samples).all()),
          "non-finite NRE ensemble sample")

    template = members[0]
    params = {k: v.clone() for k, v in inference._ensemble_stacked_state.items()}
    opt = torch.optim.Adam(list(params.values()), lr=5e-4, betas=(0.9, 0.999), eps=1e-8, foreach=True)
    grad_and_loss = ensemble_grad_and_loss(template.net, inference._ensemble_loss_fn(template))
    idx = torch.randint(theta.shape[0], (NRE_ENS_MEMBERS, NRE_LG_BATCH), generator=gen, device=device)
    batch = (theta[idx], x[idx], torch.ones(idx.shape, device=device))
    batch += inference._ensemble_extra_inputs(batch[0], gen, False)
    with no_host_sync(torch, device):
        loss = ensemble_step(grad_and_loss, params, opt, batch, 5.0)
    check(bool(torch.isfinite(loss).all()), f"ensemble step loss {loss}")
    steps = NRE_ENS_EPOCHS * (len(inference._train_indices) // NRE_BATCH)
    emit("nre_ensemble", members=NRE_ENS_MEMBERS, epochs=NRE_ENS_EPOCHS, train_s=t_train,
         ensemble_steps_per_s=steps / t_train, validation_loss=inference.summary["validation_loss"],
         potential_route="stacked", stacked_vs_members_max_abs_err=stacked_err,
         poe_sample_s=t_poe, step_without_host_sync=True)


def nre_phases(torch, fsm, device, seed):
    """The NRE path: two_moons NRE_B and its three samplers, the linear
    Gaussian's NRE_A, NRE_C and BNRE, two rounds of SNRE_B, an ensemble."""
    t0 = time.perf_counter()
    inference = nre_two_moons(torch, fsm, device, seed)
    nre_slice(torch, fsm, device, seed, inference)
    nre_rejection_importance(torch, device, seed, inference)
    data = nre_linear_gaussian(torch, device, seed)
    snre_two_rounds(torch, device, seed)
    nre_ensemble(torch, device, seed, data)
    emit("nre", seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU.", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from sbi_tpu_torch.ops import rqs
        from sbi_tpu_torch.utils.sbiutils import resolve_device, seed_all_backends
    except ImportError as err:
        print(f"chip_smoke: run it from the repository root ({err}).", file=sys.stderr)
        return 1

    # 1. Environment
    device = resolve_device(None)  # cuda; switches TF32 off
    seed_all_backends(args.seed)  # the global generators: weight init of the trainers' nets
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda, device=name,
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])

    # 2. Build
    t0 = time.perf_counter()
    lib = rqs.build()
    ptxas = [l.strip() for l in rqs.build_log.splitlines() if "registers" in l or "spill" in l]
    emit("build", seconds=time.perf_counter() - t0, library=os.path.basename(str(lib)), ptxas=ptxas)

    # 3. Kernels vs plain versions: both directions, values and gradients
    cases, worst, worst_backward = kernel_checks(torch, rqs, device, 300_000, args.seed)
    stress = stress_check(torch, rqs, device, 300_000, args.seed)
    torch.cuda.synchronize()
    emit("kernel_vs_plain", param_std=PARAM_STD,
         tolerance={"y_atol": Y_ATOL, "y_rtol": Y_RTOL, "ld_atol": LD_ATOL,
                    "grad_atol": GRAD_ATOL, "grad_rtol": GRAD_RTOL, "knot_gap": KNOT_GAP,
                    "stress_factor": STRESS_FACTOR, "grad_quantile": GRAD_QUANTILE},
         cases=cases, stress_max_abs_err_vs_float64=stress)

    # 4. Times at the main path's sizes. They run before the main path:
    # after the profiled training epoch, the profiler drops events.
    timings = kernel_timings(torch, rqs, device, args.seed)
    backward = backward_timings(torch, rqs, device, args.seed)
    emit("kernel_timings", timings={("inverse" if k else "forward"): v for k, v in timings.items()},
         backward=backward,
         device_ms="device time per call (torch.profiler), the kernel alone",
         time_ms="wall time per call back to back (CUDA events), host work included",
         warm="the working set (35 MB at n = 300,000) stays in the 50 MB L2, as after the conditioner writes it",
         cold=f"{FLUSH_BYTES} bytes written before each call, outside the timed span")
    # The spline's vmap rule at the ensemble step's shape: launch counts,
    # bit-for-bit checks and times (before the main paths, as above).
    merge = ensemble_merge(torch, rqs, device, args.seed)

    # 5-16. The main paths, serving, training, NLE and MCMC, ensembles, the
    # MDN family, vector fields and NRE: each path's counts are zeroed just
    # before it and read just after, and each of its kernels must have
    # launched (none on the last three).
    from sbi_tpu_torch.samplers.mcmc import slice_fsm

    trained = {}  # the two_moons NPE trainer and nle_slcp's figures, used by later paths
    paths = (
        ("serving", ("forward", "inverse"), lambda: (
            slcp_path(torch, rqs, device, args.seed),
            two_moons_path(torch, rqs, device, args.seed))),
        ("training", ("forward", "inverse", "backward"), lambda: (
            slcp_training(torch, rqs, device, args.seed),
            trained.setdefault("npe", two_moons_training(torch, rqs, device, args.seed)),
            snpe_two_rounds(torch, rqs, device, args.seed),
            maf_canonical(torch, device, args.seed))),
        ("nle_mcmc", ("forward", "backward"), lambda: (
            slice_gaussian(torch, slice_fsm, device, args.seed),
            slcp_exact_slice(torch, slice_fsm, device, args.seed),
            trained.setdefault("nle_slcp", nle_slcp(torch, rqs, slice_fsm, device, args.seed)),
            mcmc_batched(torch, rqs, device, args.seed,
                         nle_two_moons(torch, rqs, device, args.seed), trained["npe"]))),
        ("ensembles", ("forward", "inverse", "backward"), lambda: (
            npe_ens8(torch, rqs, device, args.seed),
            nle_poe_slcp(torch, rqs, slice_fsm, device, args.seed, trained["nle_slcp"]))),
        # The MDN family reaches no kernel: it must launch none.
        ("mdn", (), lambda: (
            mdn_ensemble(torch, device, args.seed, mdn_linear_gaussian_10d(torch, device, args.seed)),
            snpe_c_mog_two_rounds(torch, device, args.seed),
            snpe_a_two_rounds(torch, device, args.seed))),
        # Neither do vector fields.
        ("vector_fields", (), lambda: (
            vf_linear_gaussian(torch, device, args.seed),
            fmpe_cnn_highdim(torch, device, args.seed),
            diffuser_sampling(torch, device, args.seed))),
        # Nor the NRE family: its classifiers are dense layers.
        ("nre", (), lambda: nre_phases(torch, slice_fsm, device, args.seed)),
    )
    by_path = {}
    for path, kernels_of_path, drive in paths:
        rqs.forward_launches = rqs.inverse_launches = rqs.backward_launches = 0
        drive()
        counts = {"forward": rqs.forward_launches, "inverse": rqs.inverse_launches,
                  "backward": rqs.backward_launches}
        check(all(counts[k] > 0 for k in kernels_of_path), f"{path} path launches {counts}")
        check(kernels_of_path or not any(counts.values()), f"{path} path launched a kernel {counts}")
        by_path[path] = counts
    launches = {k: sum(c[k] for c in by_path.values()) for k in ("forward", "inverse", "backward")}
    emit("launches", by_path=by_path, total=launches)

    # 17. The kernels line
    kernels = []
    for inverse in (False, True):
        t = timings[inverse]
        direction = "inverse" if inverse else "forward"
        kernels.append({
            "name": f"rqs_spline_{direction}",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[direction],
            "launches_by_path": {p: c[direction] for p, c in by_path.items()},
            "max_abs_err": worst[inverse],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": f"n={t['n']}, K={t['K']}",
            "ms_at_mcmc_n": t["sizes"][str(NLE_CHAINS * 4)]["warm"]["device_ms"],
            "bound_ms_at_mcmc_n": t["sizes"][str(NLE_CHAINS * 4)]["bound_ms"],
            "vmap_rule": VMAP_RULE,
        })
    kernels[0].update(ms_merged_at_ensemble_n=merge["merged_device_ms"],
                      ms_separate_launches_at_ensemble_n=merge["separate_device_ms"],
                      bound_ms_at_ensemble_n=merge["bound_ms"], ensemble_n=merge["n_merged"])
    kernels.append({
        "name": "rqs_spline_backward", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES_BACKWARD, "launches": launches["backward"],
        "launches_by_path": {p: c["backward"] for p, c in by_path.items()},
        "max_abs_err": worst_backward, "ms": backward["ms"], "plain_ms": backward["plain_ms"],
        "bound_ms": backward["bound_ms"], "bound_by": backward["bound_by"], "library_ms": None,
        "shape": f"n={backward['n']}, K={backward['K']}, forward direction",
        "vmap_rule": VMAP_RULE,
    })
    emit("total", seconds=time.perf_counter() - _START)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
