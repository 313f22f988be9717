"""NLE: the neural likelihood estimation trainer.

PyTorch counterpart of ``sbi_tpu/inference/trainers/nle/nle_base.py``: the
loss is -log p(x | theta) (the estimator's input is x, its condition
theta), trained by ``NeuralInference._run_training_loop``; the posterior is
the likelihood potential times the prior, sampled by the vectorized slice
sampler (``MCMCPosterior``), by rejection or by importance sampling, or as
typed ``posterior_parameters`` describe it. ``sample_with="vi"`` comes
with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from ....neural_nets.factory import likelihood_nn
from ....utils.sbiutils import handle_invalid_x, nle_nre_apt_msg_on_invalid_x
from .._contracts import TrainConfig
from ..base import NeuralInference


class LikelihoodEstimatorTrainer(NeuralInference):
    def __init__(
        self,
        prior=None,
        density_estimator: Union[str, Callable] = "maf",
        device=None,
        logging_level="WARNING",
        summary_writer=None,
        show_progress_bars: bool = True,
        **kwargs,
    ):
        super().__init__(
            prior=prior,
            device=device,
            logging_level=logging_level,
            summary_writer=summary_writer,
            show_progress_bars=show_progress_bars,
            tracker=kwargs.pop("tracker", None),
        )
        if isinstance(density_estimator, str):
            self._build_neural_net = likelihood_nn(model=density_estimator, device=self._device)
        else:
            self._build_neural_net = density_estimator

    def append_simulations(
        self,
        theta,
        x,
        proposal=None,
        exclude_invalid_x: bool = False,
        data_device=None,
    ) -> "LikelihoodEstimatorTrainer":
        """Store one round of simulations on the trainer's device. NLE keeps
        invalid x by default, with a warning: excluding them biases the
        learned likelihood. ``data_device`` is accepted for parity."""
        _, num_nans, num_infs = handle_invalid_x(
            torch.as_tensor(x, dtype=torch.float32, device=self._device), True)
        nle_nre_apt_msg_on_invalid_x(num_nans, num_infs, exclude_invalid_x, algorithm="NLE")
        theta, x = self._validate_theta_and_x(
            theta, x, exclude_invalid_x=exclude_invalid_x, algorithm="NLE")
        current_round = 0 if proposal is None else max(self._data_round_index, default=-1) + 1
        prior_mask = torch.full((theta.shape[0],), float(current_round == 0), device=self._device)
        self._append_to_data_store(theta, x, prior_mask, current_round)
        self._proposal_roundwise.append(proposal)
        self._round = max(self._data_round_index)
        return self

    def train(
        self,
        training_batch_size: int = 200,
        learning_rate: float = 5e-4,
        validation_fraction: float = 0.1,
        stop_after_epochs: int = 20,
        max_num_epochs: int = 2**31 - 1,
        clip_max_norm: Optional[float] = 5.0,
        resume_training: bool = False,
        discard_prior_samples: bool = False,
        retrain_from_scratch: bool = False,
        show_train_summary: bool = False,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """Train the likelihood estimator and return it. ``generator`` (on
        the trainer's device) draws the split and the batches."""
        cfg = TrainConfig(
            training_batch_size=training_batch_size,
            learning_rate=learning_rate,
            validation_fraction=validation_fraction,
            stop_after_epochs=stop_after_epochs,
            max_num_epochs=max_num_epochs,
            clip_max_norm=clip_max_norm,
            resume_training=resume_training,
            retrain_from_scratch=retrain_from_scratch,
            show_train_summary=show_train_summary,
            epoch_chunk=int(kwargs.get("epoch_chunk", 1)),
            lr_schedule=kwargs.get("lr_schedule"),
            lr_decay_epochs=kwargs.get("lr_decay_epochs"),
            lr_warmup_frac=float(kwargs.get("lr_warmup_frac", 0.02)),
            lr_final_factor=float(kwargs.get("lr_final_factor", 0.01)),
            mesh=kwargs.get("mesh"),
        )
        start_idx = int(discard_prior_samples and self._round > 0)
        if self._neural_net is None or retrain_from_scratch:
            theta, x, _ = self.get_simulations(start_idx)
            self._neural_net = self._build_neural_net(theta, x)
            if self._neural_net.device != self._device:
                raise ValueError(
                    f"The density estimator lies on {self._neural_net.device}, the "
                    f"trainer on {self._device}."
                )
        return self._run_training_loop(self._loss_fn(), cfg, start_idx=start_idx,
                                       generator=generator)

    def _loss_fn(self) -> Callable:
        """``fn(theta_b, x_b, masks_b, generator) -> (B,)``: -log p(x | theta)."""
        est = self._neural_net

        def loss_fn(theta_b, x_b, masks_b, generator):
            return -est.log_prob(x_b[None], theta_b)[0]

        return loss_fn

    def _ensemble_loss_fn(self, est) -> Callable:
        """-log p(x | theta) for ``train_ensemble``."""

        def loss_fn(theta_b, x_b, masks_b):
            return -est.log_prob(x_b[None], theta_b)[0]

        return loss_fn

    def build_posterior(
        self,
        density_estimator=None,
        prior=None,
        sample_with: str = "mcmc",
        mcmc_method: str = "slice_jax_vectorized",
        mcmc_parameters: Optional[Dict] = None,
        vi_parameters: Optional[Dict] = None,
        rejection_sampling_parameters: Optional[Dict] = None,
        importance_sampling_parameters: Optional[Dict] = None,
        posterior_parameters=None,
    ):
        """The posterior of the likelihood potential of a frozen copy of
        the estimator and the prior: an ``MCMCPosterior`` (vectorized slice
        sampling by default), a ``RejectionPosterior`` or an
        ``ImportanceSamplingPosterior``."""
        from ...potentials.likelihood_based_potential import likelihood_estimator_based_potential
        from ...posteriors.posterior_parameters import (
            build_posterior_from_parameters,
            check_legacy_sampler_args,
            potential_posterior,
        )

        prior = prior if prior is not None else self._prior
        if prior is None:
            raise ValueError("NLE needs a prior to build a posterior.")
        estimator = density_estimator if density_estimator is not None else self._neural_net
        if estimator is None:
            raise ValueError("Run `.train()` first or pass a density_estimator.")
        if posterior_parameters is not None:
            check_legacy_sampler_args(
                {
                    "mcmc_parameters": mcmc_parameters,
                    "vi_parameters": vi_parameters,
                    "rejection_sampling_parameters": rejection_sampling_parameters,
                    "importance_sampling_parameters": importance_sampling_parameters,
                },
                {"sample_with": (sample_with, "mcmc"), "mcmc_method": (mcmc_method, "slice_jax_vectorized")},
            )
            self._posterior = build_posterior_from_parameters(
                posterior_parameters, estimator.snapshot(), prior, kind="nle")
            return self._posterior
        potential_fn, theta_transform = likelihood_estimator_based_potential(
            estimator.snapshot(), prior, x_o=None)
        self._posterior = potential_posterior(
            sample_with, potential_fn, theta_transform, prior, mcmc_method=mcmc_method,
            mcmc_parameters=mcmc_parameters,
            rejection_sampling_parameters=rejection_sampling_parameters,
            importance_sampling_parameters=importance_sampling_parameters)
        return self._posterior


class NLE_A(LikelihoodEstimatorTrainer):
    """SNLE-A (Papamakarios et al. 2019): the base NLE, MAF by default."""


NLE = NLE_A
SNLE = NLE_A
SNLE_A = NLE_A
SNL = NLE_A
