"""NPE family base trainer.

PyTorch counterpart of ``sbi_tpu/inference/trainers/npe/npe_base.py``:
``append_simulations(..., proposal=)`` round bookkeeping, ``train()``, the
first-round loss -log q(theta | x) (optionally weighted by a calibration
kernel), the lazy net build from the first round's data, and
``build_posterior``: ``sample_with="direct"``, ``"mcmc"``, ``"rejection"``,
``"importance"`` or ``"vi"``, or typed ``posterior_parameters``.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Any, Callable, Dict, Optional, Union

import torch

from ....neural_nets.factory import posterior_nn
from .._contracts import TrainConfig
from ..base import NeuralInference, check_if_proposal_has_default_x


class PosteriorEstimatorTrainer(NeuralInference):
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
            self._build_neural_net = posterior_nn(model=density_estimator, device=self._device)
        else:
            self._build_neural_net = density_estimator
        self._proposal_roundwise = []
        self.use_non_atomic_loss = False

    # ------------------------------------------------------------------ data
    def append_simulations(
        self,
        theta,
        x,
        proposal: Optional[Any] = None,
        exclude_invalid_x: Optional[bool] = None,
        data_device=None,
    ) -> "PosteriorEstimatorTrainer":
        """Store one round of simulations on the trainer's device. A
        proposal that is None or the prior makes it round 0; a posterior
        proposal (with a default x) starts the next round. ``data_device``
        is accepted for parity: the data always live on the trainer's
        device."""
        is_prior = proposal is None or proposal is self._prior
        if exclude_invalid_x is None:
            exclude_invalid_x = is_prior
        theta, x = self._validate_theta_and_x(
            theta, x, exclude_invalid_x, algorithm=self.__class__.__name__
        )
        if is_prior:
            current_round = 0
        else:
            check_if_proposal_has_default_x(proposal)
            current_round = max(self._data_round_index, default=-1) + 1
        prior_mask = torch.full((theta.shape[0],), float(current_round == 0), device=self._device)
        self._append_to_data_store(theta, x, prior_mask, current_round)
        self._proposal_roundwise.append(proposal)
        self._round = max(self._data_round_index)
        return self

    # ------------------------------------------------------------------ train
    def train(
        self,
        training_batch_size: int = 200,
        learning_rate: float = 5e-4,
        validation_fraction: float = 0.1,
        stop_after_epochs: int = 20,
        max_num_epochs: int = 2**31 - 1,
        clip_max_norm: Optional[float] = 5.0,
        calibration_kernel: Optional[Callable] = None,
        resume_training: bool = False,
        force_first_round_loss: bool = False,
        discard_prior_samples: bool = False,
        retrain_from_scratch: bool = False,
        show_train_summary: bool = False,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """Train the estimator and return it. ``generator`` (on the trainer's
        device) draws the split, the batches and the atoms; None takes the
        device's global generator."""
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
        start_idx = self._get_start_index(discard_prior_samples, force_first_round_loss)
        proposal = self._proposal_roundwise[-1] if self._proposal_roundwise else None

        if self._neural_net is None or retrain_from_scratch:
            theta, x, _ = self.get_simulations(start_idx)
            self._neural_net = self._build_neural_net(theta, x)
            if self._neural_net.device != self._device:
                raise ValueError(
                    f"The density estimator lies on {self._neural_net.device}, the "
                    f"trainer on {self._device}."
                )

        use_first_round_loss = self._round == 0 or force_first_round_loss
        loss_fn = self._make_loss_fn(
            proposal=proposal,
            calibration_kernel=calibration_kernel,
            force_first_round_loss=use_first_round_loss,
        )
        return self._run_training_loop(loss_fn, cfg, start_idx=start_idx, generator=generator)

    def _get_start_index(self, discard_prior_samples: bool, force_first_round_loss: bool) -> int:
        """Which rounds to train on."""
        start_idx = int(discard_prior_samples and self._round > 0)
        if self.use_non_atomic_loss and self._round > 0:
            # Non-atomic loss trains only on the latest round's data.
            start_idx = self._round
        return start_idx

    # --------------------------------------------------------------- losses
    def _make_loss_fn(self, proposal, calibration_kernel: Optional[Callable],
                      force_first_round_loss: bool) -> Callable:
        """Loss ``fn(theta_b, x_b, masks_b, generator) -> (B,)``. Round 0:
        -log q(theta | x), weighted by the calibration kernel if given. Later
        rounds: the subclass's proposal-corrected loss."""
        est = self._neural_net

        if self._round == 0 or force_first_round_loss:

            def loss_fn(theta_b, x_b, masks_b, generator):
                lp = est.log_prob(theta_b[None], x_b)[0]
                if calibration_kernel is not None:
                    lp = lp * calibration_kernel(x_b)
                return -lp

            return loss_fn
        return self._make_proposal_loss_fn(proposal, calibration_kernel)

    def _ensemble_loss_fn(self, est) -> Callable:
        """The first-round loss -log q(theta | x) for ``train_ensemble``
        (proposal-corrected rounds train members one by one, with
        ``train``)."""

        def loss_fn(theta_b, x_b, masks_b):
            return -est.log_prob(theta_b[None], x_b)[0]

        return loss_fn

    @abstractmethod
    def _make_proposal_loss_fn(self, proposal, calibration_kernel) -> Callable:
        """Sequential-round (proposal-corrected) loss, subclass specific."""

    # --------------------------------------------------------------- build
    def build_posterior(
        self,
        density_estimator=None,
        prior=None,
        sample_with: str = "direct",
        mcmc_method: str = "slice_jax_vectorized",
        mcmc_parameters: Optional[Dict] = None,
        vi_parameters: Optional[Dict] = None,
        rejection_sampling_parameters: Optional[Dict] = None,
        direct_sampling_parameters: Optional[Dict] = None,
        importance_sampling_parameters: Optional[Dict] = None,
        posterior_parameters=None,
    ):
        """A ``DirectPosterior`` (``sample_with="direct"``), or an
        ``MCMCPosterior`` (``"mcmc"``), ``RejectionPosterior`` or
        ``ImportanceSamplingPosterior`` or ``VIPosterior`` (``"vi"``) over
        the posterior potential, over a frozen copy of the estimator and
        the prior; or the posterior that ``posterior_parameters`` describes
        (``build_posterior_from_parameters``)."""
        from ...posteriors.direct_posterior import DirectPosterior
        from ...posteriors.posterior_parameters import (
            build_posterior_from_parameters,
            potential_posterior,
        )
        from ...potentials.posterior_based_potential import posterior_estimator_based_potential

        prior = prior if prior is not None else self._prior
        estimator = density_estimator if density_estimator is not None else self._neural_net
        if estimator is None:
            raise ValueError("Run `.train()` first or pass a density_estimator.")
        estimator = estimator.snapshot()
        if posterior_parameters is not None:
            self._posterior = build_posterior_from_parameters(
                posterior_parameters, estimator, prior, kind="npe")
            return self._posterior
        if sample_with == "direct":
            self._posterior = DirectPosterior(
                posterior_estimator=estimator,
                prior=prior,
                **(direct_sampling_parameters or {}),
            )
        else:
            potential_fn, theta_transform = posterior_estimator_based_potential(
                estimator, prior, x_o=None)
            self._posterior = potential_posterior(
                sample_with, potential_fn, theta_transform, prior, mcmc_method=mcmc_method,
                mcmc_parameters=mcmc_parameters,
                rejection_sampling_parameters=rejection_sampling_parameters,
                importance_sampling_parameters=importance_sampling_parameters,
                vi_parameters=vi_parameters)
        return self._posterior
