"""NRE family base: classifier-based likelihood-ratio estimation.

PyTorch counterpart of ``sbi_tpu/inference/trainers/nre/nre_base.py``. The
JAX package's ``classifier_logits`` draws its contrastive atoms from a key
inside the loss; here that is two parts:

- ``contrast_indices`` (``trainers/base.py``, shared with NPE-C): the (B, M)
  atom-index matrix. Row i's column 0 is i, the joint pair; columns
  1..M-1 are M - 1 distinct other rows of the batch.
- ``classifier_logits``: a pure function of that matrix, the (B, M) logits.

A subclass gives ``_draw_atoms`` (the index tensors its loss takes, drawn
from a generator) and ``_loss`` (the per-row loss, a pure function of
them). Training draws them inside the loss; ``train_ensemble`` draws them
outside the vmapped step, one set per member (``_ensemble_extra_inputs``),
because random numbers inside ``torch.func.vmap`` would repeat across
members.

``build_posterior`` offers ``sample_with="mcmc"`` (the vectorized slice
sampler by default, or HMC or NUTS), ``"rejection"``, ``"importance"`` and
``"vi"``, or typed ``posterior_parameters``.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ....neural_nets.factory import classifier_nn
from .._contracts import TrainConfig
from ..base import NeuralInference


def random_permutation(B: int, generator: Optional[torch.Generator], device,
                       batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
    """(*batch_shape, B) random permutations of 0..B-1."""
    return torch.rand(tuple(batch_shape) + (B,), generator=generator, device=device).argsort(dim=-1)


def classifier_logits(est, theta: torch.Tensor, x: torch.Tensor,
                      atomic_idx: torch.Tensor) -> torch.Tensor:
    """(B, M) logits: entry (i, j) is log r(x_i, theta[atomic_idx[i, j]])."""
    B, M = atomic_idx.shape
    atomic_theta = theta[atomic_idx].reshape(B * M, -1)
    x_rep = x[:, None].expand((B, M) + tuple(x.shape[1:])).reshape((B * M,) + tuple(x.shape[1:]))
    return est.log_ratio(atomic_theta, x_rep).reshape(B, M)


class RatioEstimatorTrainer(NeuralInference):
    # Contrastive atoms of the vmapped `train_ensemble` loss (NRE-A and
    # BNRE use exactly 2).
    _ensemble_num_atoms = 10

    def __init__(
        self,
        prior=None,
        classifier: Union[str, Callable] = "resnet",
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
        if isinstance(classifier, str):
            self._build_neural_net = classifier_nn(model=classifier, device=self._device)
        else:
            self._build_neural_net = classifier

    def append_simulations(
        self, theta, x, proposal=None, exclude_invalid_x: bool = True,
        data_device=None, from_round: Optional[int] = None,
    ) -> "RatioEstimatorTrainer":
        """Store one round of simulations on the trainer's device; invalid
        x are excluded by default. ``data_device`` is accepted for parity."""
        theta, x = self._validate_theta_and_x(theta, x, exclude_invalid_x, algorithm="NRE")
        current_round = 0 if proposal is None else max(self._data_round_index, default=-1) + 1
        if from_round is not None:
            current_round = from_round
        prior_mask = torch.full((theta.shape[0],), float(current_round == 0), device=self._device)
        self._append_to_data_store(theta, x, prior_mask, current_round)
        self._proposal_roundwise.append(proposal)
        self._round = max(self._data_round_index)
        return self

    def train(
        self,
        num_atoms: int = 10,
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
        loss_kwargs: Optional[Dict] = None,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """Train the classifier and return the ratio estimator.
        ``generator`` (on the trainer's device) draws the split, the
        batches and the contrastive atoms. Validation scores the whole
        validation set as one batch, with atoms drawn over it, as the JAX
        loop does."""
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
                    f"The classifier lies on {self._neural_net.device}, the trainer on "
                    f"{self._device}."
                )
        loss_fn = self._make_loss_fn(num_atoms, **(loss_kwargs or {}))
        return self._run_training_loop(loss_fn, cfg, start_idx=start_idx, generator=generator)

    def _make_loss_fn(self, num_atoms: int, **loss_kwargs) -> Callable:
        """``fn(theta_b, x_b, masks_b, generator) -> (B,)``: the atoms drawn
        from ``generator``, then ``_loss``."""
        est = self._neural_net

        def loss_fn(theta_b, x_b, masks_b, generator):
            atoms = self._draw_atoms(theta_b.shape[0], num_atoms, generator, theta_b.device,
                                     **loss_kwargs)
            return self._loss(est, theta_b, x_b, *atoms, **loss_kwargs)

        return loss_fn

    @abstractmethod
    def _draw_atoms(self, B: int, num_atoms: int, generator, device,
                    batch_shape: Tuple[int, ...] = (), **loss_kwargs) -> tuple:
        """The index tensors ``_loss`` takes, each with ``batch_shape``
        leading."""

    @abstractmethod
    def _loss(self, est, theta, x, *atoms, **loss_kwargs) -> torch.Tensor:
        """(B,) losses: a pure function of the estimator, the batch and the
        atoms."""

    def _ensemble_loss_fn(self, est) -> Callable:
        """The loss at atoms drawn outside the vmapped step, with the
        subclass's default loss arguments, as the JAX package's ensembles."""

        def loss_fn(theta_b, x_b, masks_b, *atoms):
            return self._loss(est, theta_b, x_b, *atoms)

        return loss_fn

    def _ensemble_extra_inputs(self, theta_b, generator, validation: bool) -> tuple:
        """Each member's own atoms, (K, B, ...) per index tensor, for
        training and validation alike."""
        K, B = theta_b.shape[:2]
        return self._draw_atoms(B, self._ensemble_num_atoms, generator, theta_b.device, (K,))

    def build_posterior(
        self,
        ratio_estimator=None,
        prior=None,
        sample_with: str = "mcmc",
        mcmc_method: str = "slice_jax_vectorized",
        mcmc_parameters: Optional[Dict] = None,
        vi_parameters: Optional[Dict] = None,
        rejection_sampling_parameters: Optional[Dict] = None,
        importance_sampling_parameters: Optional[Dict] = None,
        density_estimator=None,
        posterior_parameters=None,
    ):
        """The posterior of the ratio potential (a frozen copy of the
        estimator) times the prior: ``MCMCPosterior`` (vectorized slice
        sampling by default), ``RejectionPosterior``,
        ``ImportanceSamplingPosterior`` or ``VIPosterior``, or as typed
        ``posterior_parameters`` describe it."""
        from ...potentials.ratio_based_potential import ratio_estimator_based_potential
        from ...posteriors.posterior_parameters import (
            build_posterior_from_parameters,
            check_legacy_sampler_args,
            potential_posterior,
        )

        prior = prior if prior is not None else self._prior
        if prior is None:
            raise ValueError("NRE needs a prior to build a posterior.")
        estimator = ratio_estimator or density_estimator or self._neural_net
        if estimator is None:
            raise ValueError("Run `.train()` first or pass a ratio_estimator.")
        estimator = estimator.snapshot()

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
                posterior_parameters, estimator, prior, kind="nre")
            return self._posterior

        potential_fn, theta_transform = ratio_estimator_based_potential(estimator, prior, x_o=None)
        self._posterior = potential_posterior(
            sample_with, potential_fn, theta_transform, prior, mcmc_method=mcmc_method,
            mcmc_parameters=mcmc_parameters,
            rejection_sampling_parameters=rejection_sampling_parameters,
            importance_sampling_parameters=importance_sampling_parameters,
            vi_parameters=vi_parameters)
        return self._posterior
