"""Shared trainer for flow matching (FMPE) and score estimation (NPSE).

PyTorch counterpart of ``sbi_tpu/inference/trainers/vfpe/base_vf_inference.py``:
single-round only, random times in the training loss, and three devices
against the loss's noise in the stopping rule: the validation loss on a
fixed grid of times with fixed noise, exponential moving averages of the
recorded losses, and a 2-sigma statistical patience. The parameter EMA
(``ema_params_decay``, default 0.999) is the base loop's.
"""

from __future__ import annotations

import math
import warnings
from abc import abstractmethod
from typing import Callable, Optional, Union

import torch

from .._contracts import TrainConfig
from ..base import NeuralInference


class VectorFieldTrainer(NeuralInference):
    def __init__(
        self,
        prior=None,
        density_estimator: Union[str, Callable] = "mlp",
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
            self._build_neural_net = self._default_builder(density_estimator)
        else:
            self._build_neural_net = density_estimator
        self._ema_loss_decay = 0.1

    @abstractmethod
    def _default_builder(self, model: str) -> Callable: ...

    def append_simulations(self, theta, x, proposal=None, exclude_invalid_x: bool = True,
                           data_device=None) -> "VectorFieldTrainer":
        """Store simulations on the trainer's device. Vector-field methods
        are single-round: a ``proposal`` is ignored, with a warning."""
        if proposal is not None:
            warnings.warn("Vector-field methods are single-round; `proposal` is ignored.")
        theta, x = self._validate_theta_and_x(theta, x, exclude_invalid_x,
                                              algorithm=self.__class__.__name__)
        self._append_to_data_store(theta, x, torch.ones(theta.shape[0], device=self._device), 0)
        self._round = 0
        return self

    def train(
        self,
        training_batch_size: int = 200,
        learning_rate: float = 5e-4,
        validation_fraction: float = 0.1,
        stop_after_epochs: int = 20,
        max_num_epochs: int = 2**31 - 1,
        clip_max_norm: Optional[float] = 5.0,
        ema_loss_decay: float = 0.1,
        ema_params_decay: Optional[float] = 0.999,
        validation_times: int = 10,
        validation_times_nugget: float = 0.05,
        resume_training: bool = False,
        retrain_from_scratch: bool = False,
        show_train_summary: bool = False,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """Train the estimator and return it.

        The validation loss is the loss at ``validation_times`` times from
        ``validation_times_nugget`` to 1 - ``validation_times_nugget``, with
        one fixed draw of noise, so epochs are comparable; the recorded
        losses are EMAs of decay ``ema_loss_decay``; patience counts epochs
        more than 2 standard deviations above the best (``_converged_chunk``).
        With ``ema_params_decay`` (None opts out) the parameters' EMA is
        what is validated, snapshotted and returned."""
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
            ema_params_decay=ema_params_decay,
        )
        theta, x, _ = self.get_simulations(0)
        if self._neural_net is None or retrain_from_scratch:
            self._neural_net = self._build_neural_net(theta, x)
            if self._neural_net.device != self._device:
                raise ValueError(f"The estimator lies on {self._neural_net.device}, the trainer "
                                 f"on {self._device}.")
        est = self._neural_net
        self._ema_loss_decay = float(ema_loss_decay)

        def loss_fn(theta_b, x_b, masks_b, generator):
            return est.loss(theta_b, x_b, generator=generator)

        val_loss_fn = self._fixed_times_loss(
            est, validation_times_nugget, 1.0 - validation_times_nugget, int(validation_times))
        return self._run_training_loop(
            loss_fn, cfg, start_idx=0, generator=generator,
            val_loss_fn=lambda theta_b, x_b, masks_b, generator: val_loss_fn(theta_b, x_b))

    def _fixed_times_loss(self, est, t_first: float, t_last: float, num_times: int) -> Callable:
        """``fn(theta_b, x_b, noise=None) -> (B,)``: the loss averaged over
        ``num_times`` fixed times from ``t_first`` to ``t_last``, at each
        time on the same noise (by default one draw from a generator seeded
        0, kept for the shape), in one call on the stacked rows."""
        times = torch.linspace(t_first, t_last, num_times, device=self._device)
        fixed_noise = {}

        def fn(theta_b, x_b, noise=None):
            B = theta_b.shape[0]
            if noise is None:
                if theta_b.shape not in fixed_noise:
                    g = torch.Generator(device=self._device).manual_seed(0)
                    fixed_noise[theta_b.shape] = torch.randn(theta_b.shape, generator=g,
                                                             device=self._device)
                noise = fixed_noise[theta_b.shape]
            reps = (num_times,) + (1,) * (x_b.dim() - 1)
            g = torch.Generator(device=self._device).manual_seed(0)  # condition dropout
            losses = est.loss(theta_b.repeat(num_times, 1), x_b.repeat(reps),
                              times=times.repeat_interleave(B), noise=noise.repeat(num_times, 1),
                              generator=g)
            return losses.reshape(num_times, B).mean(dim=0)

        return fn

    # ------------------------------------------------------------ ensembles
    def _ensemble_loss_fn(self, est) -> Callable:
        """The loss at times and noise drawn outside the vmapped step
        (``_ensemble_extra_inputs``)."""

        def loss_fn(theta_b, x_b, masks_b, times, noise):
            return est.loss(theta_b, x_b, times=times, noise=noise)

        return loss_fn

    def _ensemble_val_loss_fn(self, est) -> Callable:
        """The loss on 20 fixed times from 1e-3 to 1 - 1e-3 and fixed noise,
        as single-model validation: the random-time loss is far too noisy
        for the per-member best-validation snapshots."""
        fixed = self._fixed_times_loss(est, 1e-3, 1.0 - 1e-3, 20)

        def val_loss_fn(theta_b, x_b, masks_b, noise):
            return fixed(theta_b, x_b, noise)

        return val_loss_fn

    def _ensemble_extra_inputs(self, theta_b, generator, validation: bool) -> tuple:
        """Training: (times, noise) per member and row, uniform on [t_min,
        t_max] and standard normal. Validation: one fixed draw of noise (a
        generator seeded 0), the same for every member."""
        est = self._neural_net
        K, B = theta_b.shape[:2]
        if validation:
            g = torch.Generator(device=self._device).manual_seed(0)
            noise = torch.randn(theta_b.shape[1:], generator=g, device=self._device)
            return (noise.expand(K, *noise.shape),)
        times = est.t_min + (est.t_max - est.t_min) * torch.rand(
            K, B, generator=generator, device=self._device)
        return times, torch.randn(theta_b.shape, generator=generator, device=self._device)

    # ---------------------------------------------------- the stopping rule
    def _postprocess_epoch_losses(self, train_losses, val_losses):
        """The recorded losses are exponential moving averages (decay
        ``ema_loss_decay``), chained across calls through the last entry of
        the summary."""
        decay = self._ema_loss_decay

        def ema(values, prev):
            out = []
            for v in values:
                prev = v if prev is None else (1.0 - decay) * prev + decay * v
                out.append(prev)
            return out

        history_t, history_v = self._summary["training_loss"], self._summary["validation_loss"]
        return (ema(train_losses, history_t[-1] if history_t else None),
                ema(val_losses, history_v[-1] if history_v else None))

    def _converged_chunk(self, val_losses, snapshot: Callable, stop_after_epochs: int) -> bool:
        """Statistical patience on the EMA'd validation losses: an epoch
        that improves on the best keeps its parameters; with enough history,
        an epoch more than 2 standard deviations (of the last
        2 x ``stop_after_epochs`` recorded losses) above the best counts
        against patience, and one within 2 resets it. The summary already
        holds the losses given."""
        stop = False
        for v in val_losses:
            v = float(v)
            if v < self._best_val_loss:
                self._best_val_loss = v
                self._epochs_since_last_improvement = 0
                self._best_params = snapshot()
                continue
            history = self._summary["validation_loss"]
            if len(history) < stop_after_epochs:
                continue
            recent = torch.tensor(history[-stop_after_epochs * 2:], dtype=torch.float64)
            loss_std = float(recent.std(correction=0))
            diff = (v - self._best_val_loss) / loss_std if loss_std > 0 else math.inf
            if diff > 2.0:
                self._epochs_since_last_improvement += 1
            else:
                self._epochs_since_last_improvement = 0
            if self._epochs_since_last_improvement > stop_after_epochs - 1:
                stop = True
        return stop

    # ---------------------------------------------------------- posterior
    def build_posterior(self, density_estimator=None, prior=None, sample_with: Optional[str] = None,
                        **kwargs):
        """A ``VectorFieldPosterior`` over a frozen copy of the estimator:
        ``sample_with`` defaults to "sde" for score estimators and "ode"
        for flow matching (which has no SDE); or the posterior that
        ``posterior_parameters`` describes."""
        from ...posteriors.vector_field_posterior import VectorFieldPosterior

        prior = prior if prior is not None else self._prior
        if prior is None:
            raise ValueError("A prior is required to build the posterior.")
        estimator = density_estimator if density_estimator is not None else self._neural_net
        if estimator is None:
            raise ValueError("Run `.train()` first or pass a density_estimator.")
        estimator = estimator.snapshot()
        posterior_parameters = kwargs.pop("posterior_parameters", None)
        if posterior_parameters is not None:
            from ...posteriors.posterior_parameters import (
                build_posterior_from_parameters,
                check_legacy_sampler_args,
            )

            check_legacy_sampler_args(
                {k: v for k, v in kwargs.items() if isinstance(v, dict) or k.endswith("_parameters")},
                {"sample_with": (sample_with, None)},
            )
            self._posterior = build_posterior_from_parameters(posterior_parameters, estimator,
                                                              prior, kind="vf")
            return self._posterior
        if sample_with is None:
            sample_with = "sde" if estimator.SDE_DEFINED else "ode"
        self._posterior = VectorFieldPosterior(estimator, prior, sample_with=sample_with, **kwargs)
        return self._posterior
