"""Typed training contracts (PyTorch counterpart of
``sbi_tpu/inference/trainers/_contracts.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class TrainConfig:
    """Validated hyperparameters for the training loop.

    Defaults match the JAX package: batch 200 / lr 5e-4 / val 0.1 /
    patience 20 / clip 5.0.
    """

    training_batch_size: int = 200
    learning_rate: float = 5e-4
    validation_fraction: float = 0.1
    stop_after_epochs: int = 20
    max_num_epochs: int = 2**31 - 1
    clip_max_norm: Optional[float] = 5.0
    resume_training: bool = False
    retrain_from_scratch: bool = False
    show_train_summary: bool = False
    epoch_chunk: int = 1
    """Accepted for parity with the JAX package, where it fuses epochs into
    one XLA call and restores the best parameters at chunk granularity. The
    port runs eagerly and keeps the best parameters of every epoch, exactly,
    whatever this value."""
    ema_params_decay: Optional[float] = None
    """None = no parameter EMA. Otherwise the decay of an exponential moving
    average of the parameters, updated after every optimizer step, which
    validation scores and the best-epoch snapshot keeps (the vector-field
    trainers' default is 0.999)."""
    lr_schedule: Optional[str] = None
    """None = constant Adam learning rate. "cosine" = linear warmup then
    cosine decay to ``learning_rate * lr_final_factor`` over
    ``lr_decay_epochs`` (default: max_num_epochs, which must then be
    finite), as ``optax.warmup_cosine_decay_schedule``."""
    lr_decay_epochs: Optional[int] = None
    lr_warmup_frac: float = 0.02
    lr_final_factor: float = 0.01
    mesh: Any = None
    """Data-parallel training over several devices comes with a later slice;
    only None (one device) is accepted."""

    def __post_init__(self):
        if self.training_batch_size <= 0:
            raise ValueError("training_batch_size must be positive.")
        if not (0.0 < self.validation_fraction < 1.0):
            raise ValueError("validation_fraction must be in (0, 1).")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be positive.")
        if self.stop_after_epochs <= 0:
            raise ValueError("stop_after_epochs must be positive.")
        if self.max_num_epochs <= 0:
            raise ValueError("max_num_epochs must be positive.")
        if self.clip_max_norm is not None and self.clip_max_norm <= 0:
            raise ValueError("clip_max_norm must be positive or None.")
        if self.epoch_chunk < 1:
            raise ValueError("epoch_chunk must be >= 1.")
        if self.ema_params_decay is not None and not (0.0 < self.ema_params_decay < 1.0):
            raise ValueError("ema_params_decay must be in (0, 1) or None.")
        if self.lr_schedule not in (None, "cosine"):
            raise ValueError("lr_schedule must be None or 'cosine'.")
        if self.lr_schedule is not None:
            horizon = self.lr_decay_epochs or self.max_num_epochs
            if horizon >= 2**31 - 1:
                raise ValueError(
                    "lr_schedule needs a finite horizon: set lr_decay_epochs "
                    "or a finite max_num_epochs."
                )
            if not (0.0 <= self.lr_warmup_frac < 1.0):
                raise ValueError("lr_warmup_frac must be in [0, 1).")
            if not (0.0 <= self.lr_final_factor <= 1.0):
                raise ValueError("lr_final_factor must be in [0, 1].")


@dataclass
class StartIndexContext:
    """Context for choosing which rounds' data to train on."""

    start_idx: int = 0
    discard_prior_samples: bool = False
    force_first_round_loss: bool = False


@dataclass
class LossArgsNPE:
    proposal: Any = None
    calibration_kernel: Optional[Callable] = None
    force_first_round_loss: bool = False


@dataclass
class LossArgsNRE:
    num_atoms: int = 10


@dataclass
class LossArgsNRE_A:
    num_atoms: int = 2


@dataclass
class LossArgsNRE_C:
    num_classes: int = 5
    gamma: float = 1.0


@dataclass
class LossArgsBNRE:
    num_atoms: int = 2
    regularization_strength: float = 100.0


@dataclass
class LossArgsVF:
    times_batch: int = 1
