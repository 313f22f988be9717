"""NeuralInference: the abstract trainer and its training loop.

PyTorch counterpart of ``sbi_tpu/inference/trainers/base.py``: the
round-wise data store, the train/validation split, the early-stopped Adam
loop with global-norm clipping and best-parameter restore, the summary and
tracker, pickling, and ``infer()``.

The JAX loop is one XLA program per epoch that hands the host one scalar.
The port keeps what matters of that on the card:

- the data stay on the device; each epoch's batches are one
  ``torch.randperm`` on the trainer's generator, the partial batch dropped;
- no host sync inside a step: losses accumulate on the device, and the clip
  (optax's ``clip_by_global_norm``: scale by max_norm / ||g|| only when
  ||g|| >= max_norm, no epsilon) is a ``torch.where`` on the device;
- one host sync per epoch, where the epoch's mean training loss and its
  validation loss (one ``no_grad`` pass over the whole validation set)
  reach the host; the finite check runs there;
- best-parameter snapshots are device-side ``state_dict`` clones, taken
  when the validation loss improves and restored at the end;
- with ``ema_params_decay`` (the vector-field trainers' default), an
  exponential moving average of the parameters, ema <- decay ema + (1 -
  decay) params after every optimizer step, is what validation scores,
  what the snapshots keep and what the estimator ends with.

Two hooks let a trainer change the stopping rule, as the JAX loop's do:
``_postprocess_epoch_losses`` (the losses recorded and tested) and
``_converged_chunk`` (the decision on an epoch's validation loss).

``train``'s ``epoch_chunk`` is accepted for parity: the port checks
convergence and keeps the best parameters every epoch, which is what the
JAX package does at its default of one epoch a chunk (with longer chunks
it snapshots chunk-end parameters).

``train_ensemble`` trains K members as one ``torch.func.vmap`` over their
stacked parameters (``torch.func.stack_module_state``), through
``torch.func.functional_call``: a step is one vmapped
``grad_and_value`` of the members' mean losses, a per-member clip and one
foreach Adam over the stacked leaves, so it costs about the host ops of
one model, and each spline launch covers every member (the spline's
``vmap`` rule). As in the JAX package, it checks patience only at the end
of each chunk of ``epoch_chunk`` epochs and writes one summary entry a
chunk. ``mesh=`` comes with a later slice and raises.
"""

from __future__ import annotations

import math
import pickle
import time
import warnings
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional, Union

import torch

from ...neural_nets.estimators.base import functional, stack_nets, stackable
from ...utils.sbiutils import handle_invalid_x, next_generator, resolve_device, warn_on_invalid_x
from ...utils.tracking import InMemoryTracker, Tracker
from ._contracts import TrainConfig

_LATER_SLICE = "comes with a later slice of the port"


def infer(
    simulator: Callable,
    prior,
    method: Union[str, type],
    num_simulations: int,
    num_workers: int = 1,
    init_kwargs: Optional[Dict] = None,
    train_kwargs: Optional[Dict] = None,
    build_posterior_kwargs: Optional[Dict] = None,
    generator: Optional[torch.Generator] = None,
):
    """One-shot pipeline: simulate, train, build the posterior. The trainer
    runs on ``init_kwargs["device"]`` (default cuda), where the prior must
    lie."""
    from ...utils.simulation_utils import simulate_for_sbi
    from ...utils.user_input_checks import process_prior, process_simulator
    from .. import METHOD_REGISTRY, later_slice_name

    if isinstance(method, str):
        name = method.upper()
        if name not in METHOD_REGISTRY:
            if later_slice_name(name):
                raise NotImplementedError(f"Method {method} {_LATER_SLICE}.")
            raise NameError(f"Method not available. Got {method}.")
        method_fun = METHOD_REGISTRY[name]
    else:
        method_fun = method

    prior, _, _ = process_prior(prior)
    simulator = process_simulator(simulator, prior, False)
    inference = method_fun(prior=prior, **(init_kwargs or {}))
    theta, x = simulate_for_sbi(
        simulator, prior, num_simulations, num_workers=num_workers, generator=generator
    )
    inference = inference.append_simulations(theta, x)
    inference.train(**(train_kwargs or {}))
    return inference.build_posterior(**(build_posterior_kwargs or {}))


def warmup_cosine_decay(step: int, init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float) -> float:
    """``optax.warmup_cosine_decay_schedule(...)(step)``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine decay
    to ``end_value`` at ``decay_steps``, constant after."""
    if step < warmup_steps:
        return (init_value - peak_value) * (1 - step / warmup_steps) + peak_value
    span = decay_steps - warmup_steps
    t = min(step - warmup_steps, span)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / span)) + alpha)


def contrast_indices(B: int, M: int, generator: Optional[torch.Generator], device,
                     batch_shape: tuple = ()) -> torch.Tensor:
    """(*batch_shape, B, M) atom indices into a batch of B rows: row i is
    [i, c_1, ..., c_{M-1}] with the c distinct rows != i, the first M - 1
    of a random permutation of 0..B-2 mapped j -> j + (j >= i). NPE-C's
    atomic loss and the NRE losses contrast with them."""
    picks = torch.rand(tuple(batch_shape) + (B, B - 1), generator=generator,
                       device=device).argsort(dim=-1)[..., : M - 1]
    rows = torch.arange(B, device=device)[:, None]
    return torch.cat([rows.expand(tuple(batch_shape) + (B, 1)), picks + (picks >= rows)], dim=-1)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place, on the device: when the
    global norm g >= max_norm, every gradient is scaled by max_norm / g."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


@torch.no_grad()
def ema_update_(ema, params, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, on the device
    (the JAX package's ``params_ema_transform``)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


@torch.no_grad()
def clip_by_global_norm_per_member_(grads, max_norm: float) -> None:
    """``clip_by_global_norm_`` for each member of stacked gradients (a
    leading member axis on every tensor): member k's gradients are scaled
    by max_norm / g_k when its own global norm g_k >= max_norm, as
    ``optax.clip_by_global_norm`` inside the JAX package's vmapped step."""
    K = grads[0].shape[0]
    norm = torch.linalg.vector_norm(torch.cat([g.reshape(K, -1) for g in grads], dim=1), dim=1)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, [scale.view((K,) + (1,) * (g.dim() - 1)) for g in grads])


def ensemble_grad_and_loss(net: torch.nn.Module, loss_fn: Callable) -> Callable:
    """``f(params, theta_b, x_b, masks_b) -> (grads, losses)`` for stacked
    parameters and batches (a leading member axis on each): the gradients
    and values of every member's mean loss, in one ``torch.func.vmap``.
    ``loss_fn(theta_b, x_b, masks_b) -> (B,)`` calls ``net``."""
    mean_loss = functional(net, lambda *batch: loss_fn(*batch).mean())
    return torch.func.vmap(torch.func.grad_and_value(mean_loss))


def ensemble_step(grad_and_loss: Callable, params: Dict[str, torch.Tensor], optimizer,
                  batch, clip_max_norm: Optional[float], lr: Optional[float] = None) -> torch.Tensor:
    """One optimizer step of every member on ``batch`` (theta, x, masks,
    each (K, B, ...)): vmapped gradients, the per-member clip, one foreach
    Adam over the stacked leaves (Adam is elementwise, so it is K Adams).
    Returns the (K,) losses, without a host sync."""
    with torch.no_grad():  # torch.func.grad computes the gradients itself
        grads, loss = grad_and_loss(params, *batch)
        grads = [grads[k] for k in params]
        if clip_max_norm is not None:
            clip_by_global_norm_per_member_(grads, clip_max_norm)
    for p, g in zip(params.values(), grads):
        p.grad = g
    if lr is not None:
        for group in optimizer.param_groups:
            group["lr"] = lr
    optimizer.step()
    return loss


class NeuralInference(ABC):
    """Abstract base for all trainers. ``device=None`` means cuda (it
    raises without CUDA); a prior must lie on the trainer's device."""

    def __init__(
        self,
        prior=None,
        device=None,
        logging_level: Union[int, str] = "WARNING",
        summary_writer: Optional[Tracker] = None,
        tracker: Optional[Tracker] = None,
        show_progress_bars: bool = True,
    ):
        self._device = resolve_device(device)
        try:
            prior_device = None if prior is None else prior.device
        except (AttributeError, NotImplementedError):  # a prior that names no device
            prior_device = None
        if prior_device is not None and torch.device(prior_device) != self._device:
            raise ValueError(
                f"The prior lies on {prior_device}, the trainer on {self._device}; "
                "build the prior on the trainer's device."
            )
        self._prior = prior
        self._show_progress_bars = show_progress_bars
        self._tracker = tracker or summary_writer or InMemoryTracker()

        # Round-wise data store, on the device.
        self._theta_roundwise: list = []
        self._x_roundwise: list = []
        self._prior_masks: list = []
        self._data_round_index: list = []
        self._proposal_roundwise: list = []

        self._neural_net = None
        self._optimizer: Optional[torch.optim.Optimizer] = None
        self._opt_steps = 0
        self._ema_params: Optional[list] = None  # the parameters' EMA, when training keeps one
        self._ema_decay: Optional[float] = None
        self._epoch = 0
        self._round = 0
        self._val_loss = float("inf")
        self._best_val_loss = float("inf")
        self._epochs_since_last_improvement = 0
        self._best_params = None
        self._train_indices: Optional[torch.Tensor] = None
        self._val_indices: Optional[torch.Tensor] = None

        self._summary: Dict[str, list] = dict(
            epochs_trained=[],
            best_validation_loss=[],
            validation_loss=[],
            training_loss=[],
            epoch_durations_sec=[],
        )

    # ------------------------------------------------------------------ data
    def get_simulations(self, starting_round: int = 0):
        """Concatenate the data of rounds >= starting_round."""
        take = [i for i, r in enumerate(self._data_round_index) if r >= starting_round]
        theta = torch.cat([self._theta_roundwise[i] for i in take])
        x = torch.cat([self._x_roundwise[i] for i in take])
        masks = torch.cat([self._prior_masks[i] for i in take])
        return theta, x, masks

    def _append_to_data_store(self, theta, x, prior_mask, data_round: int):
        self._theta_roundwise.append(theta)
        self._x_roundwise.append(x)
        self._prior_masks.append(prior_mask)
        self._data_round_index.append(data_round)

    def _validate_theta_and_x(self, theta, x, exclude_invalid_x=True, algorithm="NPE"):
        """float32 tensors on the trainer's device, without the rows whose x
        is invalid (where excluded) or whose theta is not finite."""
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self._device)
        x = torch.as_tensor(x, dtype=torch.float32, device=self._device)
        if theta.shape[0] != x.shape[0]:
            raise ValueError("Number of parameter sets and simulations must match.")
        is_valid, num_nans, num_infs = handle_invalid_x(x, exclude_invalid_x)
        warn_on_invalid_x(num_nans, num_infs, exclude_invalid_x)
        theta_valid = torch.isfinite(theta.reshape(theta.shape[0], -1)).all(dim=1)
        keep = is_valid & theta_valid
        return theta[keep], x[keep]

    # ---------------------------------------------------------------- splits
    def get_dataloaders(
        self,
        start_idx: int = 0,
        training_batch_size: int = 200,
        validation_fraction: float = 0.1,
        resume_training: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Return (theta, x, masks, train_idx, val_idx), index tensors on the
        device: a random split of floor(fraction * n) validation rows."""
        theta, x, masks = self.get_simulations(start_idx)
        n = theta.shape[0]
        num_val = int(math.floor(validation_fraction * n))
        num_train = n - num_val
        if num_train <= 0:
            raise ValueError("Not enough training data.")
        if resume_training and self._train_indices is not None:
            train_idx, val_idx = self._train_indices, self._val_indices
        else:
            perm = torch.randperm(n, generator=next_generator(generator, self._device),
                                  device=self._device)
            train_idx, val_idx = perm[:num_train], perm[num_train:]
            self._train_indices, self._val_indices = train_idx, val_idx
        return theta, x, masks, train_idx, val_idx

    # ------------------------------------------------------------- training
    def _run_training_loop(
        self,
        loss_fn: Callable,
        cfg: TrainConfig,
        start_idx: int = 0,
        generator: Optional[torch.Generator] = None,
        val_loss_fn: Optional[Callable] = None,
    ):
        """Early-stopped Adam loop with one host sync per epoch.

        ``loss_fn(theta_b, x_b, masks_b, generator) -> (B,) losses``;
        ``val_loss_fn`` (default ``loss_fn``) scores the validation set.
        """
        if cfg.mesh is not None:
            raise NotImplementedError(f"Training over a device mesh (mesh=) {_LATER_SLICE}.")
        gen = next_generator(generator, self._device)
        theta, x, masks, train_idx, val_idx = self.get_dataloaders(
            start_idx, cfg.training_batch_size, cfg.validation_fraction,
            cfg.resume_training, generator=gen,
        )
        net = self._neural_net.net
        named = [(k, p) for k, p in net.named_parameters() if p.requires_grad]
        params = [p for _, p in named]
        num_train = train_idx.shape[0]
        batch_size = min(cfg.training_batch_size, num_train)
        n_batches = max(1, num_train // batch_size)
        use_ema = cfg.ema_params_decay is not None
        resume = cfg.resume_training and self._optimizer is not None
        if resume and use_ema != (self._ema_params is not None):
            warnings.warn(
                "resume_training=True but the optimizer structure changed since the "
                "previous train() call (e.g. lr_schedule or ema_params_decay toggled) — "
                "reinitializing the optimizer state; the schedule restarts from step 0."
            )
            self._optimizer = self._make_optimizer(cfg, params)
            self._opt_steps = 0
            self._ema_params = None
        elif not resume:
            self._optimizer = self._make_optimizer(cfg, params)
            self._opt_steps = 0
            self._epoch = 0
            self._ema_params = None
        self._ema_decay = cfg.ema_params_decay
        if use_ema and self._ema_params is None:
            self._ema_params = [p.detach().clone() for p in params]
        schedule = self._make_schedule(cfg, n_batches)

        if use_ema:
            # Validation scores the EMA parameters, and a snapshot keeps them.
            names = [k for k, _ in named]
            ema_val = functional(net, val_loss_fn or loss_fn)

            def validate(*batch):
                return ema_val(dict(zip(names, self._ema_params)), *batch)

            def snapshot():
                state = _state_clone(net)
                state.update((k, e.clone()) for k, e in zip(names, self._ema_params))
                return state
        else:
            validate = val_loss_fn or loss_fn

            def snapshot():
                return _state_clone(net)

        # Reset convergence tracking for this train() call.
        self._best_val_loss = float("inf")
        self._epochs_since_last_improvement = 0
        self._best_params = snapshot()

        epoch_start = self._epoch
        stop = False
        while not stop and self._epoch - epoch_start < cfg.max_num_epochs:
            t0 = time.time()
            perm = torch.randperm(num_train, generator=gen, device=self._device)
            batches = train_idx[perm[: n_batches * batch_size]].reshape(n_batches, batch_size)
            loss_sum = torch.zeros((), device=self._device)
            for b in range(n_batches):
                idx = batches[b]
                loss_sum = loss_sum + self._train_step(
                    loss_fn, (theta[idx], x[idx], masks[idx]), gen, params,
                    cfg.clip_max_norm, schedule,
                )
            with torch.no_grad():
                val = validate(theta[val_idx], x[val_idx], masks[val_idx], gen).mean()
            # The epoch's one host sync.
            train_loss, val_loss = torch.stack([loss_sum / n_batches, val]).tolist()
            dt = time.time() - t0
            (train_loss,), (val_loss,) = self._postprocess_epoch_losses([train_loss], [val_loss])
            if not (math.isfinite(train_loss) and math.isfinite(val_loss)):
                raise AssertionError(
                    "NaN/Inf present in training or validation loss "
                    f"(epoch {self._epoch}). Check simulations for invalid values, "
                    "consider z-scoring, or lower the learning rate."
                )
            self._epoch += 1
            self._val_loss = val_loss
            self._summary["training_loss"].append(train_loss)
            self._summary["validation_loss"].append(val_loss)
            self._summary["epoch_durations_sec"].append(dt)
            self._tracker.log_metric("train_loss", train_loss, self._epoch)
            self._tracker.log_metric("validation_loss", val_loss, self._epoch)
            if self._converged_chunk([val_loss], snapshot, cfg.stop_after_epochs):
                stop = True
            if self._epoch - epoch_start >= cfg.max_num_epochs:
                warnings.warn(
                    "Maximum number of epochs reached, but network has not yet fully converged."
                )
                stop = True

        net.load_state_dict(self._best_params)
        self._summary["epochs_trained"].append(self._epoch)
        self._summary["best_validation_loss"].append(self._best_val_loss)
        self._tracker.flush()
        if cfg.show_train_summary:
            print(self._describe_round(self._round, self._summary))
        return self._neural_net

    @staticmethod
    def _make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
        """Adam as ``optax.adam``: betas (0.9, 0.999), eps 1e-8 outside the
        square root; the clip is applied before it, in ``_train_step``."""
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                foreach=True)

    def _train_step(self, loss_fn: Callable, batch, generator, params, clip_max_norm,
                    schedule) -> torch.Tensor:
        """One optimizer step on the mean loss of ``batch`` (theta, x,
        masks); returns the loss, detached, without a host sync."""
        opt = self._optimizer
        if schedule is not None:
            lr = schedule(self._opt_steps)
            for group in opt.param_groups:
                group["lr"] = lr
        loss = loss_fn(*batch, generator).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if clip_max_norm is not None:
            clip_by_global_norm_([p.grad for p in params if p.grad is not None], clip_max_norm)
        opt.step()
        if self._ema_params is not None:
            ema_update_(self._ema_params, params, self._ema_decay)
        self._opt_steps += 1
        return loss.detach()

    @staticmethod
    def _make_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Optional[Callable[[int], float]]:
        """The learning rate of each optimizer step, or None for a constant
        one: ``optax.warmup_cosine_decay_schedule`` as the JAX trainer sets
        it up (``base.py:740-751``)."""
        if cfg.lr_schedule != "cosine":
            return None
        horizon_epochs = cfg.lr_decay_epochs or cfg.max_num_epochs
        total = max(1, int(horizon_epochs) * max(1, int(steps_per_epoch)))
        warmup = min(int(cfg.lr_warmup_frac * total), total - 1)
        init = 0.0 if warmup > 0 else cfg.learning_rate
        end = cfg.learning_rate * cfg.lr_final_factor
        return lambda step: warmup_cosine_decay(step, init, cfg.learning_rate, warmup, total, end)

    def _postprocess_epoch_losses(self, train_losses, val_losses):
        """The losses to record and to test for convergence, from the raw
        per-epoch losses (the identity; the vector-field trainers smooth
        them)."""
        return train_losses, val_losses

    def _converged_chunk(self, val_losses, snapshot: Callable[[], Any],
                         stop_after_epochs: int) -> bool:
        """The convergence decision on a run of per-epoch validation losses
        (the training loop gives one epoch at a time): ``_converged`` on the
        best of them."""
        return self._converged(min(val_losses), snapshot, stop_after_epochs,
                               n_epochs=len(val_losses))

    def _converged(self, val_loss: float, snapshot: Callable[[], Any], stop_after_epochs: int,
                   n_epochs: int = 1) -> bool:
        """Best-validation tracking: ``snapshot()`` gives the parameters to
        keep and is called only when the loss improves. Stops once the loss
        has not improved for ``stop_after_epochs`` epochs."""
        if val_loss < self._best_val_loss:
            self._best_val_loss = val_loss
            self._epochs_since_last_improvement = 0
            self._best_params = snapshot()
        else:
            self._epochs_since_last_improvement += n_epochs
        return self._epochs_since_last_improvement > stop_after_epochs - 1

    # ------------------------------------------------------------ ensembles
    def _ensemble_build_net(self, theta, x):
        """Build one ensemble member on the trainer's device."""
        est = self._build_neural_net(theta, x)
        if est.device != self._device:
            raise ValueError(f"The density estimator lies on {est.device}, the trainer on "
                             f"{self._device}.")
        return est

    def _ensemble_loss_fn(self, est) -> Callable:
        """``fn(theta_b, x_b, masks_b) -> (B,)`` through the estimator
        ``est``, which ``train_ensemble`` evaluates under each member's
        parameters. No random numbers: the vmapped step draws none."""
        raise NotImplementedError(f"{type(self).__name__}.train_ensemble {_LATER_SLICE}.")

    def _ensemble_val_loss_fn(self, est) -> Callable:
        """The loss of the per-member best-validation snapshots."""
        return self._ensemble_loss_fn(est)

    def _ensemble_extra_inputs(self, theta_b, generator, validation: bool) -> tuple:
        """Inputs the ensemble's losses take after (theta_b, x_b, masks_b),
        drawn outside the vmapped step from ``theta_b`` (K, B, ...) and
        ``generator``: for the training loss, or with ``validation`` for the
        validation loss. None by default."""
        return ()

    def train_ensemble(
        self,
        num_members: int,
        training_batch_size: int = 200,
        learning_rate: float = 5e-4,
        validation_fraction: float = 0.1,
        stop_after_epochs: int = 20,
        max_num_epochs: int = 2**31 - 1,
        clip_max_norm: Optional[float] = 5.0,
        epoch_chunk: int = 10,
        bootstrap: bool = False,
        start_idx: int = 0,
        member_train_indices=None,
        lr_schedule: Optional[str] = None,
        lr_decay_epochs: Optional[int] = None,
        lr_warmup_frac: float = 0.02,
        lr_final_factor: float = 0.01,
        mesh=None,
        generator: Optional[torch.Generator] = None,
    ) -> list:
        """Train ``num_members`` independently initialised estimators as one
        vmapped program over their stacked parameters.

        - Each member has its own initialisation (K builds); all share the
          architecture, the z-scoring (one transform, made from the data)
          and the train/validation split. With ``bootstrap=True`` each
          member trains on its own resample, with replacement, of the
          training rows; ``member_train_indices`` gives each member its own
          rows, its validation rows carved from the end of them, all cut to
          a common length.
        - Every epoch draws a permutation per member. A step is one vmapped
          gradient of all members' mean losses, each member's gradients
          clipped by its own global norm, and one Adam over the stacked
          parameters. One host sync an epoch.
        - Best-validation snapshots are kept per member on the device,
          every epoch (strict ``<``). Patience runs on the host and needs
          an improvement of 1e-4.
        - Epochs run in chunks of ``epoch_chunk`` (the last chunk cut at
          ``max_num_epochs``), as the JAX package runs them as one program
          a chunk: the stopping rule is checked only at a chunk's end, so a
          member out of patience in mid-chunk trains on to the chunk's end,
          and the summary gets one entry a chunk (its last epoch's mean
          losses over the members). Training stops when every member is out
          of patience, or at ``max_num_epochs`` with a warning.

        Returns the members (best-validation parameters). They are also in
        ``self._ensemble_estimators``, and the stacked best parameters in
        ``self._ensemble_stacked_state``.
        """
        if mesh is not None:
            raise NotImplementedError(f"train_ensemble over a device mesh (mesh=) {_LATER_SLICE}.")
        gen = next_generator(generator, self._device)
        theta, x, masks, train_idx, val_idx = self.get_dataloaders(
            start_idx, training_batch_size, validation_fraction, False, generator=gen)
        K = num_members
        ests = [self._ensemble_build_net(theta, x) for _ in range(K)]
        for est in ests[1:]:  # one z-scoring, made from the same data
            est.input_transform = ests[0].input_transform
            est.condition_transform = ests[0].condition_transform
        if self._neural_net is None:
            self._neural_net = ests[0]
        nets = [est.net for est in ests]
        if not stackable(nets):
            raise ValueError("the builder gave ensemble members of different architectures")
        params = stack_nets(nets)

        dev = self._device
        if member_train_indices is not None:
            rows = [torch.as_tensor(r, dtype=torch.long, device=dev) for r in member_train_indices]
            if len(rows) != K:
                raise ValueError(f"member_train_indices has {len(rows)} entries for {K} members")
            shortest = min(len(r) for r in rows)
            n_val = max(1, int(math.floor(validation_fraction * shortest)))
            m = shortest - n_val
            if m <= 0:
                raise ValueError("member blocks too small for the validation split")
            member_train_idx = torch.stack([r[:m] for r in rows])
            member_val_idx = torch.stack([r[len(r) - n_val:] for r in rows])
        elif bootstrap:
            draw = torch.randint(len(train_idx), (K, len(train_idx)), generator=gen, device=dev)
            member_train_idx = train_idx[draw]
            member_val_idx = val_idx.expand(K, -1)
        else:
            member_train_idx = train_idx.expand(K, -1)
            member_val_idx = val_idx.expand(K, -1)
        m = member_train_idx.shape[1]
        batch_size = min(training_batch_size, m)
        n_batches = max(1, m // batch_size)

        cfg = TrainConfig(learning_rate=learning_rate, clip_max_norm=clip_max_norm,
                          max_num_epochs=max_num_epochs, lr_schedule=lr_schedule,
                          lr_decay_epochs=lr_decay_epochs, lr_warmup_frac=lr_warmup_frac,
                          lr_final_factor=lr_final_factor)
        optimizer = self._make_optimizer(cfg, list(params.values()))
        schedule = self._make_schedule(cfg, n_batches)
        # Member 0 run under each member's parameters: the members share its
        # architecture and z-scoring.
        template = ests[0]
        grad_and_loss = ensemble_grad_and_loss(template.net, self._ensemble_loss_fn(template))
        val_fn = self._ensemble_val_loss_fn(template)
        member_val = torch.func.vmap(functional(template.net, lambda *b: val_fn(*b).mean()))

        best_val = torch.full((K,), math.inf, device=dev)
        best_params = {k: v.clone() for k, v in params.items()}
        host_best = [math.inf] * K
        since_impr = [0] * K
        steps = epoch = 0
        chunk_end = 0
        t0 = time.time()
        while epoch < max_num_epochs:
            if epoch == chunk_end:
                chunk_end = epoch + min(epoch_chunk, max_num_epochs - epoch)
            perm = torch.rand(K, m, generator=gen, device=dev).argsort(dim=1)
            batches = member_train_idx.gather(1, perm[:, : n_batches * batch_size])
            batches = batches.reshape(K, n_batches, batch_size)
            loss_sum = torch.zeros(K, device=dev)
            for b in range(n_batches):
                idx = batches[:, b]
                lr = schedule(steps) if schedule is not None else None
                batch = (theta[idx], x[idx], masks[idx])
                batch += self._ensemble_extra_inputs(batch[0], gen, False)
                loss_sum = loss_sum + ensemble_step(
                    grad_and_loss, params, optimizer, batch, clip_max_norm, lr)
                steps += 1
            with torch.no_grad():
                val_batch = (theta[member_val_idx], x[member_val_idx], masks[member_val_idx])
                val = member_val(params, *val_batch,
                                 *self._ensemble_extra_inputs(val_batch[0], gen, True))
                improved = val < best_val
                best_val = torch.where(improved, val, best_val)
                for k, v in params.items():
                    keep = improved.view((K,) + (1,) * (v.dim() - 1))
                    best_params[k] = torch.where(keep, v, best_params[k])
            # The epoch's one host sync.
            train_losses, val_losses = torch.stack([loss_sum / n_batches, val]).tolist()
            if not all(math.isfinite(v) for v in val_losses):
                raise AssertionError(f"NaN/Inf in ensemble validation loss (epoch {epoch}).")
            epoch += 1
            for i, v in enumerate(val_losses):
                # Patience needs a material improvement: with many members
                # some member always gains a little, which would reset its
                # counter forever. The snapshots above use strict `<`.
                if v < host_best[i] - 1e-4:
                    host_best[i], since_impr[i] = v, 0
                else:
                    since_impr[i] += 1
            if epoch < chunk_end:
                continue
            self._summary["training_loss"].append(sum(train_losses) / K)
            self._summary["validation_loss"].append(sum(val_losses) / K)
            self._summary["epoch_durations_sec"].append(time.time() - t0)
            t0 = time.time()
            if min(since_impr) >= stop_after_epochs:
                break
        if epoch >= max_num_epochs:
            warnings.warn("Maximum number of epochs reached, but not every ensemble member has "
                          "converged.")

        with torch.no_grad():
            for i, net in enumerate(nets):
                for name, p in net.named_parameters():
                    p.copy_(best_params[name][i])
        self._ensemble_estimators = ests
        self._ensemble_stacked_state = best_params
        self._summary["epochs_trained"].append(epoch)
        self._summary["best_validation_loss"].append(sum(host_best) / K)
        return ests

    def build_ensemble_posterior(self, potential_combination: str = "mixture", **kwargs):
        """An ``EnsemblePosterior`` over the members of ``train_ensemble``:
        one ``build_posterior(density_estimator=member, **kwargs)`` each.
        The members share one architecture and z-scoring, so the ensemble
        evaluates their potentials in one vmapped call."""
        from ..posteriors.ensemble_posterior import EnsemblePosterior

        members = getattr(self, "_ensemble_estimators", None)
        if not members:
            raise RuntimeError("Run `train_ensemble(...)` first.")
        posteriors = [self.build_posterior(density_estimator=e, **kwargs) for e in members]
        return EnsemblePosterior(posteriors, potential_combination=potential_combination)

    # ------------------------------------------------------------- summary
    @staticmethod
    def _describe_round(round_: int, summary: Dict) -> str:
        epochs = summary["epochs_trained"][-1] if summary["epochs_trained"] else 0
        best = summary["best_validation_loss"][-1] if summary["best_validation_loss"] else float("nan")
        return (
            f"-------------------------\n"
            f"||||| ROUND {round_ + 1} STATS |||||:\n"
            f"-------------------------\n"
            f"Epochs trained: {epochs}\n"
            f"Best validation performance: {best:.4f}\n"
            f"-------------------------\n"
        )

    @property
    def summary(self):
        return self._summary

    # ------------------------------------------------------------- abstract
    @abstractmethod
    def append_simulations(self, theta, x, **kwargs) -> "NeuralInference": ...

    @abstractmethod
    def train(self, **kwargs): ...

    @abstractmethod
    def build_posterior(self, **kwargs): ...

    # ------------------------------------------------------------- pickling
    def __getstate__(self):
        """The tracker and the net-builder closure stay out of the pickle:
        builders may hold arbitrary user code."""
        state = self.__dict__.copy()
        state["_tracker"] = None
        state["_build_neural_net"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._tracker = InMemoryTracker()
        if self._build_neural_net is None:
            def _missing_builder(*args, **kwargs):
                raise RuntimeError(
                    "The net-builder closure is not serialized (it may hold "
                    "arbitrary user code). The trained estimator was restored "
                    "and training can resume; to retrain_from_scratch, "
                    "re-create the trainer with its density_estimator."
                )

            self._build_neural_net = _missing_builder

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str):
        """Unpickle a trainer that ``save`` wrote (pickle runs code: load
        only files this program wrote)."""
        with open(path, "rb") as f:
            return pickle.load(f)


def _state_clone(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A device-side copy of the module's parameters and buffers."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def check_if_proposal_has_default_x(proposal):
    if hasattr(proposal, "default_x") and proposal.default_x is None:
        raise ValueError(
            "`proposal.default_x` is None, i.e. there is no `x_o` for training. "
            "Set it with `posterior.set_default_x(x_o)`."
        )

