"""NPE-A / SNPE-A (Papamakarios & Murray 2016).

PyTorch counterpart of ``sbi_tpu/inference/trainers/npe/npe_a.py``: the
MDN is trained by maximum likelihood on the latest proposal's data every
round, and the proposal is corrected for analytically afterwards
(``posteriors/npe_a_posterior.py``). It needs an MDN estimator.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ....neural_nets.factory import posterior_nn
from ....utils.sbiutils import next_generator
from .npe_base import PosteriorEstimatorTrainer


class NPE_A(PosteriorEstimatorTrainer):
    def __init__(
        self,
        prior=None,
        density_estimator: Union[str, Callable] = "mdn_snpe_a",
        num_components: int = 10,
        device=None,
        logging_level="WARNING",
        summary_writer=None,
        show_progress_bars: bool = True,
        **kwargs,
    ):
        self._num_components = num_components
        if isinstance(density_estimator, str):
            if density_estimator not in ("mdn_snpe_a", "mdn"):
                raise AssertionError("NPE-A requires an MDN density estimator.")
            # Non-final rounds train a single Gaussian component, so every
            # proposal is one Gaussian and the correction is exact; the head
            # is expanded to `num_components` for the final round.
            density_estimator = posterior_nn(model="mdn", num_components=1, device=device)
        super().__init__(
            prior=prior,
            density_estimator=density_estimator,
            device=device,
            logging_level=logging_level,
            summary_writer=summary_writer,
            show_progress_bars=show_progress_bars,
            **kwargs,
        )

    def train(self, final_round: bool = False, generator: Optional[torch.Generator] = None,
              **kwargs):
        """Maximum likelihood on the latest proposal's data (prior samples
        discarded after round 0); the correction is applied in
        ``build_posterior``. ``final_round=True`` first expands the
        single-component head to ``num_components`` (the jitter drawn from
        ``generator``)."""
        kwargs.setdefault("force_first_round_loss", True)
        kwargs.setdefault("discard_prior_samples", True)
        if kwargs.get("retrain_from_scratch", False):
            raise AssertionError(
                "Retraining from scratch is not supported in SNPE-A: rebuilding "
                "the net would change the z-scoring and break the correction."
            )
        if final_round and self._num_components > 1:
            self._maybe_expand_mog(generator=generator)
        return super().train(generator=generator, **kwargs)

    def _maybe_expand_mog(self, eps: float = 1e-3, generator: Optional[torch.Generator] = None) -> None:
        """Expand a single-component head to ``num_components``: each head
        ``Linear`` is tiled K times along its outputs, and the logits and
        means biases are jittered by ``eps`` times a standard normal to
        break the symmetry. The hidden layers and the z-scoring stay, so
        the correction stays valid. The optimizer state is dropped: the
        head's parameters are new tensors."""
        est = self._neural_net
        if est is None:
            # Single-round use: build the net from the stored data first.
            theta, x, _ = self.get_simulations(0)
            self._neural_net = est = self._build_neural_net(theta, x)
        mod = est.net
        if mod.num_components != 1:
            return
        K = self._num_components
        generator = next_generator(generator, est.device)

        def tiled(head: nn.Linear, noise: bool) -> nn.Linear:
            new = nn.Linear(head.in_features, head.out_features * K, device=head.weight.device)
            with torch.no_grad():
                new.weight.copy_(head.weight.repeat(K, 1))
                bias = head.bias.repeat(K)
                if noise and eps > 0.0:
                    bias = bias + eps * torch.randn(bias.shape, generator=generator, device=bias.device)
                new.bias.copy_(bias)
            return new

        mod.logits = tiled(mod.logits, noise=True)
        mod.means = tiled(mod.means, noise=True)
        mod.diag = tiled(mod.diag, noise=False)
        if mod.off is not None:
            mod.off = tiled(mod.off, noise=False)
        mod.num_components = K
        self._optimizer = None

    def _make_proposal_loss_fn(self, proposal, calibration_kernel):
        # Not reached (force_first_round_loss=True); maximum likelihood.
        est = self._neural_net

        def loss_fn(theta_b, x_b, masks_b, generator):
            return -est.log_prob(theta_b[None], x_b)[0]

        return loss_fn

    def build_posterior(self, density_estimator=None, prior=None, **kwargs):
        """An ``NPE_A_Posterior``: the analytic correction chained to the
        latest proposal."""
        from ...posteriors.npe_a_posterior import NPE_A_Posterior

        prior = prior if prior is not None else self._prior
        estimator = density_estimator if density_estimator is not None else self._neural_net
        if estimator is None:
            raise ValueError("Run `.train()` first or pass a density_estimator.")
        proposal = self._proposal_roundwise[-1] if self._proposal_roundwise else None
        self._posterior = NPE_A_Posterior(
            posterior_estimator=estimator.snapshot(), prior=prior, proposal=proposal
        )
        return self._posterior


SNPE_A = NPE_A
