"""NPE-C / APT (Greenberg et al. 2019): the atomic proposal-posterior loss.

PyTorch counterpart of ``sbi_tpu/inference/trainers/npe/npe_c.py``. Each
row of a batch is contrasted with M - 1 other rows of the same batch,
drawn on the device; the loss is -log of the true atom's share of
q(theta | x) / prior(theta) over the M atoms. When the net and the
proposal are both MDNs and the prior is Gaussian or uniform, the loss is
the non-atomic closed form instead: the proposal posterior is the MoG
product of the net's MoG and the proposal's, with the Gaussian prior
divided out.
"""

from __future__ import annotations

from typing import Callable

import torch

from ....neural_nets.estimators.mdn import MixtureDensityEstimator, MoG
from ....utils.distributions import BoxUniform, Independent, MultivariateNormal, Uniform
from ....utils.transforms import AffineTransform, IdentityTransform
from ..base import contrast_indices
from .npe_base import PosteriorEstimatorTrainer


class NPE_C(PosteriorEstimatorTrainer):
    def __init__(
        self,
        prior=None,
        density_estimator="maf",
        device=None,
        logging_level="WARNING",
        summary_writer=None,
        show_progress_bars: bool = True,
        **kwargs,
    ):
        super().__init__(
            prior=prior,
            density_estimator=density_estimator,
            device=device,
            logging_level=logging_level,
            summary_writer=summary_writer,
            show_progress_bars=show_progress_bars,
            **kwargs,
        )
        self._num_atoms = 10
        self._use_combined_loss = False

    def train(self, num_atoms: int = 10, use_combined_loss: bool = False, **kwargs):
        """``num_atoms`` per row (10, as the reference); ``use_combined_loss``
        adds the masks-weighted first-round loss on prior-round rows. The
        non-atomic MoG loss is taken when ``_is_mog_case`` holds for the
        latest proposal."""
        self._num_atoms = num_atoms
        self._use_combined_loss = use_combined_loss
        proposal = self._proposal_roundwise[-1] if self._proposal_roundwise else None
        self.use_non_atomic_loss = self._is_mog_case(proposal)
        return super().train(**kwargs)

    def _prior_is_gaussian_or_uniform(self) -> bool:
        prior = self._prior
        if isinstance(prior, (MultivariateNormal, BoxUniform, Uniform)):
            return True
        if isinstance(prior, Independent):
            return isinstance(prior.base, Uniform)
        return False

    def _is_mog_case(self, proposal) -> bool:
        """The closed form needs an MDN net with an affine (or identity)
        theta transform, a ``DirectPosterior`` over an MDN as the proposal,
        and a prior whose density it can divide out (Gaussian or uniform).
        Before the net is built the answer is no (the atomic loss)."""
        from ...posteriors.direct_posterior import DirectPosterior

        if self._neural_net is None:
            return False
        return (
            isinstance(self._neural_net, MixtureDensityEstimator)
            and isinstance(self._neural_net.input_transform, (AffineTransform, IdentityTransform))
            and isinstance(proposal, DirectPosterior)
            and isinstance(proposal.posterior_estimator, MixtureDensityEstimator)
            and self._prior_is_gaussian_or_uniform()
        )

    def _z_scored_prior_natural_params(self):
        """(P0, eta0) of a Gaussian prior in the net's z-scored theta space,
        or None for a uniform prior (constant density: nothing to divide).
        With z = (theta - loc) / scale, N(mu0, Sigma0) becomes
        N((mu0 - loc) / scale, Sigma0 / (scale scale^T))."""
        if not isinstance(self._prior, MultivariateNormal):
            return None
        tf = self._neural_net.input_transform
        mu0 = self._prior.loc
        cov0 = self._prior.covariance_matrix
        if isinstance(tf, AffineTransform):
            scale = torch.broadcast_to(tf.scale, mu0.shape)
            loc = torch.broadcast_to(tf.loc, mu0.shape)
            mu_z = (mu0 - loc) / scale
            cov_z = cov0 / (scale[:, None] * scale[None, :])
        else:
            mu_z, cov_z = mu0, cov0
        P0 = torch.linalg.inv(cov_z)
        return P0, P0 @ mu_z

    def _make_proposal_loss_fn(self, proposal, calibration_kernel) -> Callable:
        if self.use_non_atomic_loss:
            return self._make_mog_loss_fn(proposal)
        est = self._neural_net
        prior = self._prior
        num_atoms = self._num_atoms
        use_combined_loss = self._use_combined_loss

        def loss_fn(theta_b, x_b, masks_b, generator):
            B = theta_b.shape[0]
            M = min(num_atoms, B)
            device = theta_b.device
            # Row i contrasts with M - 1 distinct rows != i.
            atomic_idx = contrast_indices(B, M, generator, device)  # (B, M)
            atomic_theta = theta_b[atomic_idx]  # (B, M, D)

            # q(atomic_theta | x_i): (M, B) in the (sample, batch, event) API.
            lp_posterior = est.log_prob(atomic_theta.transpose(0, 1), x_b)
            lp_prior = prior.log_prob(atomic_theta.reshape(B * M, -1)).reshape(B, M).T
            log_frac = lp_posterior - lp_prior
            # The true atom is row 0.
            lp_proposal_posterior = log_frac[0] - torch.logsumexp(log_frac, dim=0)
            if use_combined_loss:
                lp_non_atomic = est.log_prob(theta_b[None], x_b)[0]
                lp_proposal_posterior = masks_b.reshape(-1) * lp_non_atomic + lp_proposal_posterior
            loss = -lp_proposal_posterior
            if calibration_kernel is not None:
                loss = loss * calibration_kernel(x_b)
            return loss

        return loss_fn

    def _make_mog_loss_fn(self, proposal) -> Callable:
        """The closed-form proposal-posterior loss for an MDN net and an MDN
        proposal (Greenberg et al. 2019, App. A.1), in the net's z-scored
        theta space plus the z-scoring's log-det. Both nets are built from
        the same round-wise data, so they share one z-space, as in the
        JAX package. The proposal's MoG at its x_o is fixed: it is computed
        once here, not in every step."""
        est: MixtureDensityEstimator = self._neural_net
        prop_est: MixtureDensityEstimator = proposal.posterior_estimator
        with torch.no_grad():
            mog_prop = prop_est.get_uncorrected_mog(proposal.default_x).detach()
        prior_natural = self._z_scored_prior_natural_params()

        def loss_fn(theta_b, x_b, masks_b, generator):
            B = theta_b.shape[0]
            mog_post = est.get_mixture_fn(est._embed_condition(x_b))
            prop = MoG(mog_prop.logits.expand(B, -1), mog_prop.means.expand(B, -1, -1),
                       mog_prop.precision_chols.expand(B, -1, -1, -1))
            mog_pp = MoG.product(mog_post, prop, subtract_natural=prior_natural)
            z_theta, ldj = est.input_transform.forward_and_log_det(theta_b)
            # log_prob normalizes the product's logits: this is the
            # normalized proposal posterior.
            return -(mog_pp.log_prob(z_theta) + ldj)

        return loss_fn


# Aliases, as in the JAX package.
NPE = NPE_C
SNPE = NPE_C
SNPE_C = NPE_C
APT = NPE_C
