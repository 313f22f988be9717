from .distributions import (
    BoxUniform,
    Distribution,
    Independent,
    MultivariateNormal,
    Uniform,
)
from .metrics import (
    biased_mmd,
    biased_mmd_hypothesis_test,
    c2st,
    c2st_torch,
    check_c2st,
    mmd,
    posterior_shrinkage,
    posterior_zscore,
    unbiased_mmd_squared,
    unbiased_mmd_squared_hypothesis_test,
    wasserstein_2_squared,
)
from .mlp_classifier import BatchedMLPClassifier
from .sbiutils import (
    draw_from_proposal,
    ensure_theta_batched,
    gradient_ascent,
    handle_invalid_x,
    mog_log_prob,
    next_generator,
    resolve_device,
    seed_all_backends,
    standardizing_transform,
    warn_if_invalid_for_zscoring,
    warn_on_invalid_x,
    within_support,
    z_score_parser,
    z_score_stats,
)
from .transforms import (
    AffineTransform,
    BoxToUnboundedTransform,
    ComposeTransform,
    IdentityTransform,
    Transform,
    mcmc_transform,
    transformed_potential,
)
from .tracking import InMemoryTracker, Tracker
