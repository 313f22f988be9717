from .distributions import (
    BoxUniform,
    Distribution,
    Independent,
    MultivariateNormal,
    Uniform,
)
from .metrics import c2st_torch
from .sbiutils import (
    draw_from_proposal,
    ensure_theta_batched,
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
