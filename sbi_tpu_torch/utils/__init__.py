from .distributions import (
    BoxUniform,
    Distribution,
    Independent,
    MultivariateNormal,
    Uniform,
)
from .sbiutils import (
    ensure_theta_batched,
    next_generator,
    resolve_device,
    seed_all_backends,
    standardizing_transform,
    warn_if_invalid_for_zscoring,
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
)
