"""MCMC samplers: the vectorized slice sampler, HMC and NUTS, and the init
strategies.

PyTorch counterpart of ``sbi_tpu/samplers/mcmc``.
"""

from .hmc import run_hmc, run_nuts, run_nuts_jittered
from .init_strategy import (
    IterateParameters,
    proposal_init,
    resample_given_potential_fn,
    sir_init,
)
from .slice_fsm import (
    SliceFSMState,
    run_slice_vectorized_fsm,
    slice_fsm_advance,
    slice_fsm_warmup,
)
from .slice_jax import (
    SliceSampler,
    SliceSamplerSerial,
    SliceSamplerVectorized,
    run_slice_vectorized,
)


__all__ = [
    "IterateParameters",
    "SliceFSMState",
    "SliceSampler",
    "SliceSamplerSerial",
    "SliceSamplerVectorized",
    "proposal_init",
    "resample_given_potential_fn",
    "run_hmc",
    "run_nuts",
    "run_nuts_jittered",
    "run_slice_vectorized",
    "run_slice_vectorized_fsm",
    "sir_init",
    "slice_fsm_advance",
    "slice_fsm_warmup",
]
