"""MCMC samplers: the vectorized slice sampler and the init strategies.

PyTorch counterpart of ``sbi_tpu/samplers/mcmc``. HMC and NUTS
(``run_hmc``, ``run_nuts``, ``run_nuts_jittered``) come with a later slice
and raise ``NotImplementedError``.
"""

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


def _later_slice(name):
    def sampler(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet; it comes with a later slice.")

    sampler.__name__ = name
    return sampler


run_hmc = _later_slice("run_hmc")
run_nuts = _later_slice("run_nuts")
run_nuts_jittered = _later_slice("run_nuts_jittered")

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
