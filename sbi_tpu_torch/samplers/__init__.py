from . import mcmc, rejection
