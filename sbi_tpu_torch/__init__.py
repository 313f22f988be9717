"""sbi_tpu_torch — the PyTorch/CUDA port of ``sbi_tpu`` for an NVIDIA H100.

It mirrors ``sbi_tpu``'s layout and public names, module by module. It
imports ``torch`` and numpy and nothing of JAX or of ``sbi_tpu``. Entry
points run on the GPU (``device=None`` means ``cuda``) unless the caller
passes ``device="cpu"``; without CUDA they raise. The rational-quadratic
spline and its backward run as hand-written CUDA kernels
(``csrc/rqs.cu``) on the card.

It trains and serves NPE posteriors:

    from sbi_tpu_torch.inference import NPE

    inference = NPE(prior=prior)
    inference.append_simulations(theta, x).train()
    posterior = inference.build_posterior()
    samples = posterior.sample((1000,), x=x_o)
    log_probs = posterior.log_prob(samples, x=x_o)
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401
from .utils.sbiutils import seed_all_backends  # noqa: F401
