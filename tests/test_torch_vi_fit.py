"""sbi_tpu_torch's variational fits, on the CPU, at tests/test_vi.py's
sizes and tolerances: the four divergences recover its correlated Gaussian
(2,000 iterations at lr 2e-3, 4,000 draws; mean within 0.15 and covariance
within 0.35, 0.3 and 0.6 for IW and alpha, whose q is mass-covering). The
PSIS check of a fit is in test_torch_vi_posterior.py.
"""

import functools

import numpy as np
import pytest
import torch

from sbi_tpu_torch.inference import VIPosterior
from sbi_tpu_torch.inference.potentials.base_potential import CustomPotentialWrapper
from sbi_tpu_torch.utils import MultivariateNormal, seed_all_backends

from ._torch_threads import _one_torch_thread  # noqa: F401 (autouse)

MEAN = np.array([0.8, -1.2], np.float32)
COV = np.array([[1.0, 0.6], [0.6, 1.5]], np.float32)
PREC = torch.linalg.inv(torch.tensor(COV))


def _gauss_potential(theta, x_o):
    d = theta - torch.tensor(MEAN)
    return -0.5 * ((d @ PREC) * d).sum(-1)


def _make_vi(vi_method="rKL", q="maf"):
    """tests/test_vi.py's target: a correlated Gaussian potential, prior
    N(0, 9 I)."""
    prior = MultivariateNormal(torch.zeros(2), covariance_matrix=9.0 * torch.eye(2), device="cpu")
    pot = CustomPotentialWrapper(_gauss_potential, prior=prior, device="cpu")
    return VIPosterior(pot, prior=prior, q=q, vi_method=vi_method).set_default_x(torch.zeros(1, 2))


@functools.lru_cache(maxsize=None)
def trained_vi(vi_method, iters=2000, lr=2e-3):
    seed_all_backends(0)  # q's initial weights come from the global CPU generator
    vi = _make_vi(vi_method)
    return vi.train(max_num_iters=iters, learning_rate=lr, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("vi_method", ["rKL", "fKL", "IW", "alpha"])
def test_divergences_recover_the_gaussian(vi_method):
    """tests/test_vi.py::test_vi_divergences_recover_gaussian: 2,000
    iterations at lr 2e-3, 4,000 draws."""
    vi = trained_vi(vi_method)
    samples = vi.sample((4000,), generator=torch.Generator().manual_seed(1)).numpy()
    atol_m, atol_c = (0.3, 0.6) if vi_method in ("IW", "alpha") else (0.15, 0.35)
    assert np.allclose(samples.mean(0), MEAN, atol=atol_m), (vi_method, samples.mean(0))
    assert np.allclose(np.cov(samples.T), COV, atol=atol_c), (vi_method, np.cov(samples.T))
    assert vi._losses.shape == (2000,) and np.isfinite(vi._losses).all()
