"""NPSE: neural posterior score estimation (PyTorch counterpart of
``sbi_tpu/inference/trainers/vfpe/npse.py``; default net "mlp", sde_type
"ve")."""

from __future__ import annotations

from ....neural_nets.factory import posterior_score_nn
from .base_vf_inference import VectorFieldTrainer


class NPSE(VectorFieldTrainer):
    def __init__(self, prior=None, density_estimator="mlp", sde_type: str = "ve", **kwargs):
        self._sde_type = sde_type
        super().__init__(prior=prior, density_estimator=density_estimator, **kwargs)

    def _default_builder(self, model: str):
        return posterior_score_nn(model=model, sde_type=self._sde_type, device=self._device)
