"""FMPE: flow-matching posterior estimation (PyTorch counterpart of
``sbi_tpu/inference/trainers/vfpe/fmpe.py``; default net "mlp")."""

from __future__ import annotations

from ....neural_nets.factory import posterior_flow_nn
from .base_vf_inference import VectorFieldTrainer


class FMPE(VectorFieldTrainer):
    def _default_builder(self, model: str):
        return posterior_flow_nn(model=model, device=self._device)
