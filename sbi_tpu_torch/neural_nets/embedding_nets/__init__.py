"""Embedding nets for the condition x (PyTorch counterpart of
``sbi_tpu/neural_nets/embedding_nets/``). Ported so far: ``IdentityEmbedding``,
``FCEmbedding`` and ``CNNEmbedding``; the others come with later slices."""

from .cnn import CNNEmbedding
from .fully_connected import FCEmbedding, IdentityEmbedding

__all__ = ["CNNEmbedding", "FCEmbedding", "IdentityEmbedding"]
