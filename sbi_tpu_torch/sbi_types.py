"""Shared type aliases + protocols (mirror of ``sbi_tpu/sbi_types.py``)."""

from __future__ import annotations

from typing import Any, Protocol, Sequence, Tuple, Union, runtime_checkable

import torch

Array = torch.Tensor
Shape = Union[Tuple[int, ...], Sequence[int]]
ScalarFloat = Union[float, Array]
OneOrMore = Union[Any, Sequence[Any]]

# Transform alias (torch name kept for API familiarity)
from .utils.transforms import Transform as TorchTransform  # noqa: E402,F401
from .utils.transforms import Transform  # noqa: E402,F401


@runtime_checkable
class Tracker(Protocol):
    """Metric tracking protocol."""

    def log_metric(self, name: str, value: float, step: int | None = None) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...
