"""Metric tracking: the ``Tracker`` protocol and an in-memory tracker.

The port's own copy of ``sbi_tpu/utils/tracking.py:14-34`` (that module
imports no JAX, but the port imports nothing of ``sbi_tpu``).
``TensorBoardTracker`` comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, runtime_checkable


@runtime_checkable
class Tracker(Protocol):
    def log_metric(self, name: str, value: float, step: Optional[int] = None) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...


class InMemoryTracker:
    def __init__(self):
        self.metrics: Dict[str, list] = {}

    def log_metric(self, name, value, step=None):
        self.metrics.setdefault(name, []).append((step, float(value)))

    def flush(self):
        pass

    def close(self):
        pass


class TensorBoardTracker:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TensorBoardTracker is not ported yet; it comes with a later slice. "
            "Use InMemoryTracker or any object with log_metric/flush/close."
        )
