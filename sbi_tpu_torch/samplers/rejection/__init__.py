from .rejection import accept_reject_sample

__all__ = ["accept_reject_sample"]
