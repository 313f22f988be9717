from .rejection import accept_reject_sample, ascend_log_ratio, rejection_sample

__all__ = ["accept_reject_sample", "ascend_log_ratio", "rejection_sample"]
