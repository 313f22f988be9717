from .flow import build_maf, build_nsf
from .mdn import build_mdn

__all__ = ["build_maf", "build_mdn", "build_nsf"]
