from .flow import build_maf, build_nsf

__all__ = ["build_maf", "build_nsf"]
