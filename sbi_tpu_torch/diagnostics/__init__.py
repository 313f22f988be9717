from .lc2st import LC2ST, LC2ST_NF, LC2STScores, LC2STState
from .misspecification import (
    calc_misspecification_logprob,
    calc_misspecification_mmd,
)
from .sbc import check_sbc, get_nltp, run_sbc
from .tarp import check_tarp, run_tarp

__all__ = [
    "run_sbc",
    "check_sbc",
    "get_nltp",
    "run_tarp",
    "check_tarp",
    "LC2ST",
    "LC2ST_NF",
    "LC2STScores",
    "LC2STState",
    "calc_misspecification_mmd",
    "calc_misspecification_logprob",
]
