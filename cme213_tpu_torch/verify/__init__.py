from . import golden
from .checkers import (
    CheckResult,
    check_abs_tol,
    check_exact,
    check_ulp,
    l2_distance,
    relative_l2_error,
    relative_linf_error,
)

__all__ = [
    "CheckResult",
    "check_abs_tol",
    "check_exact",
    "check_ulp",
    "golden",
    "l2_distance",
    "relative_l2_error",
    "relative_linf_error",
]
