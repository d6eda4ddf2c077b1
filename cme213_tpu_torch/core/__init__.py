from .compare import almost_equal_ulps, ulp_distance
from .errors import (DataValidationError, FrameworkError, check_op,
                     data_error)
from .platform import BUILD_DIR, card_identity, resolve_device
from .timing import PhaseRecord, PhaseTimer, bandwidth_gbs, gflops, time_fn

__all__ = [
    "almost_equal_ulps", "ulp_distance",
    "DataValidationError", "FrameworkError", "check_op", "data_error",
    "BUILD_DIR", "card_identity", "resolve_device",
    "PhaseRecord", "PhaseTimer", "bandwidth_gbs", "gflops", "time_fn",
]
