from .compare import almost_equal_ulps, ulp_distance
from .errors import (DataValidationError, FrameworkError, check_op,
                     data_error)
from .platform import (BUILD_DIR, card_identity, resolve_device,
                       virtual_devices)
from .timing import PhaseRecord, PhaseTimer, bandwidth_gbs, gflops, time_fn

__all__ = [
    "almost_equal_ulps", "ulp_distance",
    "DataValidationError", "FrameworkError", "check_op", "data_error",
    "BUILD_DIR", "card_identity", "resolve_device", "virtual_devices",
    "PhaseRecord", "PhaseTimer", "bandwidth_gbs", "gflops", "time_fn",
]
