from .compare import almost_equal_ulps, ulp_distance
from .errors import (DataValidationError, FrameworkError, check_op,
                     data_error)
from .platform import (BUILD_DIR, card_identity, device_preflight,
                       resolve_device, virtual_devices)
from .resilience import (FailureKind, FallbackResult, NonFiniteError,
                         RetryPolicy, all_finite, classify_failure,
                         with_fallback)
from .timing import PhaseRecord, PhaseTimer, bandwidth_gbs, gflops, time_fn
from .trace import (EVENT_SCHEMA, clear_events, events, flush_sink,
                    record_event, span, validate_record)
from . import diag, faults, metrics, roofline

__all__ = [
    "almost_equal_ulps", "ulp_distance",
    "DataValidationError", "FrameworkError", "check_op", "data_error",
    "BUILD_DIR", "card_identity", "device_preflight", "resolve_device",
    "virtual_devices",
    "FailureKind", "FallbackResult", "NonFiniteError", "RetryPolicy",
    "all_finite", "classify_failure", "with_fallback",
    "PhaseRecord", "PhaseTimer", "bandwidth_gbs", "gflops", "time_fn",
    "EVENT_SCHEMA", "clear_events", "events", "flush_sink", "record_event",
    "span", "validate_record",
    "diag", "faults", "metrics", "roofline",
]
