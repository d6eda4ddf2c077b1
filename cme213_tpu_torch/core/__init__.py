"""The runtime core.  Its public names resolve on first access (PEP 562),
so importing one light submodule (``core.faults``, ``core.trace``: the
heartbeat path of a supervised rank) does not import ``torch``."""

from importlib import import_module

#: public name -> the submodule that defines it
_NAMES = {
    "almost_equal_ulps": "compare", "ulp_distance": "compare",
    "DataValidationError": "errors", "FrameworkError": "errors",
    "KernelError": "errors", "check_op": "errors", "data_error": "errors",
    "BUILD_DIR": "platform", "card_identity": "platform",
    "device_preflight": "platform", "resolve_device": "platform",
    "to_host": "platform", "virtual_devices": "platform",
    "FailureKind": "resilience", "FallbackResult": "resilience",
    "NonFiniteError": "resilience", "RetryPolicy": "resilience",
    "all_finite": "resilience", "classify_failure": "resilience",
    "with_fallback": "resilience",
    "PhaseRecord": "timing", "PhaseTimer": "timing",
    "bandwidth_gbs": "timing", "gflops": "timing", "time_fn": "timing",
    "EVENT_SCHEMA": "trace", "clear_events": "trace", "events": "trace",
    "flush_sink": "trace", "record_event": "trace", "span": "trace",
    "validate_record": "trace",
}
_SUBMODULES = ("admission", "conformance", "diag", "faults", "metrics",
               "programs", "roofline", "tune")

__all__ = [*_NAMES, *_SUBMODULES]


def __getattr__(name: str):
    if name in _NAMES:
        return getattr(import_module(f".{_NAMES[name]}", __name__), name)
    try:  # a submodule, imported on first access
        return import_module(f".{name}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
