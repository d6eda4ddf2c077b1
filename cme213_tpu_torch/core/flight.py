"""Crash flight recorder: the black box of a process that dies uncleanly.

Counterpart of ``cme213_tpu/core/flight.py``.  The trace layer
(``core/trace.py``) keeps an in-process event ring and optionally streams
to a JSON-lines sink; a process that dies uncleanly takes its ring with
it, and a sink helps only when one was configured.  On an unhandled
exception, a fatal signal or an explicit :func:`dump`, this module writes
the last events, a metrics snapshot, the still-open spans, the last
health and forensics state (``core/diag.py``), the last drift snapshot
(``core/numerics.py``) and platform facts to ``flight-<pid>-<ms>-<n>.json``,
so a failed run is diagnosable from its files alone.

Usage::

    from cme213_tpu_torch.core import flight
    flight.install()              # CLI entry points: always record
    flight.install_from_env()     # library paths: only when
                                  # CME213_FLIGHT_DIR is set

``install()`` chains ``sys.excepthook`` and registers handlers for the
fatal signals a supervisor sends (SIGTERM, SIGQUIT, SIGABRT; SIGKILL
cannot be caught, which is why the ``rankkill`` and ``replica-kill``
fault guards call :func:`dump` themselves).  Dumps land in
``CME213_FLIGHT_DIR`` when set, else the install-time directory, else the
current working directory, written to a temporary name and renamed, so a
reader never sees a torn file.

A dump runs inside a signal handler or an excepthook, so it never
initialises CUDA: the card's name is reported only when
``torch.cuda.is_initialized()``, and torch's versions only when something
else already imported torch.
"""

from __future__ import annotations

import itertools
import json
import os
import platform as _platform
import signal
import sys
import threading
import time
import traceback

from . import metrics, trace

#: directory flight dumps are written to (also arms library-path dumps)
FLIGHT_DIR_ENV = "CME213_FLIGHT_DIR"

#: events kept in a dump (the tail of the trace ring)
DUMP_EVENTS = 512

#: signals that trigger a dump before the process dies (SIGKILL cannot be
#: caught; ``faults.maybe_kill_rank`` dumps explicitly instead)
FATAL_SIGNALS = ("SIGTERM", "SIGQUIT", "SIGABRT")

_LOCK = threading.Lock()
_INSTALLED = False
_DIR: str | None = None
_PREV_EXCEPTHOOK = None
_DUMP_SEQ = itertools.count(1)
_DUMPING = False


def _platform_info() -> dict:
    """Platform facts: Python, the OS, and, if torch is already imported,
    its version, its CUDA version and the card's name when CUDA is already
    initialised.  Never imports torch, never initialises CUDA."""
    info = {
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "torch": None,
        "cuda": None,
        "card": None,
        "argv": list(sys.argv),
    }
    torch = sys.modules.get("torch")
    if torch is None:
        return info
    try:
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        if torch.cuda.is_initialized():
            info["card"] = torch.cuda.get_device_name(
                torch.cuda.current_device())
    except Exception:  # noqa: BLE001 — facts are best-effort
        pass
    return info


def installed() -> bool:
    return _INSTALLED


def _armed() -> bool:
    """Dumps happen when the hooks were installed or the variable opts
    in."""
    return _INSTALLED or bool(os.environ.get(FLIGHT_DIR_ENV))


def _dump_dir() -> str:
    return os.environ.get(FLIGHT_DIR_ENV) or _DIR or os.getcwd()


def _open_spans(events: list[dict]) -> list[dict]:
    """span-begin records without a matching span-end: what the process
    was inside when it died."""
    open_by_id: dict = {}
    for e in events:
        if e.get("event") == "span-begin":
            open_by_id[e.get("id")] = e
        elif e.get("event") == "span-end":
            open_by_id.pop(e.get("id"), None)
    return list(open_by_id.values())


def dump(reason: str, exc: BaseException | None = None) -> str | None:
    """Write a flight dump now; returns its path.

    A no-op (None) unless armed by ``install()``/``install_from_env()`` or
    a set ``CME213_FLIGHT_DIR``, so library code can call it on its
    failure paths unconditionally.  A dump failing inside a dump is
    dropped rather than recursing, and no failure of the recorder masks
    the original one.
    """
    global _DUMPING
    if not _armed():
        return None
    with _LOCK:
        if _DUMPING:
            return None
        _DUMPING = True
    try:
        try:
            from . import diag
            health = diag.last_health()
            forensics = diag.forensics_state()
        except Exception:  # noqa: BLE001 — a dump without them still
            # beats no dump
            health, forensics = None, None
        try:
            from . import numerics
            numeric = numerics.last_drift() or None
        except Exception:  # noqa: BLE001
            numeric = None
        events = trace.events()[-DUMP_EVENTS:]
        doc = {
            "flight": 1,
            "reason": reason,
            "t": round(time.time(), 6),
            "pid": os.getpid(),
            "rank": os.environ.get("RANK"),
            "incarnation": os.environ.get("CME213_INCARNATION", "0"),
            # read at the dump, so a card CUDA started since is named
            "platform": _platform_info(),
            "traceback": ("".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)) if exc else None),
            "open_spans": _open_spans(events),
            "health": health,
            "forensics": forensics,
            "numerics": numeric,
            "events": events,
            "metrics": metrics.snapshot(),
        }
        out_dir = _dump_dir()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir,
            f"flight-{os.getpid()}-{int(time.time() * 1000)}"
            f"-{next(_DUMP_SEQ)}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        trace.record_event("flight-dump", reason=reason, path=path,
                           events=len(events))
        trace.flush_sink()
        return path
    except Exception:  # noqa: BLE001
        return None  # the recorder must never mask the original failure
    finally:
        with _LOCK:
            _DUMPING = False


def _excepthook(exc_type, exc, tb):
    dump("unhandled-exception", exc=exc)
    hook = _PREV_EXCEPTHOOK or sys.__excepthook__
    hook(exc_type, exc, tb)


def _signal_handler(signum, frame):
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    dump(f"signal:{name}")
    # die with the signal's own semantics (exit status, core dump, a
    # supervisor's SIGKILL escalation) rather than swallowing it
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install(dir: str | None = None) -> None:
    """Arm the recorder: chain ``sys.excepthook`` and register the fatal
    signal handlers.  Idempotent; safe from any thread (off the main thread
    the signal handlers are skipped, the excepthook still works)."""
    global _INSTALLED, _DIR, _PREV_EXCEPTHOOK
    with _LOCK:
        if dir:
            _DIR = dir
        if _INSTALLED:
            return
        _INSTALLED = True
        _PREV_EXCEPTHOOK = sys.excepthook
    sys.excepthook = _excepthook
    for sig_name in FATAL_SIGNALS:
        sig = getattr(signal, sig_name, None)
        if sig is None:
            continue
        try:
            existing = signal.getsignal(sig)
            # leave an application's handler alone
            if existing in (signal.SIG_DFL, signal.SIG_IGN, None):
                signal.signal(sig, _signal_handler)
        except (ValueError, OSError):
            pass  # not the main thread, or an unsupported signal


def install_from_env() -> bool:
    """``install()`` only when ``CME213_FLIGHT_DIR`` is set: the opt-in
    for library paths (checkpointed solves, the serving loop), where an
    unconditional excepthook swap would surprise an embedding program."""
    if os.environ.get(FLIGHT_DIR_ENV):
        install()
        return True
    return False


def _uninstall_for_tests() -> None:
    """Reset the module's state (tests only; signal dispositions are not
    restored)."""
    global _INSTALLED, _DIR, _PREV_EXCEPTHOOK
    with _LOCK:
        if _INSTALLED and _PREV_EXCEPTHOOK is not None:
            sys.excepthook = _PREV_EXCEPTHOOK
        _INSTALLED = False
        _DIR = None
        _PREV_EXCEPTHOOK = None
