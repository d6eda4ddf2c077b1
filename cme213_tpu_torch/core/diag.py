"""Device-health doctor and staged kernel forensics.

Counterpart of ``cme213_tpu/core/diag.py``.  The reference pins every
failure to the call that caused it (``checkCudaErrors`` around every API
call, ``cudaGetLastError`` after every launch,
``hw/hw1/programming/mp1-util.h:8-18``).  The port's kernels are built at
first use and launched asynchronously, so a build failure, a launch error
and a dead card can all surface far from their cause.  This module is the
layer that says which, in two pillars:

- **Device health** (:func:`health_report`): a staged probe ladder — device
  enumeration (``torch.cuda.device_count``, ``get_device_name``,
  ``get_device_capability``), a memory snapshot (``mem_get_info``,
  ``memory_stats``), a timed liveness op with a synchronise — where every
  stage runs under a watchdog timeout, so a hung device yields a *report*
  saying which stage hung, never a hung doctor.  Reports emit a
  ``device-health`` event, set ``diag.device.*`` gauges, and append to a
  persistent JSONL history ring under ``CME213_DIAG_DIR``.  The ladder
  probes ``cuda`` unless asked for another device; with no card it
  reports unhealthy and never probes the CPU in the card's place.

- **Staged forensics** (:func:`stage_scope` / :func:`failure_stage`):
  each phase of a rung's life — ``lower``, ``compile``, ``execute``,
  ``conformance`` — tags any exception that escapes it with the stage (an
  attribute on the exception, because contextvars unwind before the
  ladder's handler runs).  ``with_fallback`` and the headline bench carry
  the tag onto ``kernel-failure`` events.  Without a tag the stage comes
  from the message: the port's build errors (``nvcc``, ``ptxas``) are
  ``compile``, its launch errors (``cudaError``, "CUDA error") are
  ``execute``, and the JAX package's markers keep their meaning.
  :func:`forensics_state` exposes the open and last-failed stage.

The JAX package's third pillar, predicted-vs-measured cost attribution
(``measured_cost`` over XLA's ``cost_analysis``, ``check_attribution``,
``calibrate``), runs from its program cache and is not ported yet.

CLI: ``python -m cme213_tpu_torch doctor [--json] [--device=cpu]``
(``doctor_cli.py``).  This module imports only the standard library and
sibling modules (``metrics``, ``trace``, lazily ``faults``, ``platform``
and torch), so the resilience layer can import it without cycles.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

#: directory for the persistent health-history ring (unset = no ring)
DIAG_DIR_ENV = "CME213_DIAG_DIR"
#: per-stage watchdog budget for health probes, seconds
TIMEOUT_ENV = "CME213_DOCTOR_TIMEOUT_S"

RING_NAME = "health-ring.jsonl"
RING_CAP = 256

#: the dispatch stages forensics attributes failures to, in ladder order
STAGES = ("lower", "compile", "execute", "conformance")

#: attribute carried on exceptions (contextvars unwind before the
#: ladder's handler runs, so the tag must travel WITH the exception)
STAGE_ATTR = "_cme213_stage"

_LOCK = threading.Lock()
_LAST_HEALTH: dict | None = None
_OPEN_STAGE: dict | None = None
_LAST_FAILED_STAGE: dict | None = None

# message fragments that identify a stage when an exception carries no
# explicit tag.  The port's own: its kernel build (``ops/_kernels.py``:
# "nvcc not found", "nvcc failed on ...", ptxas output) and its launch
# errors ("... launch failed: ... (cudaError N; ...)", torch's "CUDA
# error: ...").  The JAX package's: Mosaic/MLIR noise means lowering
# died; vmem exhaustion and compile errors mean codegen died.
_BUILD_MARKERS = ("nvcc", "ptxas")
_LAUNCH_MARKERS = ("cudaerror", "cuda error")
_LOWER_MARKERS = ("mosaic", "mlir", "lowering", "unsupported",
                  "unimplemented")
_COMPILE_MARKERS = ("compil", "vmem")


# --------------------------------------------------------- staged forensics

def mark_stage(exc: BaseException, stage: str) -> BaseException:
    """Tag ``exc`` with the dispatch stage it escaped from (first tag
    wins — the innermost scope knows best)."""
    if getattr(exc, STAGE_ATTR, None) is None:
        try:
            setattr(exc, STAGE_ATTR, stage)
        except Exception:  # noqa: BLE001 — slotted exceptions: heuristics
            pass           # in failure_stage still apply
    return exc


def _tagged_stage(exc: BaseException) -> str | None:
    """Explicit stage tag on ``exc`` or anything in its cause chain."""
    seen = set()
    cur: BaseException | None = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        s = getattr(cur, STAGE_ATTR, None)
        if s:
            return s
        cur = cur.__cause__ or cur.__context__
    return None


def failure_stage(exc: BaseException, default: str = "execute") -> str:
    """Which dispatch stage ``exc`` belongs to: the explicit tag when one
    was attached (a ``compile``-tagged error whose message names a
    lowering failure is refined to ``lower``), else message heuristics
    (:func:`stage_for_message`), else ``default``."""
    msg = f"{type(exc).__name__}: {exc}".lower()
    tagged = _tagged_stage(exc)
    if (tagged == "compile" and any(m in msg for m in _LOWER_MARKERS)
            and not any(m in msg for m in _BUILD_MARKERS)):
        return "lower"
    if tagged:
        return tagged
    return stage_for_message(msg, default=default)


def stage_for_message(message: str, default: str = "execute") -> str:
    """Stage heuristics over bare error text (for failure rows that cross
    a process boundary, where the exception object is gone)."""
    msg = str(message).lower()
    if any(m in msg for m in _BUILD_MARKERS):
        return "compile"
    if any(m in msg for m in _LAUNCH_MARKERS):
        return "execute"
    if any(m in msg for m in _LOWER_MARKERS):
        return "lower"
    if any(m in msg for m in _COMPILE_MARKERS):
        return "compile"
    if "conformance" in msg:
        return "conformance"
    return default if default in STAGES else "execute"


@contextmanager
def stage_scope(op: str, stage: str):
    """Attribute any exception escaping the body to ``(op, stage)`` and
    track it as the open forensics stage."""
    global _OPEN_STAGE, _LAST_FAILED_STAGE
    prev = _OPEN_STAGE
    frame = {"op": op, "stage": stage, "t": round(time.time(), 6)}
    _OPEN_STAGE = frame
    try:
        yield
    except BaseException as e:
        mark_stage(e, stage)
        with _LOCK:
            _LAST_FAILED_STAGE = dict(frame, error=type(e).__name__)
        raise
    finally:
        _OPEN_STAGE = prev


def forensics_state() -> dict:
    """Open and last-failed stage frames (both None when quiet)."""
    with _LOCK:
        return {"open": dict(_OPEN_STAGE) if _OPEN_STAGE else None,
                "last_failed": (dict(_LAST_FAILED_STAGE)
                                if _LAST_FAILED_STAGE else None)}


# ------------------------------------------------------- health probe ladder

def _run_stage(name: str, fn, timeout_s: float) -> dict:
    """Run one probe under a watchdog: a daemon thread does the work, the
    caller waits at most ``timeout_s`` — a hung device becomes a
    ``timed_out`` stage row instead of a hung doctor."""
    done = threading.Event()
    result: dict = {}

    def runner():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — reported, not raised
            result["error"] = f"{type(e).__name__}: {e}"[:300]
        finally:
            done.set()

    t0 = time.perf_counter()
    threading.Thread(target=runner, daemon=True,
                     name=f"diag-{name}").start()
    finished = done.wait(timeout_s)
    row = {"stage": name, "ok": False,
           "ms": round((time.perf_counter() - t0) * 1e3, 3)}
    if not finished:
        row["timed_out"] = True
        row["detail"] = f"no response within {timeout_s}s"
    elif "error" in result:
        row["detail"] = result["error"]
    else:
        row["ok"] = True
        row["detail"] = result.get("value")
    return row


def _probe_enumerate(device=None) -> dict:
    import torch

    from .platform import resolve_device

    dev = resolve_device(device)  # raises when there is no card
    if dev.type != "cuda":
        return {"platform": dev.type, "device_count": 1,
                "devices": [{"id": 0, "kind": dev.type,
                             "process_index": 0}]}
    n = torch.cuda.device_count()
    return {"platform": "cuda", "device_count": n,
            "devices": [{"id": i, "kind": torch.cuda.get_device_name(i),
                         "capability": list(
                             torch.cuda.get_device_capability(i)),
                         "process_index": 0} for i in range(n)]}


def _probe_memory(device=None) -> dict:
    import torch

    from .platform import resolve_device

    if resolve_device(device).type != "cuda":
        return {"unavailable": True}
    out = {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        out[str(i)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_free": int(free)}
    return out if out else {"unavailable": True}


def _probe_liveness(device=None) -> dict:
    from .faults import InjectedFault, maybe_unreachable

    if maybe_unreachable("diag.liveness"):
        raise InjectedFault("injected: device unreachable")
    import torch

    from .platform import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    x = torch.ones((8, 8), device=dev) * 2 + 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if float(x.sum().item()) != 192.0:
        raise RuntimeError(f"liveness op gave {x.sum().item()}, not 192")
    return {"probe_ms": round((time.perf_counter() - t0) * 1e3, 3)}


def health_report(timeout_s: float | None = None, ring: bool = True,
                  device=None) -> dict:
    """Run the staged health ladder on ``device`` (default ``cuda``) and
    return a JSON-able report.

    Stages run in order; ``memory`` is advisory (the CPU has no memory
    snapshot), so ``healthy`` is ``enumerate ok AND liveness ok``.  With no
    card and no ``device``, enumeration fails and the report is unhealthy.
    Side effects: a ``device-health`` event, ``diag.device.*`` gauges, the
    module-level last-health snapshot, and — when ``CME213_DIAG_DIR`` is
    set and ``ring`` — one appended line in the persistent history ring.
    """
    from .metrics import gauge
    from .trace import record_event

    if timeout_s is None:
        timeout_s = float(os.environ.get(TIMEOUT_ENV, "30") or 30)

    stages = [_run_stage("enumerate", lambda: _probe_enumerate(device),
                         timeout_s)]
    enum_ok = stages[0]["ok"]
    enum_detail = stages[0]["detail"] if enum_ok else {}
    if enum_ok:
        stages.append(_run_stage("memory", lambda: _probe_memory(device),
                                 timeout_s))
        stages.append(_run_stage("liveness",
                                 lambda: _probe_liveness(device), timeout_s))
    by_name = {s["stage"]: s for s in stages}
    live = by_name.get("liveness", {"ok": False})
    healthy = bool(enum_ok and live["ok"])
    probe_ms = (live.get("detail") or {}).get("probe_ms") if live["ok"] \
        else None
    platform = enum_detail.get("platform") if enum_ok else None
    device_count = enum_detail.get("device_count", 0) if enum_ok else 0

    report = {
        "doctor": 1,
        "t": round(time.time(), 6),
        "pid": os.getpid(),
        "rank": os.environ.get("RANK", ""),
        "incarnation": int(os.environ.get("CME213_INCARNATION", "0") or 0),
        "healthy": healthy,
        "platform": platform,
        "device_count": device_count,
        "probe_ms": probe_ms,
        "stages": stages,
    }

    gauge("diag.device.healthy").set(1.0 if healthy else 0.0)
    gauge("diag.device.count").set(float(device_count))
    if probe_ms is not None:
        gauge("diag.device.probe_ms").set(float(probe_ms))
    mem = by_name.get("memory")
    if mem is not None and mem["ok"] and isinstance(mem["detail"], dict):
        in_use = sum(v.get("bytes_in_use", 0)
                     for v in mem["detail"].values()
                     if isinstance(v, dict))
        if in_use:
            gauge("diag.device.memory_bytes_in_use").set(float(in_use))

    record_event("device-health", healthy=healthy, platform=platform,
                 devices=device_count, probe_ms=probe_ms)

    global _LAST_HEALTH
    with _LOCK:
        _LAST_HEALTH = report
    if ring:
        path = _append_ring(report)
        if path:
            report["ring_path"] = path
    return report


def last_health() -> dict | None:
    """Most recent in-process health report (None before any probe)."""
    with _LOCK:
        return dict(_LAST_HEALTH) if _LAST_HEALTH else None


def ring_path() -> str | None:
    d = os.environ.get(DIAG_DIR_ENV, "").strip()
    return os.path.join(d, RING_NAME) if d else None


def _append_ring(report: dict) -> str | None:
    """Append one report line to the JSONL history ring, keeping the last
    :data:`RING_CAP` entries (rewrite via a temporary file and
    ``os.replace``, so a reader never sees a torn file).  Best-effort: a
    broken disk must not fail a health probe."""
    path = ring_path()
    if not path:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lines: list[str] = []
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
        lines.append(json.dumps(report, default=str))
        lines = lines[-RING_CAP:]
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — diagnostics never take down the host
        return None


def read_ring() -> list:
    """Parsed entries of the health ring (oldest first; [] when absent)."""
    path = ring_path()
    if not path or not os.path.exists(path):
        return []
    out = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                continue
    return out


def reset() -> None:
    """Forget in-process diagnostic state (tests)."""
    global _LAST_HEALTH, _OPEN_STAGE, _LAST_FAILED_STAGE
    with _LOCK:
        _LAST_HEALTH = None
        _OPEN_STAGE = None
        _LAST_FAILED_STAGE = None
