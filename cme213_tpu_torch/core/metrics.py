"""In-process metrics registry: named counters, gauges, histograms.

Counterpart of ``cme213_tpu/core/metrics.py``, the same registry with the
same names, snapshots and Prometheus text, so a scraper or a dashboard
reads the port as it reads the JAX package.  Solvers increment named
instruments on their host path; ``snapshot()`` is what the sweep harness
(``bench/run_all.py``) and the trace sink (a ``metrics-snapshot`` event
at exit) serialize; ``render_prometheus()`` renders the registry in the
Prometheus text format (dotted-name suffixes folded into labels for the
known families) and ``write_exposition()`` dumps it atomically to
``CME213_METRICS_FILE``::

    from cme213_tpu_torch.core import metrics
    metrics.counter("fallback.demotions").inc()
    metrics.histogram("commit.ms").observe(12.3)
    metrics.gauge("gang.world").set(4)

Instruments are created on first use and process-global; snapshotting is
lock-consistent.  Histograms keep a bounded ring of recent observations
(``KEEP`` = 4096) for percentiles plus exact count/sum.  Everything here
is host-side dict and deque work, and exactly zero when never called.

``delta(before, after)`` diffs two snapshots (counter/histogram-count
deltas, latest gauge values): what ``run_all`` attaches to each sweep in
``metrics.json``.
"""

from __future__ import annotations

import atexit
import math
import os
import re
import threading
from bisect import bisect_left
from collections import deque

#: optional path for a Prometheus text-format dump, written atomically at
#: interpreter exit (and periodically by long-running callers such as the
#: serving loop) so external scrapers read live state without parsing
#: trace JSONL
METRICS_FILE_ENV = "CME213_METRICS_FILE"

#: truthy -> render histograms in the pre-bucket quantile-summary form
#: (``{quantile="..."}`` lines) instead of native ``_bucket`` families
SUMMARY_COMPAT_ENV = "CME213_METRICS_SUMMARY_COMPAT"

#: observations retained per histogram for percentile estimates
KEEP = 4096

#: log-spaced cumulative-bucket upper bounds (powers of two from 0.25 to
#: 32768 — ms-scale latencies land mid-range), plus an implicit +Inf;
#: exact per-bucket counts are kept incrementally so the Prometheus
#: rendering needs no window replay and merges across ranks exactly
BUCKET_BOUNDS: tuple[float, ...] = tuple(
    float(2.0 ** e) for e in range(-2, 16))

_LOCK = threading.Lock()
_COUNTERS: dict[str, "Counter"] = {}
_GAUGES: dict[str, "Gauge"] = {}
_HISTOGRAMS: dict[str, "Histogram"] = {}


class Counter:
    """Monotonic named count (demotions, retries, commits, faults)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> "Counter":
        with _LOCK:
            self.value += n
        return self


class Gauge:
    """Last-write-wins named value (world size, live epoch, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = None

    def set(self, value) -> "Gauge":
        with _LOCK:
            self.value = value
        return self


class Histogram:
    """Named distribution: exact count/sum/min/max plus percentiles over
    the last ``KEEP`` observations (a ring — bounded by construction)."""

    __slots__ = ("name", "count", "total", "min", "max", "_recent",
                 "buckets")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._recent: deque = deque(maxlen=KEEP)
        # per-bucket (non-cumulative) counts; index len(BUCKET_BOUNDS)
        # is the +Inf overflow bucket
        self.buckets: list[int] = [0] * (len(BUCKET_BOUNDS) + 1)

    def observe(self, value: float) -> "Histogram":
        value = float(value)
        with _LOCK:
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self._recent.append(value)
            self.buckets[bisect_left(BUCKET_BOUNDS, value)] += 1
        return self

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over the retained window.

        ``q`` is a fraction in [0, 1].  The result is the nearest-rank
        order statistic — ``sorted(window)[ceil(q * n) - 1]`` (clamped to
        the ends, so ``q=0`` is the window minimum and ``q=1`` the window
        maximum) — computed over the last ``KEEP`` observations only:
        once the ring has wrapped, older observations no longer influence
        percentiles (count/sum/min/max stay exact over the full stream).
        Returns None when no observations were retained.
        """
        with _LOCK:
            vals = sorted(self._recent)
        return _nearest_rank(vals, q)

    def _summary_locked(self) -> dict:
        vals = sorted(self._recent)

        def pct(q):
            return _nearest_rank(vals, q)

        return {
            "count": self.count,
            "sum": round(self.total, 6),
            "mean": round(self.total / self.count, 6) if self.count else None,
            "min": self.min,
            "max": self.max,
            "p50": pct(0.50),
            "p90": pct(0.90),
            "p99": pct(0.99),
            "buckets": list(self.buckets),
        }


def _nearest_rank(sorted_vals, q: float) -> float | None:
    """Nearest-rank order statistic of pre-sorted values; None if empty.

    Rank is ``ceil(q * n)`` (1-based), clamped into [1, n] so q=0 yields
    the minimum and q=1 the maximum of the given window.
    """
    n = len(sorted_vals)
    if not n:
        return None
    rank = math.ceil(q * n)
    return sorted_vals[min(n - 1, max(0, rank - 1))]


def counter(name: str) -> Counter:
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter(name)
    return c


def gauge(name: str) -> Gauge:
    with _LOCK:
        g = _GAUGES.get(name)
        if g is None:
            g = _GAUGES[name] = Gauge(name)
    return g


def histogram(name: str) -> Histogram:
    with _LOCK:
        h = _HISTOGRAMS.get(name)
        if h is None:
            h = _HISTOGRAMS[name] = Histogram(name)
    return h


def snapshot() -> dict:
    """Lock-consistent ``{counters, gauges, histograms}`` view of the
    registry — JSON-serializable (what trace files and bench artifacts
    embed)."""
    with _LOCK:
        return {
            "counters": {k: c.value for k, c in sorted(_COUNTERS.items())},
            "gauges": {k: g.value for k, g in sorted(_GAUGES.items())},
            "histograms": {k: h._summary_locked()
                           for k, h in sorted(_HISTOGRAMS.items())},
        }


def delta(before: dict, after: dict) -> dict:
    """What changed between two snapshots: nonzero counter deltas, gauges
    at their ``after`` values, histograms that saw new observations (with
    their ``after`` percentiles — percentiles don't subtract)."""
    counters = {}
    for k, v in after.get("counters", {}).items():
        d = v - before.get("counters", {}).get(k, 0)
        if d:
            counters[k] = d
    histograms = {}
    for k, h in after.get("histograms", {}).items():
        d = h["count"] - before.get("histograms", {}).get(k, {}).get("count", 0)
        if d:
            histograms[k] = {**h, "count_delta": d}
    return {"counters": counters,
            "gauges": dict(after.get("gauges", {})),
            "histograms": histograms}


#: metric-name characters Prometheus allows; everything else becomes "_"
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

#: dotted-name families whose trailing segments are really label values;
#: (regex, family name, label names) — first match wins, everything else
#: renders as a flat sanitized name
_LABEL_FAMILIES = (
    (re.compile(r"^serve\.shed\.(?P<reason>.+)$"),
     "serve_shed_total", ("reason",)),
    (re.compile(r"^serve\.tenant\.(?P<tenant>[^.]+)\.(?P<what>[^.]+)$"),
     None, ("tenant",)),          # family derived from <what> below
    (re.compile(r"^served\.(?P<op>[^.]+)\.(?P<rung>[^.]+)$"),
     "served_total", ("op", "rung")),
    (re.compile(r"^faults\.(?P<kind>.+)$"),
     "faults_total", ("kind",)),
)


def _sanitize_name(name: str) -> str:
    return _NAME_BAD.sub("_", name)


def _escape_label(value) -> str:
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"').replace("\n", "\\n"))


def _counter_series(name: str) -> tuple[str, str]:
    """Map a dotted counter name to (family, labels-suffix).

    Known families (shed reasons, per-tenant counters, per-rung serve
    counts, fault kinds) fold their trailing segments into labels so a
    scraper sees one time series per family; anything else renders flat.
    """
    for rx, family, label_names in _LABEL_FAMILIES:
        m = rx.match(name)
        if not m:
            continue
        if family is None:  # serve.tenant.<t>.<what> -> per-<what> family
            family = f"serve_tenant_{_sanitize_name(m.group('what'))}_total"
        labels = ",".join(f'{ln}="{_escape_label(m.group(ln))}"'
                          for ln in label_names)
        return f"cme213_{family}", "{" + labels + "}"
    return f"cme213_{_sanitize_name(name)}_total", ""


def merge_snapshots(snaps: dict[str, dict]) -> dict:
    """Fold per-rank snapshots (``{rank-label: snapshot}``) into one
    fleet rollup — the Prometheus-federation aggregate the launcher
    writes for a whole gang.

    Counters sum.  Numeric gauges take the fleet **max** (the
    conservative "worst rank" reading for burn/depth/degraded-style
    gauges; non-numeric gauges are dropped, matching the renderer).
    Histograms sum exact ``count``/``sum``, fold ``min``/``max`` with
    min/max, and take the per-rank max of each window percentile — an
    upper bound, since the retained windows cannot be re-interleaved.
    """
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    for _, snap in sorted(snaps.items(), key=lambda kv: str(kv[0])):
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in (snap.get("gauges") or {}).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            gauges[k] = v if k not in gauges else max(gauges[k], v)
        for k, h in (snap.get("histograms") or {}).items():
            m = hists.get(k)
            if m is None:
                hists[k] = dict(h)
                continue
            m["count"] = (m.get("count") or 0) + (h.get("count") or 0)
            m["sum"] = round((m.get("sum") or 0) + (h.get("sum") or 0), 6)
            for key, fold in (("min", min), ("max", max),
                              ("p50", max), ("p90", max), ("p99", max)):
                a, b = m.get(key), h.get(key)
                m[key] = b if a is None else (a if b is None else fold(a, b))
            ba, bb = m.get("buckets"), h.get("buckets")
            if ba and bb and len(ba) == len(bb):
                m["buckets"] = [x + y for x, y in zip(ba, bb)]
            elif bb and not ba:
                m["buckets"] = list(bb)
    for h in hists.values():
        h["mean"] = (round((h.get("sum") or 0) / h["count"], 6)
                     if h.get("count") else None)
    return {"counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": dict(sorted(hists.items())),
            "ranks": sorted(snaps, key=str)}


def _merge_labels(labels: str, extra: str | None) -> str:
    """Combine a rendered ``{...}`` label block (or ``""``) with one
    extra ``key="value"`` pair."""
    if not extra:
        return labels
    if not labels:
        return "{" + extra + "}"
    return labels[:-1] + "," + extra + "}"


def _summary_compat() -> bool:
    raw = os.environ.get(SUMMARY_COMPAT_ENV, "")
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


def _help_text(family: str) -> str:
    prefix = "cme213_"
    stem = family[len(prefix):] if family.startswith(prefix) else family
    # the JAX package's HELP text: both packages expose one exposition
    return f"cme213_tpu registry metric {stem.replace('_', ' ')}"


def render_prometheus(snap: dict | None = None, *,
                      fleet: dict[str, dict] | None = None,
                      help_lines: bool = True) -> str:
    """Render a snapshot (default: the live registry) in the Prometheus
    text exposition format.

    Counters become ``cme213_<name>_total``; a few dotted families
    (``serve.shed.<reason>``, ``serve.tenant.<t>.<what>``,
    ``served.<op>.<rung>``, ``faults.<kind>``) fold their variable
    segments into labels.  Numeric gauges render as gauges (non-numeric
    gauge values are skipped — Prometheus has no string samples).
    Histograms render as native cumulative-bucket families:
    ``_bucket{le="<bound>"}`` lines over :data:`BUCKET_BOUNDS` plus
    ``le="+Inf"`` and exact ``_sum``/``_count``.  Setting
    ``CME213_METRICS_SUMMARY_COMPAT`` (truthy) restores the historical
    quantile-summary rendering (``{quantile="0.5|0.9|0.99"}`` lines
    from the retained window); snapshots predating the bucket counts
    fall back to that form per metric.  Every family leads with a
    ``# HELP`` line (suppress with ``help_lines=False``).

    With ``fleet`` — a ``{rank-label: snapshot}`` mapping — the
    federated form renders instead: the :func:`merge_snapshots` rollup
    as the unlabeled series, then every per-rank sample again with a
    ``rank="<label>"`` label, one family block each — the scrape
    surface a replica router/autoscaler consumes.
    """
    fams: dict[str, dict] = {}

    def add(family: str, typ: str, line: str) -> None:
        fam = fams.get(family)
        if fam is None:
            fam = fams[family] = {"type": typ, "samples": []}
        fam["samples"].append(line)

    def emit(s: dict, rank_label: str | None = None) -> None:
        extra = (f'rank="{_escape_label(rank_label)}"'
                 if rank_label is not None else None)
        for name, value in (s.get("counters") or {}).items():
            family, labels = _counter_series(name)
            add(family, "counter",
                f"{family}{_merge_labels(labels, extra)} {value}")
        for name, value in (s.get("gauges") or {}).items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            pname = f"cme213_{_sanitize_name(name)}"
            add(pname, "gauge",
                f"{pname}{_merge_labels('', extra)} {value}")
        compat = _summary_compat()
        for name, h in (s.get("histograms") or {}).items():
            pname = f"cme213_{_sanitize_name(name)}"
            raw = h.get("buckets")
            if not compat and raw and len(raw) == len(BUCKET_BOUNDS) + 1:
                cum = 0
                for bound, n in zip(BUCKET_BOUNDS, raw):
                    cum += n
                    blabels = _merge_labels(
                        f'{{le="{format(bound, "g")}"}}', extra)
                    add(pname, "histogram", f"{pname}_bucket{blabels} {cum}")
                inf_labels = _merge_labels('{le="+Inf"}', extra)
                add(pname, "histogram",
                    f"{pname}_bucket{inf_labels} {cum + raw[-1]}")
                kind = "histogram"
            else:
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    if h.get(key) is not None:
                        qlabels = _merge_labels(f'{{quantile="{q}"}}', extra)
                        add(pname, "summary", f"{pname}{qlabels} {h[key]}")
                kind = "summary"
            add(pname, kind,
                f"{pname}_sum{_merge_labels('', extra)} {h.get('sum', 0)}")
            add(pname, kind,
                f"{pname}_count{_merge_labels('', extra)} "
                f"{h.get('count', 0)}")

    if fleet is not None:
        emit(merge_snapshots(fleet))
        for label, s in sorted(fleet.items(), key=lambda kv: str(kv[0])):
            emit(s, rank_label=str(label))
    else:
        emit(snapshot() if snap is None else snap)

    lines: list[str] = []
    kind_order = {"counter": 0, "gauge": 1, "summary": 2, "histogram": 2}
    for family in sorted(fams, key=lambda f: (kind_order[fams[f]["type"]],
                                              f)):
        fam = fams[family]
        if help_lines:
            lines.append(f"# HELP {family} {_help_text(family)}")
        lines.append(f"# TYPE {family} {fam['type']}")
        if fam["type"] == "counter":
            lines.extend(sorted(fam["samples"]))
        else:
            lines.extend(fam["samples"])
    return "\n".join(lines) + "\n" if lines else ""


def write_exposition(path: str | None = None) -> str | None:
    """Atomically dump ``render_prometheus()`` to ``path`` (default: the
    ``CME213_METRICS_FILE`` env var).  Returns the path written, or None
    when no destination is configured.  tmp + ``os.replace`` so a scraper
    racing the writer never reads a torn file."""
    path = path or os.environ.get(METRICS_FILE_ENV)
    if not path:
        return None
    text = render_prometheus()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def reset() -> None:
    """Forget every instrument (tests)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTOGRAMS.clear()


#: exposition paths the atexit writer must leave alone — a launcher that
#: already wrote the gang's *federated* file registers it here so its own
#: single-process snapshot doesn't clobber the fleet view at shutdown
_EXIT_EXPOSITION_SKIP: set = set()


def suppress_exit_exposition(path: str) -> None:
    """Exclude ``path`` from the atexit exposition write (the
    ``metrics-snapshot`` trace record is still emitted)."""
    _EXIT_EXPOSITION_SKIP.add(os.path.abspath(path))


def _emit_exit_snapshot() -> None:
    """At interpreter exit, append one ``metrics-snapshot`` event so sink
    files end with the process's final registry state.  Skipped when the
    registry was never touched (no instruments -> no record)."""
    if not (_COUNTERS or _GAUGES or _HISTOGRAMS):
        return
    from .trace import flush_sink, record_event

    record_event("metrics-snapshot", metrics=snapshot())
    flush_sink()
    dest = os.environ.get(METRICS_FILE_ENV)
    if dest and os.path.abspath(dest) in _EXIT_EXPOSITION_SKIP:
        return
    try:
        write_exposition()
    except OSError:
        pass  # a dead exposition path must not mask the real exit cause


atexit.register(_emit_exit_snapshot)
