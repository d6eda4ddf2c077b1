"""Multi-window burn-rate SLO monitoring for the serving front end.

Counterpart of ``cme213_tpu/serve/slo.py``: pure logic on the port's
``core.resilience.Clock``, metrics and events.

Degraded mode (``serve/server.py``) originally triggered on raw queue
depth — a capacity symptom, not an objective.  This module watches the
objectives themselves, SRE-style: each declarative :class:`Objective`
(p99 latency bound, shed-rate budget, error-rate budget) is evaluated
over a rolling **short** and **long** window, and the *burn rate* — how
fast the error budget is being consumed relative to plan — must exceed
the threshold in **both** windows before the monitor fires.  The
two-window AND is the standard flap filter: the long window proves the
problem is sustained, the short window proves it is still happening.

Burn semantics:

- ``p99_latency_ms``: ``target`` is the latency bound; the budget is the
  allowed fraction of served requests over the bound (default 1%).
  burn = (fraction over bound) / budget — burn 1.0 means exactly
  on-budget, 2.0 means consuming budget twice as fast as allowed.
- ``shed_rate`` / ``error_rate``: ``target`` *is* the budget fraction;
  burn = observed rate / target.
- ``drift_rate``: ``target`` is the allowed fraction of *shadow
  conformance samples* (``core/numerics.py``) over their drift
  tolerance; burn = observed over-tolerance rate / target, evaluated
  over the shadow samples only.  This is the fleet-level view of the
  same signal the per-(op, rung) drift budget demotes rungs on.

Transitions are evented (``slo-burn`` on entry, ``slo-ok`` on recovery)
and the worst short-window burn is exported as the ``serve.slo.burn``
gauge.  Recovery has hysteresis — the short burn must fall to
``threshold * hysteresis`` (default half) before ``slo-ok`` fires — so
the monitor cannot flap on a burn hovering at the threshold.  All timing
comes from an injectable ``core.resilience.Clock``; under a
``VirtualClock`` the whole fire/recover cycle is testable without a
wall-clock sleep.

The server consumes :attr:`SLOMonitor.burning` as a degraded-mode
trigger (checked before the raw depth/p99 triggers — objective violation
is the primary signal; depth is the backstop).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from ..core import metrics
from ..core.resilience import Clock
from ..core.trace import record_event

#: objective kinds (see module docstring for burn semantics)
KINDS = ("p99_latency_ms", "shed_rate", "error_rate", "drift_rate")


@dataclass(frozen=True)
class Objective:
    """One declarative service-level objective."""

    name: str                 # stable key for events/reporting
    kind: str                 # one of KINDS
    target: float             # latency bound (ms) or budget fraction
    budget: float = 0.01      # p99_latency_ms only: allowed over-bound frac

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown objective kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.target <= 0:
            raise ValueError(f"objective target must be > 0, got {self.target}")


class SLOMonitor:
    """Rolling-window burn-rate evaluation over per-request outcomes.

    ``observe()`` one sample per finished request (served, shed, or
    failed); ``evaluate()`` once per scheduling step.  Samples older than
    the long window are pruned, so memory is bounded by arrival rate ×
    ``long_window_s``.
    """

    def __init__(self, objectives, clock: Clock | None = None,
                 short_window_s: float = 5.0, long_window_s: float = 60.0,
                 burn_threshold: float = 2.0, min_samples: int = 10,
                 hysteresis: float = 0.5):
        self.objectives = list(objectives)
        self.clock = clock if clock is not None else Clock()
        self.short_window_s = short_window_s
        self.long_window_s = max(long_window_s, short_window_s)
        self.burn_threshold = burn_threshold
        self.min_samples = max(1, min_samples)
        self.hysteresis = hysteresis
        #: (t, latency_ms | None, shed, failed, drift | None) per
        #: finished request; ``drift`` is None unless the request was a
        #: shadow conformance sample (then True = over tolerance)
        self._samples: deque = deque()
        self._burning: dict[str, bool] = {o.name: False
                                          for o in self.objectives}
        self._last: dict[str, dict] = {}

    # ------------------------------------------------------------ intake

    def observe(self, latency_ms: float | None = None,
                shed: bool = False, failed: bool = False,
                drift: bool | None = None) -> None:
        """Record one finished request (call with the served latency, or
        ``shed=True`` / ``failed=True``; ``drift`` carries a shadow
        conformance sample's over-tolerance verdict when the request was
        sampled)."""
        self._samples.append(
            (self.clock.now(), latency_ms, bool(shed), bool(failed),
             drift if drift is None else bool(drift)))

    def observe_result(self, result) -> None:
        """``observe()`` from a :class:`~.request.SolveResult`."""
        from .request import FAILED, SHED
        self.observe(latency_ms=result.latency_ms,
                     shed=result.status == SHED,
                     failed=result.status == FAILED)

    # -------------------------------------------------------- evaluation

    def _burn(self, objective: Objective, window) -> float | None:
        """Burn rate of one objective over one sample window; None when
        the window has no relevant samples."""
        if objective.kind == "p99_latency_ms":
            lat = [s[1] for s in window if s[1] is not None and not s[2]]
            if not lat:
                return None
            over = sum(1 for v in lat if v > objective.target) / len(lat)
            return over / objective.budget
        if objective.kind == "drift_rate":
            shadow = [s[4] for s in window if s[4] is not None]
            if not shadow:
                return None
            return (sum(1 for v in shadow if v) / len(shadow)
                    / objective.target)
        if not window:
            return None
        if objective.kind == "shed_rate":
            rate = sum(1 for s in window if s[2]) / len(window)
        else:  # error_rate
            rate = sum(1 for s in window if s[3]) / len(window)
        return rate / objective.target

    def evaluate(self) -> dict:
        """Prune, recompute burns, fire transition events, update the
        ``serve.slo.burn`` gauge.  Returns per-objective state (also kept
        for :meth:`state`)."""
        now = self.clock.now()
        while self._samples and self._samples[0][0] < now - self.long_window_s:
            self._samples.popleft()
        long_win = list(self._samples)
        short_win = [s for s in long_win if s[0] >= now - self.short_window_s]

        worst_short = 0.0
        out: dict[str, dict] = {}
        for o in self.objectives:
            burn_short = self._burn(o, short_win)
            burn_long = self._burn(o, long_win)
            if burn_short is not None:
                worst_short = max(worst_short, burn_short)
            was_burning = self._burning[o.name]
            if (not was_burning
                    and burn_short is not None and burn_long is not None
                    and len(short_win) >= self.min_samples
                    and burn_short >= self.burn_threshold
                    and burn_long >= self.burn_threshold):
                self._burning[o.name] = True
                record_event("slo-burn", objective=o.name,
                             burn_short=round(burn_short, 3),
                             burn_long=round(burn_long, 3),
                             threshold=self.burn_threshold)
            elif (was_burning
                  and (burn_short is None
                       or burn_short <= self.burn_threshold * self.hysteresis)):
                self._burning[o.name] = False
                record_event("slo-ok", objective=o.name,
                             burn_short=round(burn_short, 3)
                             if burn_short is not None else 0.0)
            out[o.name] = {
                "kind": o.kind,
                "target": o.target,
                "burn_short": (round(burn_short, 3)
                               if burn_short is not None else None),
                "burn_long": (round(burn_long, 3)
                              if burn_long is not None else None),
                "burning": self._burning[o.name],
            }
        metrics.gauge("serve.slo.burn").set(round(worst_short, 3))
        self._last = out
        return out

    @property
    def burning(self) -> bool:
        """True while any objective is in the burning state."""
        return any(self._burning.values())

    def state(self) -> dict:
        """Last :meth:`evaluate` result (for reports); ``{}`` before the
        first evaluation."""
        return dict(self._last)


def from_flags(clock: Clock | None = None, *,
               p99_ms: float | None = None, shed_rate: float | None = None,
               error_rate: float | None = None,
               drift_rate: float | None = None, short_s: float = 5.0,
               long_s: float = 60.0, burn_threshold: float = 2.0,
               min_samples: int = 10) -> SLOMonitor | None:
    """Build a monitor from CLI-flag values; None when no objective was
    requested (the server then runs without an SLO hook)."""
    objectives = []
    if p99_ms is not None:
        objectives.append(Objective("p99-latency", "p99_latency_ms", p99_ms))
    if shed_rate is not None:
        objectives.append(Objective("shed-rate", "shed_rate", shed_rate))
    if error_rate is not None:
        objectives.append(Objective("error-rate", "error_rate", error_rate))
    if drift_rate is not None:
        objectives.append(Objective("drift-rate", "drift_rate", drift_rate))
    if not objectives:
        return None
    return SLOMonitor(objectives, clock=clock, short_window_s=short_s,
                      long_window_s=long_s, burn_threshold=burn_threshold,
                      min_samples=min_samples)
