"""Deterministic, env-driven fault injection.

Counterpart of ``cme213_tpu/core/faults.py``: the same plan, read once
from ``CME213_FAULTS``, with the same clause grammar (``str(clause)``
round-trips identically in both packages), consulted at the same named
guard points.  Faults fire on exact call counts, never timers or
randomness, so every injected failure is reproducible in CI.

Spec grammar (comma-separated clauses)::

    CME213_FAULTS="clause[,clause...]"

    fail:<op>[:<nth>[:<count>]]   the <nth> call (1-based, default 1) of
                                  ``maybe_fail(op)`` raises InjectedFault,
                                  as do the following <count>-1 calls
                                  (default count 1) — the stand-in for a
                                  launch error out of a named kernel
    nan:<op>[:<nth>]              the <nth> call of ``maybe_poison(op, s)``
                                  returns ``s`` with its first float leaf
                                  NaN-poisoned (a mid-solve blow-up)
    ckpt:truncate[:<nth>]         the <nth> checkpoint file written through
                                  ``maybe_truncate_file`` is cut in half
                                  (a torn write / preempted host)
    ckpt:commit[:<nth>]           the <nth> call of ``maybe_fail_commit``
                                  raises InjectedFault *before* the COMMIT
                                  manifest is published — a crash in the
                                  shard-written-but-uncommitted window of
                                  the distributed commit protocol
                                  (``dist/ckpt.py``); first incarnation
                                  only, so a gang restart recovers
    rankkill:<rank>[:<step>]      ``maybe_kill_rank()`` hard-exits with
                                  ``KILL_EXIT`` on guarded step <step>
                                  (0-based, default 0) when
                                  ``RANK == rank`` and this is the
                                  process's first incarnation
                                  (``CME213_INCARNATION`` unset or 0) — so a
                                  launcher restart survives deterministically
    replica-kill:<rank>[:<nth>]   ``maybe_kill_replica()`` SIGKILLs the
                                  serving replica whose
                                  ``RANK == rank`` on the <nth>
                                  guarded batch (1-based, default 1) —
                                  mid-batch, after requests are accepted
                                  and queued but before they execute, so
                                  the fleet's zero-loss requeue path
                                  (``serve/fleet.py``) is deterministically
                                  testable; the flight recorder dumps
                                  first (SIGKILL skips atexit); first
                                  incarnation only, so the relaunched
                                  replica serves clean
    wrong:<op>[:<nth>]            the <nth> call of ``maybe_perturb(op, v)``
                                  returns ``v`` with ONE element of its
                                  first float leaf perturbed (finite, large)
                                  — the silently-wrong kernel the
                                  conformance gate (``core/conformance.py``)
                                  exists to catch; first incarnation only,
                                  like rankkill
    drift:<op>[:<scale>[:<nth>]]  every call of ``maybe_drift(op, v)`` from
                                  the <nth> (1-based, default 1) onward
                                  returns ``v`` with every float leaf
                                  scaled by ``1 + <scale>`` (default 1e-3)
                                  — a *small* relative error, below the
                                  ``wrong:`` blow-up, that only the shadow
                                  conformance sampler (``core/numerics.py``)
                                  can see; persistent (a drifted kernel
                                  stays drifted) so the drift error budget
                                  deterministically burns; first
                                  incarnation only, like ``wrong:``
    oom:<op>[:<nth>]              the <nth> call of ``maybe_oom(op)`` raises
                                  a synthetic RESOURCE_EXHAUSTED
                                  (``InjectedResourceExhausted``) — the
                                  device out-of-memory an admission layer
                                  degrades under;
                                  first incarnation only
    slow:<op>[:<ms>[:<nth>[:<count>]]]
                                  calls <nth> .. <nth>+<count>-1 (1-based,
                                  default nth 1, count 1) of
                                  ``maybe_slow(op)`` inject <ms>
                                  milliseconds of latency (default 100) —
                                  the deterministic straggler the serving
                                  layer's deadline/degradation paths are
                                  tested against on CPU; a large <count>
                                  models *sustained* overload (what trips
                                  the SLO burn-rate monitor); the sleep
                                  hook is injectable so tests advance a
                                  virtual clock instead of waiting
                                  wall-time; first incarnation only
    unreachable:<nth>[:<count>]   calls <nth> .. <nth>+<count>-1 (1-based)
                                  of ``maybe_unreachable(...)`` report the
                                  device as unreachable — consulted by
                                  ``platform.device_preflight`` and the
                                  doctor's liveness probe
                                  (``core/diag.py``), so a dead device is
                                  deterministically injectable without a
                                  dead device; first incarnation only
    stage:<op>:<stage>[:<nth>[:<count>]]
                                  the <nth> call of
                                  ``maybe_fail_stage(op, stage)`` raises
                                  InjectedFault pre-tagged with the named
                                  dispatch stage (lower | compile |
                                  execute | conformance) — drives the
                                  staged kernel-forensics attribution in
                                  ``core/diag.py`` end to end; first
                                  incarnation only

The modules named above are the JAX package's guard points; the port's
counterparts call the same guards as they are ported.

Op names are dotted paths (``spmv_scan.pallas-fused``, ``heat.pipeline``,
``sweep.heat_bandwidth``); colons are reserved for the grammar.

Zero overhead when disabled: every ``maybe_*`` entry point returns after one
cached ``None`` check, no env re-reads and no torch import at module scope.
The guards sit at solve, sweep and phase level, never inside a per-launch
loop.

The value guards (``maybe_poison``, ``maybe_perturb``, ``maybe_drift``)
walk nested lists, tuples and dicts (dicts in sorted key order, as a JAX
pytree flattens them) and change tensors and numpy arrays: a changed
tensor is a ``clone()`` on its own device, never a host copy, a changed
array a copy, and the caller's leaves are never written.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field

#: exit code of an injected rank kill (distinct from shell/timeout codes)
KILL_EXIT = 113


class InjectedFault(RuntimeError):
    """Deterministic injected failure (stands in for a kernel's launch
    error)."""

    injected = True


class InjectedResourceExhausted(InjectedFault):
    """Synthetic out-of-memory (stands in for
    ``torch.cuda.OutOfMemoryError``); classified as
    ``FailureKind.RESOURCE`` by ``classify_failure``."""


class FaultSpecError(ValueError):
    """Malformed CME213_FAULTS clause."""


@dataclass
class _Clause:
    kind: str           # fail | nan | ckpt | rankkill | replica-kill | wrong
                        # | oom | slow | unreachable | stage | drift
    op: str             # op name ("truncate" for ckpt; rank id for rankkill/
                        # replica-kill; "*" for the op-agnostic unreachable)
    nth: int = 1        # 1-based trigger call (rankkill: 0-based step)
    count: int = 1      # consecutive triggered calls (fail/slow/unreachable)
    ms: float = 0.0     # injected latency (slow) / relative scale (drift)
    stage: str = ""     # dispatch stage (stage only)
    calls: int = 0      # mutable per-clause call counter

    def fires(self) -> bool:
        """Advance the counter; True when this call is in the window."""
        self.calls += 1
        return self.nth <= self.calls < self.nth + self.count

    def __str__(self) -> str:
        """Canonical spec text: ``FaultPlan.parse(str(c))`` rebuilds an
        identical clause (modulo the mutable ``calls`` counter), which is
        what lets the chaos runner bank cocktails as replayable JSON
        fixtures (``core/chaos.py``)."""
        if self.kind == "unreachable":
            return f"unreachable:{self.nth}:{self.count}"
        if self.kind == "stage":
            return f"stage:{self.op}:{self.stage}:{self.nth}:{self.count}"
        if self.kind == "slow":
            return f"slow:{self.op}:{self.ms!r}:{self.nth}:{self.count}"
        if self.kind == "drift":
            # count is the parser's persistent 1<<30, not spec text
            return f"drift:{self.op}:{self.ms!r}:{self.nth}"
        if self.kind == "fail":
            return f"fail:{self.op}:{self.nth}:{self.count}"
        # nan | wrong | oom | ckpt | rankkill | replica-kill: kind:op:nth
        return f"{self.kind}:{self.op}:{self.nth}"


@dataclass
class FaultPlan:
    clauses: list[_Clause] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        clauses = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            parts = raw.split(":")
            kind = parts[0]
            if (kind not in ("fail", "nan", "ckpt", "rankkill",
                             "replica-kill", "wrong", "oom", "slow",
                             "unreachable", "stage", "drift")
                    or len(parts) < 2):
                raise FaultSpecError(
                    f"bad fault clause {raw!r} (kinds: fail:<op>[:nth[:count]]"
                    f", nan:<op>[:nth], wrong:<op>[:nth], oom:<op>[:nth], "
                    f"drift:<op>[:scale[:nth]], "
                    f"slow:<op>[:ms[:nth[:count]]], ckpt:truncate[:nth], "
                    f"rankkill:<rank>[:step], replica-kill:<rank>[:nth], "
                    f"unreachable:<nth>[:count], "
                    f"stage:<op>:<stage>[:nth[:count]])")
            try:
                if kind == "fail":
                    clauses.append(_Clause(
                        kind, parts[1],
                        nth=int(parts[2]) if len(parts) > 2 else 1,
                        count=int(parts[3]) if len(parts) > 3 else 1))
                elif kind == "slow":
                    ms = float(parts[2]) if len(parts) > 2 else 100.0
                    if ms < 0:
                        raise FaultSpecError(
                            f"slow clause needs ms >= 0, got {ms}")
                    clauses.append(_Clause(
                        kind, parts[1], ms=ms,
                        nth=int(parts[3]) if len(parts) > 3 else 1,
                        count=int(parts[4]) if len(parts) > 4 else 1))
                elif kind == "unreachable":
                    clauses.append(_Clause(
                        kind, "*",
                        nth=int(parts[1]),
                        count=int(parts[2]) if len(parts) > 2 else 1))
                elif kind == "stage":
                    if len(parts) < 3 or parts[2] not in (
                            "lower", "compile", "execute", "conformance"):
                        raise FaultSpecError(
                            f"stage clause needs stage:<op>:<stage> with "
                            f"stage in lower|compile|execute|conformance, "
                            f"got {raw!r}")
                    clauses.append(_Clause(
                        kind, parts[1], stage=parts[2],
                        nth=int(parts[3]) if len(parts) > 3 else 1,
                        count=int(parts[4]) if len(parts) > 4 else 1))
                elif kind == "drift":
                    scale = float(parts[2]) if len(parts) > 2 else 1e-3
                    if not scale > 0:
                        raise FaultSpecError(
                            f"drift clause needs scale > 0, got {scale}")
                    # persistent from <nth> onward: a drifted kernel stays
                    # drifted, so the shadow sampler's budget can burn
                    clauses.append(_Clause(
                        kind, parts[1], ms=scale,
                        nth=int(parts[3]) if len(parts) > 3 else 1,
                        count=1 << 30))
                elif kind in ("nan", "wrong", "oom"):
                    clauses.append(_Clause(
                        kind, parts[1],
                        nth=int(parts[2]) if len(parts) > 2 else 1))
                elif kind == "ckpt":
                    if parts[1] not in ("truncate", "commit"):
                        raise FaultSpecError(
                            f"unknown ckpt fault {parts[1]!r}")
                    clauses.append(_Clause(
                        kind, parts[1],
                        nth=int(parts[2]) if len(parts) > 2 else 1))
                elif kind == "replica-kill":
                    clauses.append(_Clause(
                        kind, parts[1],
                        nth=int(parts[2]) if len(parts) > 2 else 1))
                else:  # rankkill
                    clauses.append(_Clause(
                        kind, parts[1],
                        nth=int(parts[2]) if len(parts) > 2 else 0))
            except ValueError as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(f"bad fault clause {raw!r}: {e}") from e
        return cls(clauses)

    def _matching(self, kind: str, op: str):
        return [c for c in self.clauses if c.kind == kind and c.op == op]

    def __str__(self) -> str:
        """The comma-joined spec; ``parse(str(plan))`` round-trips."""
        return ",".join(str(c) for c in self.clauses)

    def reset_counters(self) -> "FaultPlan":
        """Zero every clause's call counter so an already-used plan can
        be re-armed fresh (fixture replay, repeated chaos campaigns)."""
        for c in self.clauses:
            c.calls = 0
        return self


# cache: None = env not read yet; False = read and disabled
_PLAN: FaultPlan | None | bool = None


def active() -> FaultPlan | None:
    """The installed plan, lazily read from ``CME213_FAULTS`` once."""
    global _PLAN
    if _PLAN is None:
        spec = os.environ.get("CME213_FAULTS", "")
        _PLAN = FaultPlan.parse(spec) if spec.strip() else False
    return _PLAN or None


def install(spec: str) -> FaultPlan:
    """Install a plan programmatically (tests); overrides the env."""
    return install_plan(FaultPlan.parse(spec))


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Install an already-built :class:`FaultPlan`, overriding the env —
    the chaos runner's in-process arming path (``core/chaos.py``): a
    drawn cocktail is armed, driven, then swapped back out without ever
    touching ``CME213_FAULTS``.  The caller owns counter state; use
    ``plan.reset_counters()`` to re-arm a used plan fresh."""
    global _PLAN
    _PLAN = plan
    return plan


def reset() -> None:
    """Forget the cached plan; the next guard re-reads the env."""
    global _PLAN
    _PLAN = None


@contextmanager
def injected(spec: str):
    """Scoped plan installation for tests: counters are fresh inside."""
    prev = _PLAN
    try:
        yield install(spec)
    finally:
        globals()["_PLAN"] = prev


def _record(kind: str, op: str, **fields) -> None:
    from .metrics import counter
    from .trace import record_event

    counter(f"faults.{kind}").inc()
    record_event("fault-injected", kind=kind, op=op, **fields)


def maybe_fail(op: str) -> None:
    """Raise InjectedFault if a ``fail:<op>`` clause fires on this call."""
    plan = active()
    if plan is None:
        return
    for c in plan._matching("fail", op):
        if c.fires():
            _record("fail", op, call=c.calls)
            raise InjectedFault(
                f"injected failure in {op} (call {c.calls})")


def _map_leaves(tree, fn):
    """Rebuild ``tree`` with ``fn(index, leaf)`` applied to its leaves in
    flattening order (lists and tuples in order, dicts by sorted key);
    ``fn`` returns the new leaf, or None to keep it, and picks the leaf
    types it changes itself."""
    count = [0]

    def walk(node):
        if isinstance(node, dict):
            walked = {k: walk(node[k]) for k in sorted(node)}
            return {k: walked[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [walk(v) for v in node]
            if hasattr(node, "_fields"):  # a namedtuple
                return type(node)(*items)
            return type(node)(items)
        i = count[0]
        count[0] += 1
        new = fn(i, node)
        return node if new is None else new

    return walk(tree)


def _is_int(t) -> bool:
    import torch

    return not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)


def _with_first(t, change):
    """A contiguous clone of ``t`` with its first element replaced by
    ``change(first)``."""
    import torch

    out = t.clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    flat[0] = change(flat[0])
    return out


def maybe_poison(op: str, state):
    """NaN-poison the first float leaf (a tensor, or a numpy array as a
    restored checkpoint holds) of ``state`` if a ``nan:<op>`` clause fires
    on this call; otherwise return ``state`` unchanged.  The poisoned leaf
    is a copy."""
    import numpy as np
    import torch

    plan = active()
    if plan is None:
        return state
    fire = any(c.fires() for c in plan._matching("nan", op))
    if not fire:
        return state
    done = []

    def poison(i, t):
        if isinstance(t, np.ndarray):
            if done or not np.issubdtype(t.dtype, np.floating) or not t.size:
                return None
            t = np.array(t)
            t.reshape(-1)[0] = np.nan
        elif (done or not torch.is_tensor(t) or not t.is_floating_point()
              or not t.numel()):
            return None
        else:
            t = _with_first(t, lambda x: float("nan"))
        done.append(i)
        _record("nan", op, leaf=i)
        return t

    return _map_leaves(state, poison)


def maybe_perturb(op: str, value):
    """Perturb ONE element of ``value``'s first float tensor if a
    ``wrong:<op>`` clause fires on this call — the silently-wrong kernel a
    conformance gate exists to catch.  The perturbation is finite and
    large (``x -> x + 1 + |x|``), so it trips both bitwise and declared-
    tolerance comparisons.  With no float leaf, one element of the first
    integer leaf has its bits flipped.  A leaf is a tensor or a numpy
    array (a served result or a host-side probe, as the sort golden gate's
    is), as the JAX package perturbs any array.  First incarnation only
    (like ``rankkill``), so a restarted gang re-probes clean.  Returns
    ``value`` unchanged when no clause fires; never writes the caller's
    tensors or arrays."""
    import numpy as np
    import torch

    plan = active()
    if plan is None:
        return value
    fire = any(c.fires() for c in plan._matching("wrong", op))
    if not fire or incarnation() != 0:
        return value
    for pick, np_pick, change in (
            (lambda t: t.is_floating_point(), np.floating,
             lambda x: x + 1.0 + abs(x)),
            (_is_int, np.integer, lambda x: ~x)):
        done = []

        def perturb(i, t, pick=pick, np_pick=np_pick, change=change):
            if done:
                return None
            if isinstance(t, np.ndarray):
                if not np.issubdtype(t.dtype, np_pick) or not t.size:
                    return None
                t = np.array(t)
                flat = t.reshape(-1)
                flat[0] = change(flat[0])
            elif torch.is_tensor(t) and pick(t) and t.numel():
                t = _with_first(t, change)
            else:
                return None
            done.append(i)
            _record("wrong", op, leaf=i)
            return t

        out = _map_leaves(value, perturb)
        if done:
            return out
    return value


def maybe_drift(op: str, value):
    """Scale every float tensor or numpy array of ``value`` (the serve
    batcher's results are numpy, copied off the device) by ``1 + scale``
    if a
    ``drift:<op>`` clause covers this call — the *small* silent error a
    one-shot conformance probe misses but continuous shadow sampling
    catches.  Unlike ``wrong:`` (one element, large), drift perturbs whole
    tensors by a relative amount well below the blow-up threshold, and
    the clause is persistent (every call from ``nth`` onward), so a drift
    error budget burns deterministically.  First incarnation only, so a
    restarted gang serves clean.  Returns ``value`` unchanged when no
    clause fires; never writes the caller's tensors."""
    import numpy as np
    import torch

    plan = active()
    if plan is None:
        return value
    fired = [c for c in plan._matching("drift", op) if c.fires()]
    if not fired or incarnation() != 0:
        return value
    scale = fired[0].ms
    touched = []

    def drift(i, t):
        if isinstance(t, np.ndarray):
            if not np.issubdtype(t.dtype, np.floating) or not t.size:
                return None
            touched.append(i)
            return (np.array(t) * (1.0 + scale)).astype(t.dtype)
        if (not torch.is_tensor(t) or not t.is_floating_point()
                or not t.numel()):
            return None
        touched.append(i)
        return (t * (1.0 + scale)).to(t.dtype)

    out = _map_leaves(value, drift)
    if touched:
        _record("drift", op, leaves=len(touched), scale=scale)
    return out


def maybe_oom(op: str) -> None:
    """Raise a synthetic RESOURCE_EXHAUSTED if an ``oom:<op>`` clause
    fires on this call — the injected device out-of-memory an admission
    layer's chunk-shrink response is tested against.  First incarnation
    only, so a restarted solve retries clean."""
    plan = active()
    if plan is None:
        return
    for c in plan._matching("oom", op):
        if c.fires() and incarnation() == 0:
            _record("oom", op, call=c.calls)
            raise InjectedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected out-of-memory in {op} "
                f"(call {c.calls})")


def maybe_unreachable(op: str = "device") -> bool:
    """True if an ``unreachable:<nth>`` clause fires on this call — the
    deterministic stand-in for a dead/hung device.  ``op`` names the
    probe point for the ``fault-injected`` record (the clause itself is
    op-agnostic: device death is not scoped to one kernel).  First
    incarnation only, so a launcher restart finds the device back."""
    plan = active()
    if plan is None:
        return False
    fired = False
    for c in plan.clauses:
        if c.kind != "unreachable":
            continue
        if c.fires() and incarnation() == 0:
            _record("unreachable", op, call=c.calls)
            fired = True
    return fired


def maybe_fail_stage(op: str, stage: str) -> None:
    """Raise InjectedFault pre-tagged with ``stage`` if a
    ``stage:<op>:<stage>`` clause fires on this call.  The tag (the
    ``_cme213_stage`` attribute ``core/diag.py`` reads) survives the
    exception's trip up the dispatch ladder, so forensics attribution can
    be tested for every stage without a real build or launch failure.
    First incarnation only."""
    plan = active()
    if plan is None:
        return
    for c in plan.clauses:
        if c.kind != "stage" or c.op != op or c.stage != stage:
            continue
        if c.fires() and incarnation() == 0:
            _record("stage", op, stage=stage, call=c.calls)
            e = InjectedFault(
                f"injected {stage}-stage failure in {op} (call {c.calls})")
            e._cme213_stage = stage  # read by diag.failure_stage
            raise e


def maybe_slow(op: str, sleep=None) -> float:
    """Inject deterministic latency if a ``slow:<op>`` clause fires on
    this call — the straggler stand-in for a contended device or a slow
    collective.  Calls ``sleep(seconds)`` (default ``time.sleep``; pass a
    virtual clock's sleep so tests never wait wall-time) and returns the
    injected milliseconds (0.0 when nothing fired).  First incarnation
    only, like ``oom:``/``wrong:``, so a restarted solve runs at speed."""
    plan = active()
    if plan is None:
        return 0.0
    total = 0.0
    for c in plan._matching("slow", op):
        if c.fires() and incarnation() == 0:
            _record("slow", op, ms=c.ms, call=c.calls)
            total += c.ms
    if total:
        if sleep is None:
            import time
            sleep = time.sleep
        sleep(total / 1e3)
    return total


def maybe_truncate_file(path: str) -> bool:
    """Cut ``path`` in half if a ``ckpt:truncate`` clause fires (the torn
    checkpoint write).  Returns True when the file was damaged."""
    plan = active()
    if plan is None:
        return False
    if not any(c.fires() for c in plan._matching("ckpt", "truncate")):
        return False
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    _record("ckpt-truncate", path, bytes=size // 2)
    return True


def maybe_fail_commit() -> None:
    """Raise InjectedFault before a distributed COMMIT publish if a
    ``ckpt:commit`` clause fires — the shard-files-written-but-manifest-
    unpublished crash window of ``dist/ckpt.py``.  Like ``rankkill``,
    gated to the first incarnation so a supervised gang restart recovers
    deterministically instead of re-crashing forever."""
    plan = active()
    if plan is None:
        return
    for c in plan._matching("ckpt", "commit"):
        if c.fires() and incarnation() == 0:
            _record("ckpt-commit-abort", "commit", call=c.calls)
            raise InjectedFault(
                f"injected crash before COMMIT publish (call {c.calls})")


def incarnation() -> int:
    """This process's launcher restart count (0 = first launch)."""
    return int(os.environ.get("CME213_INCARNATION", "0") or "0")


def maybe_kill_rank(step: int | None = None) -> None:
    """Hard-exit (``os._exit(KILL_EXIT)``) if a ``rankkill`` clause matches
    this rank at this guarded step, first incarnation only.

    ``step=None`` uses the clause's own call counter as the step index, so
    a solver can simply call this once per chunk.
    """
    plan = active()
    if plan is None:
        return
    rank = os.environ.get("RANK", "0")
    for c in plan.clauses:
        if c.kind != "rankkill" or c.op != rank:
            continue
        at = step if step is not None else c.calls
        c.calls += 1
        if at == c.nth and incarnation() == 0:
            _record("rankkill", rank, step=at)
            sys.stderr.write(
                f"[faults] injected kill: rank {rank} at step {at}\n")
            sys.stderr.flush()
            # os._exit skips atexit and sys.excepthook: the flight
            # recorder dumps here or the event ring dies with the process
            from . import flight
            flight.dump("rankkill")
            os._exit(KILL_EXIT)


def maybe_kill_replica() -> None:
    """SIGKILL this serving replica if a ``replica-kill`` clause matches
    this rank on this guarded batch, first incarnation only.

    The replica worker (``serve/fleet.py``) calls this once per batch,
    after requests have been accepted into its queue but before they
    execute — the exact window where the fleet's in-flight requeue path
    must prove zero accepted-request loss.  SIGKILL (unlike ``os._exit``)
    is how an OOM-killed or preempted replica actually dies, so the
    flight recorder dumps *before* the signal is raised.
    """
    plan = active()
    if plan is None:
        return
    rank = os.environ.get("RANK", "0")
    for c in plan.clauses:
        if c.kind != "replica-kill" or c.op != rank:
            continue
        if c.fires() and incarnation() == 0:
            _record("replica-kill", rank, call=c.calls)
            sys.stderr.write(
                f"[faults] injected replica kill: rank {rank} at batch "
                f"{c.calls}\n")
            sys.stderr.flush()
            # SIGKILL skips atexit and signal handlers: the flight
            # recorder dumps before the signal is raised
            import signal

            from . import flight
            flight.dump("replica-kill")
            os.kill(os.getpid(), signal.SIGKILL)
