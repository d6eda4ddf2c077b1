"""Game-day chaos campaigns: seeded fault cocktails, global invariants,
failure shrinking.

Counterpart of ``cme213_tpu/core/chaos.py``: the same matrix, drawer,
invariants, shrinker and fixture format, so both packages draw the same
cocktails for the same seeds and replay the same banked fixtures.  A
campaign runs on a ``device`` (``cuda`` unless the caller asks for the
CPU; ``FrameworkError`` with neither), resolved once: its server or fleet
serves there, and the conformance check re-solves there too, since a
re-solve on another device is not the same function (the blocked scan's
cumsum associates by shape and device).  Fleet replicas match
``replica-kill`` clauses against ``RANK``.

The reference's verification habit is *offline*: hw2 diffs a grid dump
against a host golden after the run, hw_final prints a relative error at
exit.  The framework built the modern in-path equivalents one at a time —
deterministic fault clauses (``core/faults.py``), breakers, a zero-loss
requeue ledger, drift budgets, flight recorders — but each was only ever
exercised by the single-clause scenario it shipped with.  This module is
the missing composition layer (ROADMAP item 5's payoff): draw
randomized-but-**seeded** cocktails of 2-5 fault clauses, arm them
against a live serving run, and check **global invariants** that no
single-feature test can state.

The pieces
==========

- :data:`MATRIX` — the clause-compatibility matrix.  Every kind in the
  ``CME213_FAULTS`` grammar has an entry saying whether it is drawable
  against a serving target, on which backends, against which targets,
  and what it conflicts with; ineligible kinds carry the *reason* (e.g.
  ``nan:`` guards live in the checkpointed-solver loop, not the serving
  path), so exclusions are documented data, not folklore.
- :func:`draw_cocktail` — the seeded composer: 2-5 clauses drawn from
  the eligible pool, matrix-filtered, identical for identical seeds.
- :func:`run_campaign` — arm a cocktail, drive a serving run under a
  multi-op loadgen mix, disarm, then check the five global invariants:

  1. **zero accepted-request loss** — every submitted request produced
     exactly one response and ``submitted - shed == served`` (no FAILED,
     no vanished requests), whatever was killed mid-batch;
  2. **bitwise conformance** — every served result equals a disarmed
     reference re-solve on the rung that served it (modulo the armed
     plan's *declared* ``drift:`` scaling, which is compensated exactly
     — so the check verifies the corruption is precisely the injected
     one and nothing more); sort results are additionally held to the
     host ``np.sort`` golden;
  3. **SLO report** — present, JSON-parseable, and complete;
  4. **one trace id** — every event from every process of the gang
     carries the same trace id;
  5. **no leaks** — no shared-memory segments left in ``/dev/shm`` and
     no replica processes left running after close.

  Two backends: ``inproc`` (a :class:`~..serve.server.Server` driven by
  the in-process closed loop — fast enough for tier-1 fixture replay)
  and ``fleet`` (a live 2+-replica :class:`~..serve.fleet.Fleet` behind
  the socket front end — the real gang, used by the CI chaos gate).
- :func:`shrink` — on any violation, a delta-debugging shrinker: ddmin
  over clauses, then over each surviving clause's ``nth``/``count``/
  ``ms`` parameters, down to a minimal still-failing cocktail.
- :func:`bank_fixture` / :func:`replay_fixture` — minimal cocktails are
  banked as JSON under ``tests/chaos_fixtures/`` and replayed as
  ordinary tier-1 tests: every game-day find becomes a permanent
  regression test.

Handicaps (``handicaps=("drift-compensation",)``) deliberately switch
off one resilience behaviour for a drill, so game days can prove the
whole loop — violation, shrink, fixture, replay — against a known
breakage without shipping one.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace

import numpy as np

from . import faults
from .faults import FaultPlan, _Clause

#: invariant names, in report order
INVARIANTS = ("loss", "conformance", "slo_report", "trace", "leaks", "job")

#: recognized game-day handicaps (deliberate breakages for drills)
HANDICAPS = ("drift-compensation", "ckpt-retry")


# --------------------------------------------------------------- topology

#: per-op serving topology the drawer needs: rung ladder (first serves,
#: last is the reference), whether outputs carry float leaves (``drift:``
#: and ``wrong:`` only bite float leaves — integer probes take the
#: bit-flip path), and the conformance-probe ops ``wrong:`` can target.
#: ``tests/test_torch_chaos.py`` asserts this table against the port's
#: ADAPTERS.
TOPOLOGY: dict[str, dict] = {
    "spmv_scan": {"rungs": ("blocked", "flat"), "float": True,
                  "probe_ops": ()},
    "heat": {"rungs": ("xla",), "float": True, "probe_ops": ()},
    "cipher": {"rungs": ("packed", "bytes"), "float": False,
               "probe_ops": ()},
    "sort": {"rungs": ("lax", "radix", "bitonic"), "float": False,
             "probe_ops": ("serve.sort",)},
    "stub": {"rungs": ("echo",), "float": False, "probe_ops": ()},
    # job-lane entries (``"job": True``) are NOT serving adapters: they
    # name registered long-job kinds (serve/workloads.JOB_KINDS) a
    # campaign can run in the idle gaps via ``run_campaign(job=...)``.
    # Their presence in a campaign's op set is what makes ``ckpt:``
    # clauses drawable — the job lane's durable writers are the only
    # checkpoint path a serving campaign exercises.
    "pagerank": {"rungs": ("power",), "float": True, "probe_ops": (),
                 "job": True},
}

#: the job-lane campaign shape: small enough that a banked fixture
#: replays inside tier-1, large enough for several durable epochs
JOB_PARAMS: dict[str, dict] = {
    "pagerank": {"nodes": 128, "avg_edges": 4, "iters": 12, "epoch": 4,
                 "seed": 3},
}

#: loadgen ``--mix`` names -> adapter op names
MIX_TO_OP = {"spmv": "spmv_scan", "heat": "heat", "cipher": "cipher",
             "sort": "sort", "stub": "stub"}


# ------------------------------------------------------ compatibility matrix

@dataclass(frozen=True)
class KindRule:
    """One row of the compatibility matrix: whether (and how) a fault
    kind is drawable against a live serving target."""

    kind: str
    eligible: bool
    backends: tuple[str, ...] = ()      # "inproc" and/or "fleet"
    max_per_cocktail: int = 2
    conflicts: tuple[str, ...] = ()     # kinds this kind never co-draws with
    reason: str = ""                    # why eligible targets are what they
                                        # are, or why the kind is excluded


#: the clause-compatibility matrix over the full ``core/faults.py``
#: grammar.  Ineligible kinds are *documented* exclusions: their guards
#: have no call site on the serving path, or firing them there would be
#: nondeterministic, so drawing them would only produce inert or flaky
#: cocktails.
MATRIX: dict[str, KindRule] = {r.kind: r for r in (
    KindRule("fail", True, ("inproc", "fleet"), max_per_cocktail=2,
             reason="targets a non-terminal serve.<op>.<rung>; the "
                    "terminal rung is never targeted so the ladder "
                    "always has a clean rung to serve from"),
    KindRule("stage", True, ("inproc", "fleet"), max_per_cocktail=1,
             reason="execute-stage only: lower/compile guards fire on "
                    "program-cache misses, which warmup coverage makes "
                    "run-order-dependent"),
    KindRule("slow", True, ("inproc", "fleet"), max_per_cocktail=2,
             reason="targets serve.<op>; bounded ms*count so a cocktail "
                    "cannot starve the run past transport timeouts"),
    KindRule("drift", True, ("inproc", "fleet"), max_per_cocktail=1,
             conflicts=("replica-kill",),
             reason="float-output ops only (uint leaves don't drift); "
                    "nth=1 so the conformance check can compensate the "
                    "declared scale exactly; conflicts with replica-kill "
                    "because a relaunch clears drift mid-run, making "
                    "per-result expectations incarnation-dependent"),
    KindRule("wrong", True, ("inproc", "fleet"), max_per_cocktail=1,
             reason="targets a conformance-probe op (the sort golden "
                    "gate): the poisoned probe costs its rung and the "
                    "ladder serves clean from the next one.  Never "
                    "co-drawn with fail/stage on the same op's ladder: "
                    "the probe consumes whichever rung's gate misses "
                    "the verdict cache first, so rung-failure clauses "
                    "alongside it can exhaust the whole ladder (found "
                    "by campaign seed 2/0; banked as "
                    "chaos-s2000-c0.json)"),
    KindRule("replica-kill", True, ("fleet",), max_per_cocktail=1,
             conflicts=("drift",),
             reason="fleet backend only (in-process it would SIGKILL "
                    "the campaign runner itself); one per cocktail so "
                    "a 2-replica fleet never loses both replicas at "
                    "once"),
    KindRule("nan", False,
             reason="maybe_poison guards the checkpointed-solver chunk "
                    "loop (core/checkpoint.py), which the serving path "
                    "never enters — a nan: clause is inert here"),
    KindRule("oom", False,
             reason="maybe_oom guards solver chunk loops and the Pallas "
                    "pipeline, not the batched serve path — inert"),
    KindRule("rankkill", False,
             reason="maybe_kill_rank guards gang-solver epoch steps "
                    "(dist/launch.py); serving replicas are killed via "
                    "replica-kill instead"),
    KindRule("ckpt", True, ("inproc",), max_per_cocktail=2,
             reason="drawable only when the campaign runs a long job "
                    "(run_campaign(job=...)): the job lane's durable "
                    "writers (epoch checkpoints, record publishes) are "
                    "the serving tier's only checkpoint path.  inproc "
                    "only — the guards fire in the campaign runner's "
                    "own executor, so the invariant checker sees the "
                    "same store the clause corrupted"),
    KindRule("unreachable", False,
             reason="the op-agnostic device preflight is consulted at "
                    "replica startup and by the doctor; an unreachable "
                    "window there kills warmup nondeterministically "
                    "instead of exercising serving"),
)}


def clause_targets(backend: str, ops: list[str],
                   replicas: int) -> dict[str, list[dict]]:
    """Concrete drawable (kind, parameter-space) targets for a campaign
    over ``ops`` (adapter names).  Pure function of its inputs — the
    same campaign shape always offers the same pool."""
    pool: dict[str, list[dict]] = {}
    job_ops = [op for op in ops if TOPOLOGY[op].get("job")]
    for op in ops:
        topo = TOPOLOGY[op]
        if topo.get("job"):
            continue                    # not a serving adapter
        rungs = topo["rungs"]
        for rung in rungs[:-1]:         # never the terminal rung
            pool.setdefault("fail", []).append(
                {"op": f"serve.{op}.{rung}"})
            pool.setdefault("stage", []).append(
                {"op": f"serve.{op}.{rung}", "stage": "execute"})
        if len(rungs) > 1 or op in ("heat",):
            pool.setdefault("slow", []).append({"op": f"serve.{op}"})
        if topo["float"]:
            for rung in rungs:
                pool.setdefault("drift", []).append(
                    {"op": f"serve.{op}.{rung}"})
        for probe in topo["probe_ops"]:
            pool.setdefault("wrong", []).append({"op": probe})
    if backend == "fleet":
        for rank in range(replicas):
            pool.setdefault("replica-kill", []).append({"op": str(rank)})
    if job_ops:
        # both durable-writer crash windows: a torn epoch checkpoint
        # (quarantine + .prev fallback) and a lost record publish
        # (write-ahead intent replay)
        pool.setdefault("ckpt", []).append({"op": "truncate"})
        pool.setdefault("ckpt", []).append({"op": "commit"})
    return {k: v for k, v in pool.items()
            if MATRIX[k].eligible and backend in MATRIX[k].backends}


def compatible(existing: list[_Clause], cand: _Clause) -> tuple[bool, str]:
    """Whether ``cand`` may join ``existing`` under the matrix: per-kind
    caps, declared kind conflicts, no duplicate targets."""
    rule = MATRIX[cand.kind]
    same_kind = [c for c in existing if c.kind == cand.kind]
    if len(same_kind) >= rule.max_per_cocktail:
        return False, f"{cand.kind}: at most {rule.max_per_cocktail}"
    for c in existing:
        if c.kind in rule.conflicts or cand.kind in MATRIX[c.kind].conflicts:
            return False, f"{cand.kind} conflicts with {c.kind}"
        if (c.kind, c.op, c.stage) == (cand.kind, cand.op, cand.stage):
            return False, f"duplicate target {cand.kind}:{cand.op}"
        # a poisoned probe (wrong:serve.<op>) consumes one rung of
        # <op>'s ladder — whichever gate misses the verdict cache first
        # — so rung-failure clauses on the same ladder can exhaust it
        # (the chaos-s2000-c0 find: 2 requests FAILED)
        for w, other in ((cand, c), (c, cand)):
            if w.kind == "wrong" and other.kind in ("fail", "stage") \
                    and other.op.startswith(w.op + "."):
                return False, (f"wrong:{w.op} + {other.kind}:{other.op} "
                               f"can exhaust the {w.op} ladder")
    return True, ""


def validate_cocktail(plan: FaultPlan, backend: str) -> list[str]:
    """Matrix violations in ``plan`` (empty = sane for ``backend``).
    Used on drawn cocktails (must be []) and on replayed fixtures
    (deliberately-broken fixtures may carry violations by design)."""
    problems = []
    for i, c in enumerate(plan.clauses):
        rule = MATRIX.get(c.kind)
        if rule is None:
            problems.append(f"unknown kind {c.kind!r}")
            continue
        if not rule.eligible:
            problems.append(f"{c.kind}: ineligible ({rule.reason})")
        elif backend not in rule.backends:
            problems.append(f"{c.kind}: not sane on backend {backend!r}")
        ok, why = compatible(plan.clauses[:i], c)
        if not ok:
            problems.append(why)
    return problems


# ------------------------------------------------------------ the drawer

def draw_cocktail(rng: np.random.Generator, backend: str,
                  ops: list[str], replicas: int = 2) -> FaultPlan:
    """Draw one randomized-but-seeded cocktail of 2-5 clauses from the
    matrix-filtered pool.  Identical ``rng`` state -> identical cocktail."""
    pool = clause_targets(backend, ops, replicas)
    kinds = sorted(pool)
    if not kinds:
        raise ValueError(f"no drawable fault kinds for ops {ops}")
    want = int(rng.integers(2, 6))
    clauses: list[_Clause] = []
    for _ in range(want * 8):           # bounded rejection sampling
        if len(clauses) >= want:
            break
        kind = kinds[int(rng.integers(0, len(kinds)))]
        tgt = pool[kind][int(rng.integers(0, len(pool[kind])))]
        if kind == "fail":
            cand = _Clause("fail", tgt["op"],
                           nth=int(rng.integers(1, 3)),
                           count=int(rng.integers(1, 4)))
        elif kind == "stage":
            cand = _Clause("stage", tgt["op"], stage=tgt["stage"],
                           nth=int(rng.integers(1, 3)),
                           count=int(rng.integers(1, 3)))
        elif kind == "slow":
            cand = _Clause("slow", tgt["op"],
                           ms=float(rng.choice((20.0, 50.0))),
                           nth=int(rng.integers(1, 3)),
                           count=int(rng.integers(1, 4)))
        elif kind == "drift":
            cand = _Clause("drift", tgt["op"],
                           ms=float(rng.choice((1e-3, 2e-3))),
                           nth=1, count=1 << 30)
        elif kind == "wrong":
            cand = _Clause("wrong", tgt["op"], nth=1)
        elif kind == "ckpt":
            cand = _Clause("ckpt", tgt["op"],
                           nth=int(rng.integers(1, 3)))
        else:                           # replica-kill
            cand = _Clause("replica-kill", tgt["op"],
                           nth=int(rng.integers(1, 3)))
        if compatible(clauses, cand)[0]:
            clauses.append(cand)
    if len(clauses) < 2:
        raise RuntimeError("could not draw a 2-clause cocktail "
                           f"(pool {sorted(pool)})")
    return FaultPlan(clauses)


# ----------------------------------------------------------- invariants

@dataclass
class Violation:
    invariant: str                      # one of INVARIANTS
    detail: str

    def as_dict(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail}


@dataclass
class CampaignResult:
    """What one campaign run produced; serializable via :meth:`as_dict`."""

    seed: int
    index: int
    backend: str
    mix: str
    requests: int
    replicas: int
    cocktail: str
    job: str | None = None
    report: dict = field(default_factory=dict)
    violations: list = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    def as_dict(self) -> dict:
        return {
            "seed": self.seed, "campaign": self.index,
            "backend": self.backend, "mix": self.mix,
            "requests": self.requests, "replicas": self.replicas,
            "cocktail": self.cocktail, "job": self.job, "ok": self.ok,
            "violations": [v.as_dict() for v in self.violations],
            "elapsed_s": round(self.elapsed_s, 3),
            "report": self.report,
        }


def _drift_scales(plan: FaultPlan) -> dict[str, float]:
    """op-path -> declared scale, for drift clauses the conformance
    check compensates (nth=1 persistent clauses only — the matrix's
    drawable shape)."""
    return {c.op: c.ms for c in plan.clauses
            if c.kind == "drift" and c.nth == 1}


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _reference_resolve(spec, rung: str, device=None):
    """Disarmed serial re-solve of ``spec`` on the rung that served it,
    on the device that served it."""
    from ..serve.workloads import ADAPTERS

    return np.asarray(ADAPTERS[spec.op].run_batch([spec.payload], rung,
                                                  device=device)[0])


def check_conformance(pairs, plan: FaultPlan,
                      handicaps: tuple[str, ...] = (),
                      device=None) -> list[Violation]:
    """Invariant 2: every OK result equals a disarmed reference re-solve
    on its recorded rung and the campaign's ``device``, bitwise —
    compensating the armed plan's declared ``drift:`` scale (unless the
    drill handicapped that), and additionally holding sort results to the
    host ``np.sort`` golden."""
    scales = {} if "drift-compensation" in handicaps else _drift_scales(plan)
    out = []
    for spec, res in pairs:
        if res.status != "ok" or res.value is None:
            continue
        ref = _reference_resolve(spec, res.rung, device)
        scale = scales.get(f"serve.{spec.op}.{res.rung}")
        if scale is not None and np.issubdtype(ref.dtype, np.floating):
            # exactly what maybe_drift did to the served batch: host
            # multiply + cast, so bitwise equality still holds
            ref = (ref * (1.0 + scale)).astype(ref.dtype)
        got = np.asarray(res.value)
        if got.shape != ref.shape or got.dtype != ref.dtype or \
                _bits(got) != _bits(ref):
            bad = int(np.count_nonzero(got != ref)) if \
                got.shape == ref.shape else -1
            out.append(Violation(
                "conformance",
                f"rid {res.rid} op {spec.op} rung {res.rung}: served "
                f"result != reference re-solve ({bad} differing elems)"))
            continue
        if spec.op == "sort":
            golden = np.sort(np.asarray(spec.payload))
            if _bits(got) != _bits(golden):
                out.append(Violation(
                    "conformance",
                    f"rid {res.rid} sort: served result != np.sort "
                    f"golden"))
    return out


def check_loss(pairs, submitted: int) -> list[Violation]:
    """Invariant 1: one response per request; submitted - shed == served."""
    out = []
    if len(pairs) != submitted:
        out.append(Violation(
            "loss", f"{submitted} submitted but {len(pairs)} responses"))
    served = sum(1 for _, r in pairs if r.status == "ok")
    shed = sum(1 for _, r in pairs if r.status == "shed")
    failed = [r for _, r in pairs if r.status not in ("ok", "shed")]
    if failed:
        out.append(Violation(
            "loss", f"{len(failed)} accepted request(s) failed "
                    f"(first: {failed[0].reason})"))
    if served != len(pairs) - shed - len(failed):
        out.append(Violation(
            "loss", f"served {served} != submitted {len(pairs)} - shed "
                    f"{shed}"))
    return out


def check_slo_report(report: dict) -> list[Violation]:
    """Invariant 3: the SLO report exists, round-trips through JSON, and
    carries the keys every consumer (trace regress, CI gates) reads."""
    try:
        doc = json.loads(json.dumps(report))
    except (TypeError, ValueError) as e:
        return [Violation("slo_report", f"not JSON-serializable: {e}")]
    missing = [k for k in ("trace_id", "requests", "served", "shed",
                           "failed", "latency_ms", "throughput_rps")
               if k not in doc]
    if missing:
        return [Violation("slo_report", f"missing keys {missing}")]
    return []


def check_trace(trace_ids: set, expected: str) -> list[Violation]:
    """Invariant 4: exactly one trace id spans the whole gang."""
    ids = {t for t in trace_ids if t}
    if ids == {expected}:
        return []
    return [Violation(
        "trace", f"expected one gang trace id {expected!r}, saw "
                 f"{sorted(ids)!r}")]


def _job_reference(op: str, params: dict, device=None):
    """Disarmed re-run of the campaign's long job in a fresh store, on
    ``device`` — the value the armed run's durable result must equal
    bitwise."""
    import tempfile

    from ..serve import jobs as jobs_mod

    prev = faults.active()
    faults.install_plan(FaultPlan([]))
    try:
        store = jobs_mod.JobStore(tempfile.mkdtemp(prefix="chaos-jobref-"))
        jobs_mod.submit_job(store, "ref", op, params)
        ex = jobs_mod.JobExecutor(store, rank="ref", device=device)
        for _ in range(500):
            if not ex.tick():
                break
        return store.load_result("ref")
    finally:
        if prev is None:
            faults.reset()
        else:
            faults.install_plan(prev)


def check_job(job_ctx, device=None) -> list[Violation]:
    """Invariant 6 (job campaigns): the long job survived the cocktail —
    terminal state is DONE, no committed epoch was ever re-executed
    (``job-epoch`` publishes carry unique epoch numbers), and the durable
    result equals a disarmed re-run bitwise."""
    from ..serve import jobs as jobs_mod
    from . import trace

    store, jid, op, params = job_ctx
    rec = store.load(jid)
    if rec is None:
        return [Violation("job", f"job {jid}: record unreadable")]
    if rec["state"] != jobs_mod.DONE:
        return [Violation(
            "job", f"job {jid} ended {rec['state']} "
                   f"(reason {rec.get('reason')!r}) under the cocktail")]
    out = []
    epochs = [e["epoch"] for e in trace.events("job-epoch")
              if e.get("job") == jid]
    dupes = sorted({n for n in epochs if epochs.count(n) > 1})
    if dupes:
        out.append(Violation(
            "job", f"job {jid}: committed epoch(s) {dupes} re-executed"))
    got = store.load_result(jid)
    ref = _job_reference(op, params, device)
    if got is None or ref is None or _bits(got) != _bits(ref):
        out.append(Violation(
            "job", f"job {jid}: durable result != disarmed re-run "
                   f"(bitwise)"))
    return out


def _shm_segments() -> set:
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    except OSError:
        return set()


def check_leaks(shm_before: set, live_procs: list) -> list[Violation]:
    """Invariant 5: nothing outlives the campaign — no new shared-memory
    segments, no replica processes still running."""
    out = []
    leaked = _shm_segments() - shm_before
    if leaked:
        out.append(Violation(
            "leaks", f"leaked shm segment(s): {sorted(leaked)}"))
    if live_procs:
        out.append(Violation(
            "leaks", f"replica process(es) still alive: {live_procs}"))
    return out


# ------------------------------------------------------- campaign runners

def _campaign_hygiene() -> None:
    """Reset cross-campaign state so campaign N+1 starts clean: cached
    conformance verdicts (a ``wrong:``-poisoned probe must not leak),
    drift-budget/demotion state, buffered trace events."""
    from . import conformance, numerics, trace

    conformance.reset()
    numerics.reset()
    trace.clear_events()


def _run_inproc(plan: FaultPlan, mix: str, requests: int, seed: int,
                max_batch: int, concurrency: int = 6,
                job: str | None = None,
                handicaps: tuple[str, ...] = (), device=None):
    """Drive an in-process Server under the armed cocktail; returns
    (pairs, report, trace_ids, shm_before, live_procs, job_ctx).  With
    ``job``, a long job runs in the serving gaps exactly as a replica
    would run it — submitted before the load, ticked between service
    steps (so queue-depth preemption has something to preempt), then
    driven to a terminal state after the interactive load drains."""
    import tempfile

    from ..serve import jobs as jobs_mod
    from ..serve.loadgen import build_mix, slo_report
    from ..serve.server import Server
    from . import metrics, trace

    shm_before = _shm_segments()
    specs = build_mix(mix, requests, seed=seed)
    server = Server(capacity=max(64, requests), max_batch=max_batch,
                    device=device)
    before = metrics.snapshot()
    prev = faults.active()
    faults.install_plan(plan.reset_counters())
    t0 = time.monotonic()
    pairs = []
    job_ctx = None
    executor = None
    try:
        if job:
            params = dict(JOB_PARAMS[job])
            jstore = jobs_mod.JobStore(
                tempfile.mkdtemp(prefix="chaos-job-"))
            jid = f"chaos-{seed}"
            jobs_mod.submit_job(jstore, jid, job, params)
            executor = jobs_mod.JobExecutor(
                jstore, server=server, rank="chaos",
                commit_retries=0 if "ckpt-retry" in handicaps else 3)
            job_ctx = (jstore, jid, job, params)
        pending = list(specs)
        inflight: dict[int, object] = {}
        while pending or inflight:
            while pending and len(inflight) < concurrency:
                spec = pending.pop(0)
                out = server.submit(spec.op, spec.payload,
                                    deadline_ms=spec.deadline_ms,
                                    tenant=spec.tenant)
                if isinstance(out, int):
                    inflight[out] = spec
                else:
                    pairs.append((spec, out))    # shed at submit
            for res in server.step():
                pairs.append((inflight.pop(res.rid), res))
            if executor is not None:
                executor.tick()
        if executor is not None:
            # interactive load drained: the job owns the idle gaps now
            for _ in range(500):
                rec = job_ctx[0].load(job_ctx[1])
                if rec is None or rec["state"] in jobs_mod.TERMINAL:
                    break
                executor.tick()
    finally:
        if prev is None:
            faults.reset()
        else:
            faults.install_plan(prev)
    elapsed = time.monotonic() - t0
    run = {"results": [r for _, r in pairs], "elapsed_s": elapsed}
    report = slo_report(run, before, metrics.snapshot())
    trace_ids = {e.get("trace") for e in trace.events()}
    return pairs, report, trace_ids, shm_before, [], job_ctx


def _run_fleet(plan: FaultPlan, mix: str, requests: int, seed: int,
               max_batch: int, replicas: int, concurrency: int = 4,
               warm_requests: int = 4, device=None):
    """Drive a live replica fleet under the armed cocktail (the same
    fleet ``fleet up`` runs; workers inherit the cocktail via the
    ``CME213_FAULTS`` env).  Returns the same tuple as
    :func:`_run_inproc`."""
    import tempfile
    import threading

    from ..serve.fleet import Fleet
    from ..serve.loadgen import build_mix, fleet_section, slo_report
    from ..serve.transport import TransportClient
    from . import metrics, trace

    shm_before = _shm_segments()
    specs = build_mix(mix, requests, seed=seed)
    before = metrics.snapshot()
    prev_env = os.environ.get("CME213_FAULTS")
    prev_trace = os.environ.get("CME213_TRACE_FILE")
    tmp = tempfile.mkdtemp(prefix="chaos-")
    os.environ["CME213_FAULTS"] = str(plan)
    os.environ["CME213_TRACE_FILE"] = os.path.join(
        tmp, "trace-r{rank}.jsonl")
    # the runner's own process must NOT arm the cocktail: replica-kill
    # clauses match RANK, and the front end runs here
    faults.install_plan(FaultPlan([]))
    t0 = time.monotonic()
    fleet = None
    pairs = []
    mu = threading.Lock()
    try:
        fleet = Fleet(replicas=replicas, mix=mix, max_batch=max_batch,
                      warm_requests=warm_requests, device=device).start()
        addr = fleet.addr
        work = list(specs)

        def worker() -> None:
            client = None
            while True:
                with mu:
                    if not work:
                        break
                    spec = work.pop(0)
                try:
                    if client is None:
                        client = TransportClient(addr, timeout_s=120.0)
                    res = client.solve(spec.op, spec.payload,
                                       deadline_ms=spec.deadline_ms,
                                       tenant=spec.tenant)
                except (OSError, ConnectionError, ValueError,
                        TimeoutError) as e:
                    from ..serve.request import FAILED, SolveResult
                    if client is not None:
                        client.close()
                        client = None
                    res = SolveResult(-1, spec.op, FAILED,
                                      reason=f"transport: {e}",
                                      tenant=spec.tenant)
                with mu:
                    pairs.append((spec, res))
            if client is not None:
                client.close()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, min(concurrency, len(specs))))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.monotonic() - t0
        run = {"results": [r for _, r in pairs], "elapsed_s": elapsed}
        report = slo_report(run, before, metrics.snapshot())
        report["fleet"] = fleet_section(run, addr)
    finally:
        live = []
        if fleet is not None:
            procs = list(fleet._procs.values())
            fleet.close()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and any(
                    p.proc.poll() is None for p in procs):
                time.sleep(0.1)
            live = [f"r{p.rank}(pid {p.proc.pid})" for p in procs
                    if p.proc.poll() is None]
        if prev_env is None:
            os.environ.pop("CME213_FAULTS", None)
        else:
            os.environ["CME213_FAULTS"] = prev_env
        if prev_trace is None:
            os.environ.pop("CME213_TRACE_FILE", None)
        else:
            os.environ["CME213_TRACE_FILE"] = prev_trace
        faults.reset()
    trace_ids = {trace.trace_id()}
    for name in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, name), encoding="utf-8") as f:
            for line in f:
                try:
                    trace_ids.add(json.loads(line).get("trace"))
                except ValueError:
                    trace_ids.add(f"<unparseable line in {name}>")
    return pairs, report, trace_ids, shm_before, live


def run_campaign(cocktail: FaultPlan | str, backend: str = "inproc",
                 mix: str = "cipher,sort", requests: int = 12,
                 seed: int = 0, index: int = 0, replicas: int = 2,
                 max_batch: int = 4,
                 handicaps: tuple[str, ...] = (),
                 job: str | None = None, device=None) -> CampaignResult:
    """Arm ``cocktail``, drive one serving run on ``device`` (default
    ``cuda``), disarm, check the global invariants.  Deterministic for a
    deterministic cocktail.  ``job`` names a registered long-job kind to
    run in the serving gaps; job campaigns add invariant 6 (the job
    reaches DONE with no committed epoch re-executed and a
    bitwise-reference result)."""
    from ..serve.workloads import JOB_KINDS, serving_device
    from . import trace

    plan = (FaultPlan.parse(cocktail) if isinstance(cocktail, str)
            else cocktail)
    for h in handicaps:
        if h not in HANDICAPS:
            raise ValueError(f"unknown handicap {h!r} (know {HANDICAPS})")
    if backend not in ("inproc", "fleet"):
        raise ValueError(f"unknown backend {backend!r} (inproc | fleet)")
    if job is not None:
        if job not in JOB_KINDS or job not in JOB_PARAMS:
            raise ValueError(f"unknown job kind {job!r}")
        if backend != "inproc":
            raise ValueError(
                "job campaigns are inproc-only (the fleet job lane is "
                "exercised end to end by the CI job-lane gate instead)")
    for c in plan.clauses:
        if backend == "inproc" and c.kind in ("replica-kill", "rankkill"):
            raise ValueError(
                f"{c.kind} clause in an in-process campaign would kill "
                f"the runner itself; use backend='fleet'")
        if c.kind == "ckpt" and job is None:
            raise ValueError(
                "ckpt clauses need a job campaign (run_campaign(job=...)) "
                "— the job lane is the only checkpoint path here")
    dev = serving_device(device)
    _campaign_hygiene()
    record_kw = dict(seed=seed, campaign=index, cocktail=str(plan),
                     backend=backend)
    trace.record_event("chaos-campaign", **record_kw)
    t0 = time.monotonic()
    job_ctx = None
    if backend == "inproc":
        pairs, report, trace_ids, shm_before, live, job_ctx = _run_inproc(
            plan, mix, requests, seed, max_batch, job=job,
            handicaps=handicaps, device=dev)
    else:
        pairs, report, trace_ids, shm_before, live = _run_fleet(
            plan, mix, requests, seed, max_batch, replicas, device=dev)
    violations = []
    violations += check_loss(pairs, requests)
    violations += check_conformance(pairs, plan, handicaps, device=dev)
    violations += check_slo_report(report)
    violations += check_trace(trace_ids, report.get("trace_id"))
    violations += check_leaks(shm_before, live)
    if job_ctx is not None:
        violations += check_job(job_ctx, device=dev)
    for v in violations:
        trace.record_event("chaos-violation", campaign=index,
                           invariant=v.invariant, detail=v.detail)
    return CampaignResult(
        seed=seed, index=index, backend=backend, mix=mix,
        requests=requests, replicas=replicas, cocktail=str(plan),
        job=job, report=report, violations=violations,
        elapsed_s=time.monotonic() - t0)


# ------------------------------------------------------------- shrinking

def ddmin(items: list, failing) -> list:
    """Zeller's ddmin: a minimal sublist of ``items`` on which
    ``failing`` still returns True.  ``failing(items)`` must hold."""
    assert failing(items), "ddmin needs a failing starting point"
    n = 2
    while len(items) >= 2:
        chunk = max(1, len(items) // n)
        reduced = False
        for i in range(0, len(items), chunk):
            complement = items[:i] + items[i + chunk:]
            if complement and failing(complement):
                items = complement
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(items):
                break
            n = min(len(items), 2 * n)
    return items


def _param_candidates(c: _Clause) -> list[_Clause]:
    """Simpler-parameter variants of one clause, most aggressive first."""
    out = []
    if c.nth > 1:
        out.append(replace(c, nth=1, calls=0))
    if c.count > 1 and c.kind != "drift":
        out.append(replace(c, count=1, calls=0))
    if c.kind == "slow" and c.ms > 20.0:
        out.append(replace(c, ms=20.0, calls=0))
    return out


def shrink(plan: FaultPlan, failing) -> FaultPlan:
    """Delta-debug ``plan`` to a minimal failing cocktail: ddmin over
    clauses, then per-clause parameter simplification (nth -> 1,
    count -> 1, ms -> floor), re-validating failure at every step.
    ``failing(FaultPlan) -> bool`` runs a (deterministic) campaign."""
    def run(clauses: list[_Clause]) -> bool:
        return failing(FaultPlan([replace(c, calls=0) for c in clauses]))

    clauses = ddmin(list(plan.clauses), run)
    # parameter pass: try each clause's simpler variants in place,
    # re-deriving candidates after every accepted reduction so one
    # accepted simplification is never reverted by the next trial
    for i in range(len(clauses)):
        improved = True
        while improved:
            improved = False
            for cand in _param_candidates(clauses[i]):
                trial = clauses[:i] + [cand] + clauses[i + 1:]
                if run(trial):
                    clauses = trial
                    improved = True
                    break
    return FaultPlan([replace(c, calls=0) for c in clauses])


# -------------------------------------------------------------- fixtures

def fixtures_dir() -> str:
    """The banked-fixture directory (``tests/chaos_fixtures/``),
    resolved relative to the repo root this package lives in."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests", "chaos_fixtures")


def bank_fixture(result: CampaignResult, minimal: FaultPlan,
                 directory: str | None = None,
                 handicaps: tuple[str, ...] = ()) -> str:
    """Write one replayable JSON fixture for a shrunk violation; the
    name is deterministic in (seed, campaign) so re-banking a known
    failure overwrites instead of accumulating."""
    directory = directory or fixtures_dir()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory, f"chaos-s{result.seed}-c{result.index}.json")
    doc = {
        "name": os.path.basename(path),
        "seed": result.seed,
        "campaign": result.index,
        "backend": result.backend,
        "mix": result.mix,
        "requests": result.requests,
        "replicas": result.replicas,
        "max_batch": 4,
        "cocktail": result.cocktail,
        "minimal_cocktail": str(minimal),
        "handicaps": list(handicaps),
        "job": result.job,
        "expect": {"violated": sorted({v.invariant
                                       for v in result.violations})},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def replay_fixture(path: str, device=None
                   ) -> tuple[CampaignResult, list[str], list[str]]:
    """Re-run a banked fixture's minimal cocktail under its recorded
    campaign shape, on ``device`` (default ``cuda``); returns (result, expected_violated, observed_violated).
    A replay *passes* when observed == expected — passing fixtures prove
    the invariants hold, violation fixtures prove the detector and the
    shrinker still reproduce the find."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    result = run_campaign(
        doc["minimal_cocktail"], backend=doc.get("backend", "inproc"),
        mix=doc["mix"], requests=int(doc["requests"]),
        seed=int(doc["seed"]), index=int(doc["campaign"]),
        replicas=int(doc.get("replicas", 2)),
        max_batch=int(doc.get("max_batch", 4)),
        handicaps=tuple(doc.get("handicaps", ())),
        job=doc.get("job"), device=device)
    expected = sorted(doc.get("expect", {}).get("violated", []))
    observed = sorted({v.invariant for v in result.violations})
    return result, expected, observed


# ------------------------------------------------------------ orchestrator

def run_campaigns(seed: int, campaigns: int, backend: str = "inproc",
                  mix: str = "cipher,sort", requests: int = 12,
                  replicas: int = 2, max_batch: int = 4,
                  shrink_violations: bool = True,
                  bank_dir: str | None = None,
                  handicaps: tuple[str, ...] = (),
                  job: str | None = None, device=None) -> dict:
    """The game day: ``campaigns`` seeded draws, each armed against a
    live run and invariant-checked; violations are ddmin-shrunk and
    banked as fixtures.  Returns the campaign report (JSON-ready).
    ``job`` adds a long-job kind to every campaign (and its ``ckpt:``
    targets to the drawable pool).  Every campaign runs on ``device``
    (default ``cuda``)."""
    from ..serve.workloads import serving_device
    from . import trace

    device = serving_device(device)
    ops = sorted({MIX_TO_OP[m.strip()] for m in mix.split(",")
                  if m.strip()})
    if job:
        ops.append(job)
    out: dict = {"seed": seed, "backend": backend, "mix": mix,
                 "job": job, "campaigns": [], "fixtures": []}
    for i in range(campaigns):
        rng = np.random.default_rng([seed, i])
        plan = draw_cocktail(rng, backend, ops, replicas)
        problems = validate_cocktail(plan, backend)
        assert not problems, f"drawer produced a matrix violation: " \
                             f"{problems}"
        result = run_campaign(
            plan, backend=backend, mix=mix, requests=requests,
            seed=seed * 1000 + i, index=i, replicas=replicas,
            max_batch=max_batch, handicaps=handicaps, job=job,
            device=device)
        out["campaigns"].append(result.as_dict())
        if result.violations and shrink_violations:
            def failing(p: FaultPlan) -> bool:
                r = run_campaign(
                    p, backend=backend, mix=mix, requests=requests,
                    seed=seed * 1000 + i, index=i, replicas=replicas,
                    max_batch=max_batch, handicaps=handicaps, job=job,
                    device=device)
                return bool(r.violations)

            minimal = shrink(FaultPlan.parse(result.cocktail), failing)
            trace.record_event(
                "chaos-shrunk", campaign=i,
                from_clauses=len(FaultPlan.parse(result.cocktail).clauses),
                to_clauses=len(minimal.clauses), cocktail=str(minimal))
            out["fixtures"].append(bank_fixture(
                result, minimal, directory=bank_dir, handicaps=handicaps))
    out["violations_total"] = sum(
        len(c["violations"]) for c in out["campaigns"])
    out["ok"] = out["violations_total"] == 0
    return out
