"""Durable long-job lane: preemptible checkpointed batch solves that
survive replica death and whole-fleet restarts.

Counterpart of ``cme213_tpu/serve/jobs.py``.  The records are the JAX
package's JSON with the same ``_record_crc``, and the epoch checkpoints go
through the port's ``core/checkpoint`` (the same ``.npz`` layout), so a
job one package committed resumes in the other.  The executor runs its
epochs on its ``device`` (``cuda`` unless asked for the CPU), and its
rank is the ``RANK`` variable where the JAX package reads
``JAX_PROCESS_ID``.

The reference submitted its long solve — hw1's PageRank power iteration
— through Torque ``qsub`` batch scripts (``jobs/``): work queued beside
the interactive shell, surviving logout, polled with ``qstat``.  This
module is that batch queue rebuilt on the serving fleet, with the
durability story Torque delegated to the cluster:

- **JobStore** — one CRC-checked JSON record per job in a shared
  directory, written atomically (unique tmp + ``os.replace``) with the
  previous record retained at ``.prev`` and corrupt records quarantined
  to ``.corrupt`` (the same discipline as ``core/checkpoint.py``).  The
  state machine is PENDING → RUNNING ⇄ PREEMPTED → DONE/FAILED/STALLED;
  every transition is **write-ahead**: an ``intent`` field lands first,
  the work happens (the epoch's ``.npz`` checkpoint commits), then the
  record is published with the intent cleared.  A crash between the two
  writes is recovered by replaying the intent against the durable
  checkpoint — a committed epoch is *never* re-executed, because the
  next tick's ``run_with_checkpoints`` call resumes at the checkpoint's
  step and the pending intent merely re-targets the same epoch.
  Submission is **idempotent** keyed by the client's job id (exclusive
  ``os.link`` publish of the first record): a replayed submit returns
  the existing record — and, once DONE, the original result — instead
  of double-running.
- **JobExecutor** — runs registered job kinds (``serve/workloads.py``
  ``JOB_KINDS``; PageRank first) as epoch-sized chunks through
  ``core.checkpoint.run_with_checkpoints`` with the
  ``ConvergenceTracker``.  The serving thread calls :meth:`tick` only
  in idle gaps; each tick runs at most ONE epoch and re-checks the
  preemption signals (interactive queue depth, ``serve/slo.py`` burn)
  first, so interactive batches strictly win and a job is preempted at
  epoch boundaries — never mid-epoch, never losing committed work.
- **Ownership** — a ``.owner`` claim file per job, created with
  ``O_CREAT|O_EXCL`` (atomic across processes), holds the rank of the
  replica running it; a relaunched replica keeps its rank and resumes
  its own jobs, and the fleet reassigns claims off permanently-dead
  replicas (the JAX package's ``serve/fleet.py``; not in the port yet).

The epoch commit publish calls ``core.faults.maybe_fail_commit`` — the
``ckpt:commit`` crash window, now on the serving path (chaos campaigns
draw it; ``core/chaos.py``) — and the epoch checkpoints flow through
``save_checkpoint``'s ``ckpt:truncate`` torn-write hook, so both
checkpoint fault clauses exercise real recovery here.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib

import numpy as np

from ..core import metrics
from ..core.faults import InjectedFault, maybe_fail_commit
from ..core.numerics import host_array
from ..core.trace import record_event

#: shared job directory a fleet exports to its replicas
JOBS_DIR_ENV = "CME213_JOBS_DIR"

PENDING = "PENDING"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
DONE = "DONE"
FAILED = "FAILED"
STALLED = "STALLED"

TERMINAL = frozenset({DONE, FAILED, STALLED})

#: legal state transitions (RUNNING → RUNNING is the per-epoch publish)
_ALLOWED = {
    PENDING: {RUNNING, FAILED},
    RUNNING: {RUNNING, PREEMPTED, DONE, FAILED, STALLED},
    PREEMPTED: {RUNNING, FAILED},
}

#: control kinds the transport/fleet front ends route to the job lane
JOB_CONTROLS = ("job-submit", "job-status", "job-list", "job-cancel",
                "job-result")

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

#: record fields exposed over the wire (everything small and JSON-safe)
_PUBLIC = ("job", "op", "state", "epoch", "total_epochs", "iters",
           "total_iters", "epoch_iters", "residual", "reason", "resumes",
           "preemptions", "intent", "result_crc", "submitted_t",
           "updated_t")


class JobError(ValueError):
    """Bad job id / parameters / illegal state transition."""


def _check_id(job: str) -> str:
    if not isinstance(job, str) or not _ID_RE.match(job):
        raise JobError(f"bad job id {job!r} (want [A-Za-z0-9][A-Za-z0-9._-]"
                       "{0,63})")
    return job


def _record_crc(rec: dict) -> int:
    body = {k: v for k, v in rec.items() if k != "crc"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(blob.encode("utf-8")) & 0xFFFFFFFF


def public(rec: dict) -> dict:
    """Wire-safe view of one record."""
    return {k: rec.get(k) for k in _PUBLIC}


class JobStore:
    """Durable job records in one directory; every mutation is an atomic
    replace and every read is CRC-verified with ``.prev`` fallback."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    # ---------------------------------------------------------- paths

    def record_path(self, job: str) -> str:
        return os.path.join(self.directory, f"job-{_check_id(job)}.json")

    def checkpoint_path(self, job: str) -> str:
        return os.path.join(self.directory, f"job-{_check_id(job)}.npz")

    def result_path(self, job: str) -> str:
        return os.path.join(self.directory,
                            f"job-{_check_id(job)}.result.npz")

    def _owner_path(self, job: str) -> str:
        return os.path.join(self.directory, f"job-{_check_id(job)}.owner")

    def _cancel_path(self, job: str) -> str:
        return os.path.join(self.directory, f"job-{_check_id(job)}.cancel")

    # --------------------------------------------------------- records

    def submit(self, job: str, op: str, params: dict, total_iters: int,
               epoch_iters: int, total_epochs: int) -> tuple[dict, bool]:
        """Idempotent submit: publish the PENDING record exclusively
        (tmp + ``os.link``, atomic even across hosts on one filesystem);
        if the id already exists, return the existing record untouched —
        a replayed submission never double-runs."""
        path = self.record_path(job)
        rec = {
            "job": _check_id(job), "op": op, "params": dict(params),
            "state": PENDING, "epoch": 0, "total_epochs": int(total_epochs),
            "iters": 0, "total_iters": int(total_iters),
            "epoch_iters": int(epoch_iters), "intent": None,
            "residual": None, "reason": None, "result_crc": None,
            "resumes": 0, "preemptions": 0,
            "submitted_t": time.time(), "updated_t": time.time(),
        }
        rec["crc"] = _record_crc(rec)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)        # exclusive: fails if the id exists
        except FileExistsError:
            existing = self.load(job)
            if existing is not None:
                return existing, False
            return rec, False         # racing submit won; record torn —
            # the winner's retry (or ours) re-publishes
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return rec, True

    def load(self, job: str) -> dict | None:
        """The job's record, CRC-verified; a corrupt candidate is
        quarantined to ``.corrupt`` and the retained ``.prev`` serves —
        one torn record write never loses the job."""
        path = self.record_path(job)
        for candidate in (path, path + ".prev"):
            if not os.path.exists(candidate):
                continue
            try:
                with open(candidate) as f:
                    rec = json.load(f)
                if rec.get("crc") != _record_crc(rec):
                    raise JobError("record checksum mismatch")
                return rec
            except (OSError, ValueError) as e:
                quarantine = candidate + ".corrupt"
                try:
                    os.replace(candidate, quarantine)
                except OSError:
                    continue
                metrics.counter("jobs.record_quarantines").inc()
                record_event("checkpoint-quarantine", path=candidate,
                             quarantined_to=quarantine,
                             error=type(e).__name__, message=str(e)[:200])
        return None

    def _write(self, rec: dict) -> None:
        path = self.record_path(rec["job"])
        rec["updated_t"] = time.time()
        rec["crc"] = _record_crc(rec)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            os.replace(path, path + ".prev")
        os.replace(tmp, path)

    def intent(self, rec: dict, **doc) -> None:
        """Write-ahead: land what is *about to happen* before doing it.
        A crash after this write replays the intent against the durable
        epoch checkpoint instead of guessing."""
        rec["intent"] = doc
        self._write(rec)

    def publish(self, rec: dict, **updates) -> None:
        """Commit a transition: apply ``updates``, clear the intent, and
        replace the record.  ``maybe_fail_commit`` fires first — the
        ``ckpt:commit`` window is work-durable-but-record-unpublished,
        exactly what intent replay recovers."""
        new_state = updates.get("state")
        if new_state is not None and new_state != rec["state"]:
            if new_state not in _ALLOWED.get(rec["state"], ()):
                raise JobError(f"illegal transition {rec['state']} -> "
                               f"{new_state} for job {rec['job']}")
        maybe_fail_commit()
        rec.update(updates)
        rec["intent"] = None
        self._write(rec)

    def list_jobs(self) -> list[dict]:
        recs = []
        for name in sorted(os.listdir(self.directory)):
            if not (name.startswith("job-") and name.endswith(".json")):
                continue
            rec = self.load(name[len("job-"):-len(".json")])
            if rec is not None:
                recs.append(rec)
        return recs

    # ------------------------------------------------------- ownership

    def claim(self, job: str, owner: str) -> bool:
        """Atomically claim an unowned job (O_CREAT|O_EXCL — exactly one
        process wins even when several scan at once)."""
        try:
            fd = os.open(self._owner_path(job),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            f.write(str(owner))
        return True

    def owner(self, job: str) -> str | None:
        try:
            with open(self._owner_path(job)) as f:
                return f.read().strip() or None
        except OSError:
            return None

    def reassign(self, job: str, owner: str) -> None:
        """Overwrite a claim (fleet rescheduling off a dead replica —
        only safe once the previous owner cannot write)."""
        path = self._owner_path(job)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(owner))
        os.replace(tmp, path)

    def reassign_from(self, dead_owner: str, new_owner: str) -> list[str]:
        """Move every non-terminal job claimed by ``dead_owner`` to
        ``new_owner``; returns the moved job ids."""
        moved = []
        for rec in self.list_jobs():
            if rec["state"] in TERMINAL:
                continue
            if self.owner(rec["job"]) == str(dead_owner):
                self.reassign(rec["job"], new_owner)
                moved.append(rec["job"])
        return moved

    # ---------------------------------------------------------- cancel

    def request_cancel(self, job: str) -> None:
        with open(self._cancel_path(job), "w") as f:
            f.write("cancel")

    def cancel_requested(self, job: str) -> bool:
        return os.path.exists(self._cancel_path(job))

    # ---------------------------------------------------------- results

    def save_result(self, job: str, iters: int, value: np.ndarray) -> int:
        from ..core.checkpoint import save_checkpoint

        return save_checkpoint(self.result_path(job), iters,
                               value=np.asarray(value))

    def load_result(self, job: str) -> np.ndarray | None:
        from ..core.checkpoint import load_checkpoint

        loaded = load_checkpoint(self.result_path(job))
        if loaded is None:
            return None
        _, arrays = loaded
        return arrays.get("value")


# ---------------------------------------------------------------- submit

def submit_job(store: JobStore, job: str, op: str,
               params: dict | None = None) -> tuple[dict, bool]:
    """Normalize ``params`` through the registered kind and publish the
    PENDING record (idempotent); emits ``job-submitted`` only when the
    record was actually created."""
    from .workloads import JOB_KINDS

    if op not in JOB_KINDS:
        raise JobError(f"unknown job op {op!r} (have: {sorted(JOB_KINDS)})")
    kind = JOB_KINDS[op]
    p = kind.normalize(params or {})
    total_iters, epoch_iters, total_epochs = kind.totals(p)
    rec, created = store.submit(job, op, p, total_iters=total_iters,
                                epoch_iters=epoch_iters,
                                total_epochs=total_epochs)
    if created:
        metrics.counter("jobs.submitted").inc()
        record_event("job-submitted", job=rec["job"], op=op,
                     total_epochs=total_epochs)
    return rec, created


# -------------------------------------------------------------- executor

class JobExecutor:
    """Runs job epochs in the serving lane's idle gaps; see the module
    docstring for the scheduling and durability contract."""

    def __init__(self, store: JobStore, server=None, rank: str | None = None,
                 commit_retries: int = 3, device=None):
        from .workloads import serving_device

        self.store = store
        self.server = server          # serve.server.Server | None
        #: where the epochs run: ``device``, else the server's, else cuda
        self.device = serving_device(
            device if device is not None
            else getattr(server, "device", None))
        self.rank = str(rank if rank is not None
                        else os.environ.get("RANK", "main"))
        self.commit_retries = commit_retries
        self.epochs_run = 0
        self._active: str | None = None
        self._ctx: dict[str, dict] = {}
        self._started_here: set[str] = set()
        self._preempted_here: set[str] = set()
        self._commit_failures: dict[str, int] = {}

    # ------------------------------------------------------- scheduling

    def preempt_reason(self) -> str | None:
        """Why a job epoch must NOT run right now: interactive work is
        queued, or the SLO monitor is burning.  Checked before every
        epoch — the preemption boundary is the epoch boundary."""
        server = self.server
        if server is None:
            return None
        if len(server.queue):
            return "queue-depth"
        slo = getattr(server, "slo", None)
        if slo is not None and getattr(slo, "burning", False):
            return "slo-burn"
        return None

    def _acquire(self) -> str | None:
        """The next runnable job this rank owns (claiming unowned ones);
        sorted record order keeps the scan deterministic."""
        for rec in self.store.list_jobs():
            if rec["state"] in TERMINAL:
                continue
            jid = rec["job"]
            own = self.store.owner(jid)
            if own is None:
                if not self.store.claim(jid, self.rank):
                    continue
            elif own != self.rank:
                continue
            return jid
        return None

    def tick(self) -> bool:
        """At most one job epoch (or one state transition); returns True
        when durable progress was made.  Never raises into the serving
        thread — an unexpected error fails the job instead."""
        jid = self._active
        if jid is not None:
            rec = self.store.load(jid)
            if rec is None or rec["state"] in TERMINAL:
                self._active = None
                jid = None
        if jid is None:
            jid = self._acquire()
            if jid is None:
                return False
            self._active = jid
        try:
            return self._tick_one(jid)
        except InjectedFault:
            # an injected ``ckpt:commit`` abort at a record publish: all
            # durable state (the epoch checkpoint, the prior record) is
            # intact — the write-ahead intent replays next tick and the
            # work rolls forward without re-execution.  Bounded: past
            # ``commit_retries`` failures the job FAILs (the chaos
            # ``ckpt-retry`` handicap sets 0 to drill that path).
            n = self._commit_failures.get(jid, 0) + 1
            self._commit_failures[jid] = n
            metrics.counter("jobs.commit_failures").inc()
            if n > self.commit_retries:
                rec = self.store.load(jid)
                if rec is not None and rec["state"] not in TERMINAL:
                    self._finish(rec, FAILED, reason="commit-failed")
                self._active = None
            return True
        except Exception as e:        # noqa: BLE001 — job lane boundary
            metrics.counter("jobs.errors").inc()
            rec = self.store.load(jid)
            if rec is not None and rec["state"] not in TERMINAL:
                self._finish(rec, FAILED,
                             reason=f"{type(e).__name__}: {str(e)[:200]}")
            self._active = None
            return True

    def _tick_one(self, jid: str) -> bool:
        rec = self.store.load(jid)
        if rec is None:
            self._active = None
            return False
        if self.store.cancel_requested(jid):
            if rec["state"] in TERMINAL:
                self._active = None
                return False
            self._finish(rec, FAILED, reason="cancelled")
            self._active = None
            return True
        reason = self.preempt_reason()
        if reason is not None:
            if rec["state"] == RUNNING and jid in self._started_here:
                rec["preemptions"] = int(rec.get("preemptions") or 0) + 1
                self.store.publish(rec, state=PREEMPTED,
                                   preemptions=rec["preemptions"])
                metrics.counter("jobs.preemptions").inc()
                record_event("job-preempted", job=jid, op=rec["op"],
                             epoch=rec["epoch"], reason=reason)
                self._preempted_here.add(jid)
            return False
        self._activate(rec)
        return self._run_epoch(rec)

    def _activate(self, rec: dict) -> None:
        """PENDING/PREEMPTED/orphaned-RUNNING → RUNNING, emitting
        ``job-resumed`` with how the work got here: ``preempted`` (this
        process paused it), ``restart`` (a PREEMPTED record from disk —
        the previous owner is gone), ``crash`` (a RUNNING record from
        disk — the previous owner died mid-job)."""
        jid = rec["job"]
        source = None
        if rec["state"] == PREEMPTED:
            source = ("preempted" if jid in self._preempted_here
                      else "restart")
        elif rec["state"] == RUNNING and jid not in self._started_here:
            source = "crash"
        if rec["state"] != RUNNING or source is not None:
            updates = {"state": RUNNING}
            if source is not None:
                rec["resumes"] = int(rec.get("resumes") or 0) + 1
                updates["resumes"] = rec["resumes"]
            self.store.publish(rec, **updates)
        if source is not None:
            metrics.counter("jobs.resumes").inc()
            record_event("job-resumed", job=jid, op=rec["op"],
                         epoch=rec["epoch"], source=source)
        self._preempted_here.discard(jid)
        self._started_here.add(jid)

    def _context(self, rec: dict) -> dict:
        jid = rec["job"]
        ctx = self._ctx.get(jid)
        if ctx is None:
            from .workloads import JOB_KINDS

            kind = JOB_KINDS[rec["op"]]
            state0, step_fn = kind.make(rec["params"], self.device)
            ctx = {"state0": state0, "step_fn": step_fn,
                   "tracker": kind.tracker(rec["params"], jid),
                   "finalize": getattr(kind, "finalize", host_array)}
            self._ctx[jid] = ctx
        return ctx

    def _run_epoch(self, rec: dict) -> bool:
        """One write-ahead epoch: intent → checkpointed chunk → record
        publish.  A pending intent from a crashed/injected-fault commit
        re-targets the SAME epoch — ``run_with_checkpoints`` resumes at
        the durable checkpoint's step, so a committed epoch's iterations
        are never executed twice."""
        from ..core.checkpoint import run_with_checkpoints

        jid = rec["job"]
        ctx = self._context(rec)
        if int(rec["iters"]) >= int(rec["total_iters"]):
            # every iteration is committed but a terminal publish was
            # lost (crash/injected commit abort between the last epoch
            # and DONE): finalize straight from the durable checkpoint
            state = run_with_checkpoints(
                ctx["step_fn"], ctx["state0"], int(rec["total_iters"]),
                self.store.checkpoint_path(jid),
                every=int(rec["epoch_iters"]), op=f"job.{rec['op']}",
                tracker=ctx["tracker"])
            value = ctx["finalize"](state)
            crc = self.store.save_result(jid, int(rec["iters"]), value)
            self._finish(rec, DONE, result_crc=int(crc))
            self._active = None
            return True
        intent = rec.get("intent")
        if intent is not None and intent.get("kind") == "epoch":
            # write-ahead replay: a crash (or injected commit abort)
            # landed between the epoch checkpoint and the record publish.
            # Re-target the SAME epoch — run_with_checkpoints resumes at
            # the checkpoint's step, so anything already durable is
            # rolled forward, not re-executed.
            epoch_no = int(intent["epoch"])
            target = int(intent["iters"])
            metrics.counter("jobs.intent_replays").inc()
        else:
            epoch_no = int(rec["epoch"]) + 1
            target = min(int(rec["iters"]) + int(rec["epoch_iters"]),
                         int(rec["total_iters"]))
            self.store.intent(rec, kind="epoch", epoch=epoch_no,
                              iters=target)
        from ..core.resilience import all_finite

        tracker = ctx["tracker"]
        state = run_with_checkpoints(
            ctx["step_fn"], ctx["state0"], target,
            self.store.checkpoint_path(jid), every=int(rec["epoch_iters"]),
            op=f"job.{rec['op']}", guard=all_finite, tracker=tracker)
        residual = tracker.last_residual
        self.store.publish(
            rec, state=RUNNING, epoch=epoch_no, iters=target,
            residual=(None if residual is None
                      else round(float(residual), 9)))
        self._commit_failures.pop(jid, None)
        self.epochs_run += 1
        metrics.counter("jobs.epochs").inc()
        record_event("job-epoch", job=jid, op=rec["op"], epoch=epoch_no,
                     residual=rec["residual"])
        tol = float(rec["params"].get("tol") or 0.0)
        converged = (tol > 0.0 and residual is not None
                     and float(residual) <= tol)
        if target >= int(rec["total_iters"]) or converged:
            value = ctx["finalize"](state)
            crc = self.store.save_result(jid, target, value)
            self._finish(rec, DONE, result_crc=int(crc))
            self._active = None
        elif tracker.stalled:
            self._finish(rec, STALLED, reason="convergence-stall")
            self._active = None
        return True

    def _finish(self, rec: dict, state: str, reason: str | None = None,
                result_crc: int | None = None) -> None:
        self.store.publish(rec, state=state, reason=reason,
                           result_crc=result_crc)
        metrics.counter(f"jobs.{state.lower()}").inc()
        record_event("job-done", job=rec["job"], op=rec["op"], state=state,
                     epochs=rec["epoch"])

    def stats(self) -> dict:
        counts: dict[str, int] = {}
        for rec in self.store.list_jobs():
            counts[rec["state"]] = counts.get(rec["state"], 0) + 1
        return {"active": self._active, "epochs_run": self.epochs_run,
                "states": counts}


# -------------------------------------------------------------- controls

def handle_control(store: JobStore, doc: dict) -> dict:
    """Serve one ``job-*`` control document against a store — shared by
    the replica transport (``serve/transport.py``) and the fleet front
    end (the JAX package's ``serve/fleet.py``), both of which see the same
    directory."""
    from . import wire

    kind = doc.get("control")
    try:
        if kind == "job-submit":
            rec, created = submit_job(store, doc.get("job", ""),
                                      doc.get("op", "pagerank"),
                                      doc.get("params") or {})
            return {"ok": True, "created": created, "job": public(rec)}
        if kind == "job-status":
            rec = store.load(doc.get("job", ""))
            if rec is None:
                return {"ok": False, "error": "no such job"}
            out = public(rec)
            out["owner"] = store.owner(rec["job"])
            return {"ok": True, "job": out}
        if kind == "job-list":
            return {"ok": True,
                    "jobs": [public(r) for r in store.list_jobs()]}
        if kind == "job-cancel":
            if store.load(doc.get("job", "")) is None:
                return {"ok": False, "error": "no such job"}
            store.request_cancel(doc["job"])
            return {"ok": True}
        if kind == "job-result":
            rec = store.load(doc.get("job", ""))
            if rec is None:
                return {"ok": False, "error": "no such job"}
            if rec["state"] != DONE:
                return {"ok": False, "state": rec["state"],
                        "error": f"job is {rec['state']}, not DONE"}
            value = store.load_result(rec["job"])
            if value is None:
                return {"ok": False, "state": rec["state"],
                        "error": "result file missing/corrupt"}
            return {"ok": True, "job": public(rec),
                    "value": wire.nd_b64(value)}
    except JobError as e:
        return {"ok": False, "error": str(e)}
    return {"ok": False, "error": f"unknown job control {kind!r}"}
