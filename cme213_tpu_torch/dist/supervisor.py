"""Gang supervision — heartbeats, stall detection, supervised-run config.

Counterpart of ``cme213_tpu/dist/supervisor.py``.  The reference's failure
model is MPI_Abort: any rank dying kills the job, and a rank *hanging* in a
collective kills nothing.  Here, TorchElastic-style:

- each rank emits **file-based heartbeats** carrying its current step
  (atomic JSON writes, the rename discipline of the checkpoint layer, so
  the supervisor never reads a torn beat);
- the launcher-side :class:`GangSupervisor` folds process liveness and
  heartbeat progress into per-rank verdicts, telling "rank exited" from
  "rank alive but its step counter is frozen" (a rank waiting in a halo
  exchange for a peer that froze) after ``--stall-timeout`` seconds
  without progress;
- either verdict condemns the **whole gang** (``dist/launch.py``), which is
  relaunched and resumes from the last committed epoch (``dist/ckpt.py``).

Heartbeats are files, not messages, so supervision keeps working when the
process group itself is wedged.  A rank's number comes from ``RANK``, as
``dist/launch.py`` exports it.  Importing this module, and beating, does
not import ``torch``: a rank can beat before its first heavy import.
"""

from __future__ import annotations

import glob
import json
import os
import time

#: env names the launcher exports to supervised ranks
HEARTBEAT_DIR_ENV = "CME213_HEARTBEAT_DIR"
HEARTBEAT_INTERVAL_ENV = "CME213_HEARTBEAT_INTERVAL"
CKPT_DIR_ENV = "CME213_CKPT_DIR"
CKPT_EVERY_ENV = "CME213_CKPT_EVERY"
RESUME_ENV = "CME213_RESUME"


def heartbeat_path(hb_dir: str, rank: int) -> str:
    return os.path.join(hb_dir, f"rank{int(rank)}.json")


class HeartbeatWriter:
    """Rank-side heartbeat emitter: ``beat(step)`` atomically publishes
    ``{rank, step, pid, incarnation, t}``.  ``interval`` throttles
    same-step re-beats (a step *change* always publishes — progress is the
    signal the supervisor watches)."""

    def __init__(self, hb_dir: str, rank: int, interval: float = 0.0):
        from ..core.faults import incarnation

        self.path = heartbeat_path(hb_dir, rank)
        self.rank = int(rank)
        self.interval = float(interval)
        self.incarnation = incarnation()
        self._last_step: int | None = None
        self._last_t = 0.0
        os.makedirs(hb_dir, exist_ok=True)

    def beat(self, step: int) -> None:
        now = time.time()
        if (self._last_step == step
                and now - self._last_t < self.interval):
            return
        rec = {"rank": self.rank, "step": int(step), "pid": os.getpid(),
               "incarnation": self.incarnation, "t": round(now, 6)}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)
        self._last_step = step
        self._last_t = now
        # each *published* beat goes into the trace too (same throttle),
        # so `trace merge` interleaves rank progress with commits and
        # gang verdicts
        from ..core.trace import record_event

        record_event("heartbeat", rank=self.rank, step=int(step))


def heartbeat_from_env() -> HeartbeatWriter | None:
    """The supervised-rank entry: a writer wired from the launcher's env,
    or None when this run is not supervised."""
    hb_dir = os.environ.get(HEARTBEAT_DIR_ENV)
    if not hb_dir:
        return None
    rank = int(os.environ.get("RANK", "0"))
    interval = float(os.environ.get(HEARTBEAT_INTERVAL_ENV, "0") or 0)
    return HeartbeatWriter(hb_dir, rank, interval=interval)


def read_heartbeat(hb_dir: str, rank: int) -> dict | None:
    """One rank's latest beat, or None (a missing file is normal before
    the first beat; a torn read cannot happen, beats land by rename)."""
    try:
        with open(heartbeat_path(hb_dir, rank)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_all_heartbeats(hb_dir: str) -> dict[int, dict]:
    """Every rank's latest beat in ``hb_dir``, keyed by rank — discovered
    by globbing ``rank*.json`` so callers (``top --hb-dir``) need not know
    the world size.  Unreadable or malformed files are skipped."""
    out: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(hb_dir, "rank*.json"))):
        try:
            with open(path) as f:
                beat = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(beat, dict) and isinstance(beat.get("rank"), int):
            out[beat["rank"]] = beat
    return out


def supervised_env_config() -> dict:
    """Checkpoint plumbing the launcher exported for this rank:
    ``{ckpt_dir, ckpt_every, resume}`` (ckpt_dir None when unsupervised)."""
    return {
        "ckpt_dir": os.environ.get(CKPT_DIR_ENV) or None,
        "ckpt_every": int(os.environ.get(CKPT_EVERY_ENV, "0") or 0),
        "resume": os.environ.get(RESUME_ENV, "") not in ("", "0"),
    }


class GangSupervisor:
    """Launcher-side progress tracker for one gang incarnation.

    ``stalled()`` lists ranks whose heartbeat step has not advanced within
    ``stall_timeout`` seconds — counted from gang spawn for ranks that
    never beat at all, so a rank wedged in the rendezvous (or in its first
    exchange) is caught by the same clock.  The caller decides which of
    them are alive.
    """

    def __init__(self, hb_dir: str, num_ranks: int, stall_timeout: float,
                 clock=None):
        self.hb_dir = hb_dir
        self.num_ranks = int(num_ranks)
        self.stall_timeout = float(stall_timeout)
        # injectable time source (core.resilience.Clock protocol) so stall
        # budgets are testable without wall-clock sleeps
        if clock is None:
            from ..core.resilience import Clock

            clock = Clock()
        self.clock = clock
        self.reset()

    def reset(self) -> None:
        """New gang incarnation: restart every rank's progress clock and
        drop stale beats from the previous incarnation."""
        now = self.clock.now()
        self._progress = {r: (None, now) for r in range(self.num_ranks)}
        for r in range(self.num_ranks):
            try:
                os.unlink(heartbeat_path(self.hb_dir, r))
            except OSError:
                pass

    def step_of(self, rank: int) -> int | None:
        beat = read_heartbeat(self.hb_dir, rank)
        return None if beat is None else beat.get("step")

    def stalled(self) -> list[dict]:
        """Ranks whose step counter is frozen past the stall budget:
        ``[{rank, step, stalled_s}]``."""
        now = self.clock.now()
        out = []
        for rank in range(self.num_ranks):
            step = self.step_of(rank)
            last_step, since = self._progress[rank]
            if step != last_step:  # progress (or first beat): reset clock
                self._progress[rank] = (step, now)
                continue
            if now - since > self.stall_timeout:
                out.append({"rank": rank, "step": step,
                            "stalled_s": round(now - since, 3)})
        return out
