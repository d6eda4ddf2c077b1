"""Multi-process launcher — the ``mpirun -np N`` / PBS layer, as a tool.

Counterpart of ``cme213_tpu/dist/launch.py``.  The reference launches
distributed runs with ``mpirun -np N ./2dHeat`` under Torque/PBS
(``hw/hw5/PA5_Handout.pdf`` §4).  Here, for one machine:

    python -m cme213_tpu_torch.dist.launch --np 2 [--devices-per-proc 2] \
        -- python -m cme213_tpu_torch heat2d params.in --distributed

It hosts the process group's rendezvous itself, as torchrun's agent does
(``Rendezvous``): for each incarnation a socket bound to a port the system
picks and listening before any rank starts, so no other process can take
the port between its choice and the bind; torch's ``TCPStore`` then
serves on that socket, and the ranks join it as clients
(``TORCHELASTIC_USE_AGENT_STORE=True``).  It spawns N copies of
the command with torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) that
``dist.multihost.initialize_multihost`` reads, prefixes each line of
output with its rank (mpirun's ``-tag-output``), and exits non-zero if a
rank fails.  ``--devices-per-proc N`` exports ``CME213_DEVICES_PER_PROC``:
each rank then holds N shards on its own device
(``core.platform.virtual_devices``).  It never moves a rank to the CPU; a
rank runs there only when its command asks (``--device=cpu``).

Each rank chooses its backend from the device it runs on
(``multihost.resolve_backend``: ``nccl`` when each rank gets a card of its
own, else ``gloo``), since only the rank knows where its shards lie.
``--backend gloo`` asks every rank for gloo and is exported as
``CME213_DIST_BACKEND``; ``auto``, the default, exports nothing.  The
``gang-launch`` span names the backend the launcher expects
(``gang_backend``: the same rule, for the command's ``--device=``); each
rank's start line names the one it joined with.

Failure handling is layered:

- ``--max-restarts N``: a rank that exits non-zero is relaunched with the
  SAME rank id (and ``CME213_INCARNATION`` bumped, so a deterministic
  ``CME213_FAULTS=rankkill:...`` fires only on the first incarnation) up to
  N times before the job is declared dead.
- ``--timeout SECS``: a hard wall-clock deadline on the whole job; expiry
  kills all ranks and returns 124 (the ``timeout(1)`` convention).
- ``--handshake-timeout SECS``: exported as ``CME213_HANDSHAKE_TIMEOUT``,
  the process group's timeout (``initialize_multihost``), so a rank whose
  peer never appears fails (and can be restarted) instead of waiting for
  torch's 30-minute default.

Only a rank exhausting its restart budget fails the job (fail-fast: the
others are then terminated, the MPI_Abort analog).

**Supervised gangs** (``--stall-timeout``, ``launch_supervised``): a rank
that dies mid-exchange leaves its peers blocked, so the gang is the
failure unit (TorchElastic-style).  Ranks publish file heartbeats carrying
their step (``dist/supervisor.py``), and the launcher tells "rank exited"
(poll) from "rank alive but frozen" (its step unchanged for
``--stall-timeout`` seconds).  Either verdict kills the WHOLE gang and
relaunches it on a fresh port with the incarnation bumped; the workload
resumes from the last committed epoch (``dist/ckpt.py``, wired by
``--ckpt-dir``/``--ckpt-every``/``--resume``).  Recovery from an injected
``rankkill`` is deterministic: the fault fires only in incarnation 0, and
epoch commits make the recovered solve bit for bit the uninterrupted one.

Importing this module does not import ``torch``.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

#: torchrun's rendezvous host for a gang on this machine
_HOST = "127.0.0.1"


def free_port() -> int:
    with socket.socket() as s:
        s.bind((_HOST, 0))
        return s.getsockname()[1]


class Rendezvous:
    """One incarnation's rendezvous.  ``port`` is bound and listening from
    construction on (no torch yet); ``serve()`` starts torch's
    ``TCPStore`` on that socket, which the ranks join as clients under
    ``TORCHELASTIC_USE_AGENT_STORE=True`` — called after they are
    spawned, torch's import overlaps their start-up, and a rank that
    connects first waits in the listen queue.  ``close()`` ends it."""

    def __init__(self, host: str = _HOST):
        self.host = host
        self._sock = socket.socket()
        self._sock.bind((host, 0))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._store = None

    def serve(self) -> "Rendezvous":
        if self._store is None:
            from torch.distributed import TCPStore

            self._store = TCPStore(self.host, self.port, is_master=True,
                                   wait_for_workers=False,
                                   master_listen_fd=self._sock.fileno())
            self._sock.detach()  # the store owns the socket now
        return self

    def close(self) -> None:
        if self._store is not None:
            self._store = None  # closes its socket
        else:
            self._sock.close()


def gang_backend(world: int, cmd: list[str], asked: str = "auto") -> str:
    """The backend a gang of ``world`` ranks running ``cmd`` is expected to
    join, for the ``gang-launch`` span: ``gloo`` when asked for (here or in
    ``CME213_DIST_BACKEND``), else the layout's for the command's
    ``--device=``.  It is a record, never exported: a rank whose code puts
    its shards elsewhere chooses for itself.  Raises ``ValueError`` for a
    backend outside ``multihost.BACKENDS``."""
    from .multihost import resolve_backend

    device = next((a.split("=", 1)[1] for a in cmd
                   if a.startswith("--device=")), None)
    return resolve_backend(world, device, None if asked == "auto" else asked)


def _pump(rank: int, stream, out) -> None:
    for line in stream:
        out.write(f"[rank {rank}] {line}")
        out.flush()


def _template_trace_file(env: dict, rank: int) -> str | None:
    """Expand a ``{rank}`` placeholder in the worker's ``CME213_TRACE_FILE``
    so gang members write per-rank sink files instead of interleaving into
    one (the launcher's own events keep the un-expanded path, which
    ``core/trace`` resolves to ``...main...`` for non-rank processes).
    Returns the worker's resolved sink path (for the end-of-gang federated
    exposition), or None when unconfigured."""
    tf = env.get("CME213_TRACE_FILE")
    if tf and "{rank}" in tf:
        tf = tf.replace("{rank}", str(rank))
        env["CME213_TRACE_FILE"] = tf
    return tf


def _template_metrics_file(env: dict, rank: int) -> None:
    """Point the worker's ``CME213_METRICS_FILE`` at a per-rank path —
    ``{rank}``-expanded, else ``.rank<N>``-suffixed — so N workers plus
    the launcher's federated aggregate never clobber one file."""
    mf = env.get("CME213_METRICS_FILE")
    if not mf:
        return
    if "{rank}" in mf:
        env["CME213_METRICS_FILE"] = mf.replace("{rank}", str(rank))
    else:
        env["CME213_METRICS_FILE"] = f"{mf}.rank{rank}"


def _fleet_exposition(sink_paths: list[str]) -> None:
    """After the gang ends, fold every rank's final ``metrics-snapshot``
    (from the per-rank sinks) plus the launcher's own registry into one
    federated exposition at ``CME213_METRICS_FILE``, pinned against the
    launcher's own exit-time overwrite."""
    dest = os.environ.get("CME213_METRICS_FILE")
    if not dest:
        return
    try:
        from ..core import metrics
        from ..core.collector import write_fleet_exposition

        write_fleet_exposition(
            [p for p in sink_paths if p], path=dest,
            extra={"launcher": metrics.snapshot()})
    except Exception as exc:  # telemetry must never fail the job
        print(f"[launcher] fleet exposition failed: {exc}", flush=True)


def _rank_env(rank: int, world: int, host: str, port: int,
              incarnation: int, ctx_env: dict, devices_per_proc: int | None,
              handshake_timeout: float | None, backend: str,
              agent_store: bool = True) -> dict:
    """One rank's environment: torchrun's variables (with the launcher's
    store as the rendezvous when ``agent_store``), the incarnation, the
    backend when one was asked for, the trace context, and the launcher's
    options."""
    from .multihost import (BACKEND_ENV, DEVICES_PER_PROC_ENV,
                            HANDSHAKE_TIMEOUT_ENV)

    env = dict(os.environ, MASTER_ADDR=host, MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               CME213_INCARNATION=str(incarnation), **ctx_env)
    if backend != "auto":
        env[BACKEND_ENV] = backend
    if agent_store:
        env.update(TORCHELASTIC_USE_AGENT_STORE="True",
                   TORCHELASTIC_RESTART_COUNT="0")
    else:
        env.pop("TORCHELASTIC_USE_AGENT_STORE", None)
    if handshake_timeout is not None:
        env[HANDSHAKE_TIMEOUT_ENV] = str(handshake_timeout)
    if devices_per_proc:
        env[DEVICES_PER_PROC_ENV] = str(devices_per_proc)
    return env


def _spawn(rank: int, cmd: list[str], env: dict, pumps: list):
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    t = threading.Thread(target=_pump, args=(rank, p.stdout, sys.stdout),
                         daemon=True)
    t.start()
    pumps.append(t)
    return p


def launch(np_procs: int, cmd: list[str], devices_per_proc: int | None = None,
           coordinator: str | None = None, timeout: float | None = None,
           handshake_timeout: float | None = None,
           max_restarts: int = 0, backend: str = "auto") -> int:
    """Spawn ``np_procs`` copies of ``cmd`` with launcher env; returns the
    first unrecovered nonzero exit code (terminating the other ranks),
    124 on ``timeout`` expiry, else 0.  A failed rank is relaunched with
    the same rank id up to ``max_restarts`` times first.  ``coordinator``
    (``host:port``) fixes the rendezvous, which rank 0 then hosts; by
    default the launcher hosts it (``Rendezvous``).  ``backend``:
    ``auto`` (each rank's layout decides) or ``gloo``."""
    from ..core.trace import propagation_env, record_event, span

    expected = gang_backend(np_procs, cmd, backend)
    rendezvous = None
    if coordinator is None:
        rendezvous = Rendezvous()
        host, port = _HOST, rendezvous.port
    else:
        host, _, port = coordinator.rpartition(":")
        port = int(port)
    coordinator = f"{host}:{port}"
    procs: dict[int, subprocess.Popen] = {}
    restarts = {rank: 0 for rank in range(np_procs)}
    sink_paths: dict[int, str | None] = {}
    pumps: list = []
    ctx_env: dict = {}
    rc = 0

    def spawn(rank: int, incarnation: int) -> subprocess.Popen:
        env = _rank_env(rank, np_procs, host, port, incarnation, ctx_env,
                        devices_per_proc, handshake_timeout, backend,
                        agent_store=rendezvous is not None)
        sink_paths[rank] = _template_trace_file(env, rank)
        _template_metrics_file(env, rank)
        return _spawn(rank, cmd, env, pumps)

    deadline = (time.monotonic() + timeout) if timeout else None
    try:
        # the gang-launch span is the root every child's spans parent
        # under (via CME213_TRACE_CONTEXT), so a merged multi-rank trace
        # is one causal tree sharing the launcher's trace id
        with span("gang-launch", world=np_procs, coordinator=coordinator,
                  backend=expected):
            record_event("gang-launch", incarnation=0, world=np_procs,
                         coordinator=coordinator)
            ctx_env.update(propagation_env())
            for rank in range(np_procs):
                procs[rank] = spawn(rank, 0)
            if rendezvous is not None and np_procs > 1:
                rendezvous.serve()

            # poll ALL ranks: a wait() in rank order would miss a higher
            # rank dying first while rank 0 blocks in the rendezvous
            live = set(range(np_procs))
            while live and not rc:
                for i in sorted(live):
                    code = procs[i].poll()
                    if code is None:
                        continue
                    if code and restarts[i] < max_restarts:
                        restarts[i] += 1
                        print(f"[launcher] rank {i} exited {code}; "
                              f"restarting (incarnation "
                              f"{restarts[i]}/{max_restarts})", flush=True)
                        procs[i] = spawn(i, restarts[i])
                        continue
                    live.discard(i)
                    if code and not rc:
                        rc = code
                        # fail-fast: take survivors down
                        for q in procs.values():
                            if q.poll() is None:
                                q.terminate()
                if (deadline is not None and time.monotonic() > deadline
                        and live):
                    print(f"[launcher] timeout after {timeout}s; killing "
                          f"{len(live)} live rank(s)", flush=True)
                    rc = 124
                    for q in procs.values():
                        if q.poll() is None:
                            q.terminate()
                    break
                if live and not rc:
                    time.sleep(0.05)
        record_event("gang-exit", incarnation=0, rc=rc)
    finally:
        for q in procs.values():
            if q.poll() is None:
                q.kill()
                q.wait()
        for t in pumps:
            t.join(timeout=5)
        if rendezvous is not None:
            rendezvous.close()
        from ..core.trace import flush_sink

        flush_sink()
        _fleet_exposition([p for p in sink_paths.values() if p])
    return rc


def launch_supervised(np_procs: int, cmd: list[str],
                      devices_per_proc: int | None = None,
                      timeout: float | None = None,
                      handshake_timeout: float | None = None,
                      max_restarts: int = 1,
                      heartbeat_interval: float = 1.0,
                      stall_timeout: float = 30.0,
                      ckpt_dir: str | None = None, ckpt_every: int = 0,
                      resume: bool = False,
                      poll_interval: float = 0.05,
                      backend: str = "auto") -> int:
    """Run ``cmd`` as a supervised gang of ``np_procs`` ranks.

    Failure unit = the gang: a rank exiting nonzero OR a rank whose
    heartbeat step freezes for ``stall_timeout`` seconds condemns the
    incarnation — every rank is killed and the gang is relaunched on a
    fresh port with ``CME213_INCARNATION`` bumped, up to ``max_restarts``
    times.  Relaunched incarnations always get ``CME213_RESUME=1`` so the
    workload resumes from the last committed epoch; the first incarnation
    resumes only when ``resume``.  The process group's timeout
    (``handshake_timeout``) is raised to at least ``stall_timeout``, so a
    rank waiting for a frozen peer is condemned by the stall clock first.

    Under NCCL a killed rank leaves its peers blocked inside a collective;
    the exit verdict condemns the gang all the same, and ``kill_gang``
    ends the blocked ranks (SIGTERM, then SIGKILL after 5 s).  Each
    incarnation gets a fresh rendezvous store, so its ranks build a fresh
    process group.

    Returns 0 on success, the condemning rank's exit code once the budget
    is exhausted (124 for a stall — it is a hang), or 124 on whole-job
    ``timeout``.
    """
    import contextlib

    from ..core.trace import propagation_env, record_event, span
    from .supervisor import (CKPT_DIR_ENV, CKPT_EVERY_ENV, GangSupervisor,
                             HEARTBEAT_DIR_ENV, HEARTBEAT_INTERVAL_ENV,
                             RESUME_ENV)

    expected = gang_backend(np_procs, cmd, backend)
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        hb_dir = os.path.join(ckpt_dir, ".heartbeats")
    else:
        hb_dir = tempfile.mkdtemp(prefix="cme213_hb_")
    if handshake_timeout is not None:
        handshake_timeout = max(handshake_timeout, stall_timeout)
    supervisor = GangSupervisor(hb_dir, np_procs, stall_timeout)
    pumps: list = []
    sink_paths: dict[int, str | None] = {}
    # one gang-launch span per incarnation: children parent their root
    # spans under the incarnation that spawned them, so a merged trace
    # separates pre- and post-restart causality
    gang_span = contextlib.ExitStack()
    rendezvous: list = []  # the live incarnation's

    def spawn_gang(incarnation: int) -> dict[int, subprocess.Popen]:
        # a fresh rendezvous per incarnation: its ranks build a fresh
        # group, and the previous port may linger in TIME_WAIT
        for r in rendezvous:
            r.close()
        rendezvous[:] = [Rendezvous()]
        port = rendezvous[0].port
        coordinator = f"{_HOST}:{port}"
        gang_span.close()
        gang_span.enter_context(
            span("gang-launch", incarnation=incarnation, world=np_procs,
                 coordinator=coordinator, backend=expected))
        record_event("gang-launch", incarnation=incarnation,
                     world=np_procs, coordinator=coordinator)
        ctx_env = propagation_env()
        procs = {}
        for rank in range(np_procs):
            env = _rank_env(rank, np_procs, _HOST, port, incarnation,
                            ctx_env, devices_per_proc, handshake_timeout,
                            backend)
            sink_paths[rank] = _template_trace_file(env, rank)
            _template_metrics_file(env, rank)
            env[HEARTBEAT_DIR_ENV] = hb_dir
            env[HEARTBEAT_INTERVAL_ENV] = str(heartbeat_interval)
            if ckpt_dir:
                env[CKPT_DIR_ENV] = ckpt_dir
                env[CKPT_EVERY_ENV] = str(ckpt_every)
            env[RESUME_ENV] = "1" if (resume or incarnation > 0) else "0"
            procs[rank] = _spawn(rank, cmd, env, pumps)
        if np_procs > 1:
            rendezvous[0].serve()
        return procs

    def kill_gang(procs) -> None:
        for q in procs.values():
            if q.poll() is None:
                q.terminate()
        deadline = time.monotonic() + 5
        for q in procs.values():
            while q.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            if q.poll() is None:
                q.kill()
                q.wait()

    deadline = (time.monotonic() + timeout) if timeout else None
    incarnation = 0
    procs = spawn_gang(0)
    rc = 0
    try:
        while True:
            condemned = None  # {"rank", "reason", ...} of the first verdict
            exited = {r: p.poll() for r, p in procs.items()}
            for rank, code in sorted(exited.items()):
                if code is not None and code != 0:
                    condemned = {"rank": rank, "reason": "exit",
                                 "code": code}
                    break
            if condemned is None and all(c == 0 for c in exited.values()):
                record_event("gang-exit", incarnation=incarnation, rc=0)
                return 0
            if condemned is None:
                for s in supervisor.stalled():
                    if exited[s["rank"]] is None:  # alive but frozen
                        condemned = {**s, "reason": "stall"}
                        break
            if condemned is None:
                if deadline is not None and time.monotonic() > deadline:
                    print(f"[launcher] timeout after {timeout}s; killing "
                          f"the gang", flush=True)
                    record_event("gang-exit", incarnation=incarnation,
                                 rc=124)
                    return 124
                time.sleep(poll_interval)
                continue

            rc = condemned.get("code", 124)  # stall = hang = 124
            record_event("rank-failed", **condemned,
                         incarnation=incarnation)
            print(f"[launcher] rank {condemned['rank']} "
                  + (f"exited {condemned['code']}"
                     if condemned["reason"] == "exit"
                     else f"stalled at step {condemned.get('step')} for "
                          f"{condemned.get('stalled_s')}s")
                  + "; condemning the gang", flush=True)
            kill_gang(procs)
            if incarnation >= max_restarts:
                print(f"[launcher] gang restart budget exhausted "
                      f"({max_restarts}); failing", flush=True)
                record_event("gang-exit", incarnation=incarnation, rc=rc)
                return rc
            incarnation += 1
            record_event("gang-restart", incarnation=incarnation,
                         reason=condemned["reason"],
                         rank=condemned["rank"])
            print(f"[launcher] gang restart "
                  f"(incarnation {incarnation}/{max_restarts}), resuming "
                  f"from last committed epoch", flush=True)
            supervisor.reset()
            procs = spawn_gang(incarnation)
    finally:
        kill_gang(procs)
        for r in rendezvous:
            r.close()
        gang_span.close()
        for t in pumps:
            t.join(timeout=5)
        from ..core.trace import flush_sink

        flush_sink()
        _fleet_exposition([p for p in sink_paths.values() if p])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="mpirun-style launcher for multi-process torch runs")
    ap.add_argument("--np", dest="np_procs", type=int, required=True,
                    help="number of processes (MPI world size)")
    ap.add_argument("--devices-per-proc", type=int, default=None,
                    help="shards each rank holds on its own device "
                         "(exported as CME213_DEVICES_PER_PROC)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the rendezvous (default: "
                         "127.0.0.1:<free port>)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="hard wall-clock deadline in seconds for the whole "
                         "job (returns 124 on expiry)")
    ap.add_argument("--handshake-timeout", type=float, default=None,
                    help="the process group's timeout in seconds, exported "
                         "to ranks as CME213_HANDSHAKE_TIMEOUT")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="relaunch a failed rank (same rank id) up to this "
                         "many times before failing the job; in supervised "
                         "mode (--stall-timeout) this is the GANG restart "
                         "budget")
    ap.add_argument("--stall-timeout", type=float, default=None,
                    help="supervised mode: condemn the gang when any live "
                         "rank's heartbeat step is frozen this many "
                         "seconds; the gang is killed and relaunched from "
                         "the last committed epoch")
    ap.add_argument("--heartbeat-interval", type=float, default=1.0,
                    help="supervised mode: seconds between same-step "
                         "heartbeat re-emits (exported as "
                         "CME213_HEARTBEAT_INTERVAL)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="supervised mode: epoch-commit checkpoint "
                         "directory (exported as CME213_CKPT_DIR)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="supervised mode: iterations per committed epoch "
                         "(exported as CME213_CKPT_EVERY)")
    ap.add_argument("--resume", action="store_true",
                    help="supervised mode: the FIRST incarnation also "
                         "resumes from an existing commit in --ckpt-dir "
                         "(gang restarts always resume)")
    ap.add_argument("--backend", choices=("auto", "gloo"),
                    default="auto",
                    help="the process group's backend (default auto: each "
                         "rank takes nccl when it gets a card of its own, "
                         "else gloo; gloo is exported as "
                         "CME213_DIST_BACKEND)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to launch (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given (append: -- python your_script.py)")
    # the launcher records its own black box; workers inherit
    # CME213_FLIGHT_DIR through the env and arm their own recorders
    from ..core import flight

    flight.install()
    if args.stall_timeout is not None:
        return launch_supervised(
            args.np_procs, cmd, args.devices_per_proc,
            timeout=args.timeout, handshake_timeout=args.handshake_timeout,
            max_restarts=args.max_restarts,
            heartbeat_interval=args.heartbeat_interval,
            stall_timeout=args.stall_timeout, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, resume=args.resume,
            backend=args.backend)
    return launch(args.np_procs, cmd, args.devices_per_proc,
                  args.coordinator, timeout=args.timeout,
                  handshake_timeout=args.handshake_timeout,
                  max_restarts=args.max_restarts, backend=args.backend)


if __name__ == "__main__":
    raise SystemExit(main())
