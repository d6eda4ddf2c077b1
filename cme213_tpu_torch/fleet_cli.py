"""``python -m cme213_tpu_torch fleet`` — run the replicated serving fleet.

Counterpart of ``cme213_tpu/fleet_cli.py``.  ``fleet up --device``
defaults to ``cuda``, as ``serve loadgen --device`` does: with no card and
no ``--device=cpu`` it raises ``FrameworkError`` before any replica
starts.

Three subcommands:

- ``up``: spawn N replica worker processes, start the tenant-fair front
  tier (``serve/fleet.py``), print/write the listen address, and serve
  until ``--max-seconds`` elapses or the process is terminated.  Drive
  it with ``python -m cme213_tpu serve loadgen --transport <addr>``.
- ``worker``: one replica process — spawned by ``up``; not normally run
  by hand.
- ``jobs``: submit and inspect durable long jobs on a running fleet
  (``submit|status|list|cancel|result|wait``).

Example (two replicas, open-loop load, one replica killed mid-run by an
injected fault — zero accepted-request loss)::

    CME213_FAULTS="replica-kill:1:2" CME213_FLIGHT_DIR=flight \\
        python -m cme213_tpu_torch fleet up --replicas 2 --addr-file addr &
    python -m cme213_tpu_torch serve loadgen --transport "$(cat addr)" \\
        --mode open --requests 48 --json
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _arm_graceful_shutdown() -> None:
    """Route SIGTERM — and SIGINT even when inherited as ignored — into
    KeyboardInterrupt.  Shells start backgrounded jobs (``fleet up ... &``,
    the CI idiom) with SIGINT set to SIG_IGN, in which case Python never
    installs its own handler and ``kill -INT`` would be a silent no-op:
    the fleet would only exit at ``--max-seconds``.  With the handlers
    armed, a plain ``kill`` tears the fleet down gracefully (stats
    printed, replicas terminated, sinks flushed)."""
    import signal

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    except ValueError:  # not the main thread (embedded use)
        pass


def _up_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="fleet up",
        description="run a replicated serving fleet behind one socket "
                    "front end")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--port", type=int, default=0,
                    help="front-end port (0 = ephemeral; see --addr-file)")
    ap.add_argument("--addr-file", default=None,
                    help="write the bound host:port here once listening")
    ap.add_argument("--capacity", type=int, default=64,
                    help="per-replica server queue capacity")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--mix", default="spmv,heat,cipher",
                    help="warmup mix each replica pre-compiles on start")
    ap.add_argument("--warm-requests", type=int, default=6)
    ap.add_argument("--dispatch-width", type=int, default=None,
                    help="concurrent sends per replica (default max-batch)")
    ap.add_argument("--max-seconds", type=float, default=300.0)
    ap.add_argument("--ready-timeout-s", type=float, default=180.0)
    ap.add_argument("--autoscale", action="store_true",
                    help="arm the SLO-burn autoscaler (needs --slo-p99-ms)")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="p99 objective feeding the autoscaler's burn "
                    "signal")
    ap.add_argument("--jobs-dir", default=None,
                    help="durable long-job directory shared with every "
                    "replica (arms the preemptible job lane)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the final fleet stats as JSON on exit")
    ap.add_argument("--device", default=None,
                    help="where the replicas serve (default cuda; "
                    "--device=cpu to serve on the host)")
    args = ap.parse_args(argv)

    from .core.resilience import Clock
    from .serve import slo as slo_mod
    from .serve.fleet import Fleet
    from .serve.router import Autoscaler

    clock = Clock()
    slo = None
    autoscaler = None
    if args.slo_p99_ms is not None:
        slo = slo_mod.from_flags(clock, p99_ms=args.slo_p99_ms,
                                 shed_rate=None, error_rate=None,
                                 drift_rate=None, short_s=5.0, long_s=60.0,
                                 burn_threshold=2.0, min_samples=10)
    if args.autoscale:
        if slo is None:
            print("fleet up: --autoscale needs --slo-p99-ms",
                  file=sys.stderr)
            return 2
        autoscaler = Autoscaler(clock=clock,
                                min_replicas=args.min_replicas,
                                max_replicas=args.max_replicas)

    fleet = Fleet(replicas=args.replicas, capacity=args.capacity,
                  max_batch=args.max_batch, mix=args.mix,
                  warm_requests=args.warm_requests,
                  dispatch_width=args.dispatch_width,
                  port=args.port, ready_timeout_s=args.ready_timeout_s,
                  slo=slo, autoscaler=autoscaler, clock=clock,
                  jobs_dir=args.jobs_dir, device=args.device)
    try:
        fleet.start()
    except TimeoutError as e:
        print(f"fleet up: {e}", file=sys.stderr)
        return 1
    # banner to stderr under --json so stdout stays one parseable doc
    print(f"fleet: listening on {fleet.addr} "
          f"({args.replicas} replica(s) on {fleet.device})", flush=True,
          file=sys.stderr if args.as_json else sys.stdout)
    if args.addr_file:
        with open(args.addr_file, "w") as f:
            f.write(fleet.addr)
    _arm_graceful_shutdown()
    try:
        deadline = time.monotonic() + args.max_seconds
        while time.monotonic() < deadline:
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    finally:
        stats = fleet.stats()
        fleet.close()
    if args.as_json:
        print(json.dumps(stats, indent=2))
    else:
        print(f"fleet: done; {stats['requeues']} requeue(s), "
              f"scale +{stats['scale_ups']}/-{stats['scale_downs']}")
    return 0


def _jobs_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="fleet jobs",
        description="submit/inspect durable long jobs on a running fleet "
                    "(or single replica) over its control channel")
    ap.add_argument("verb",
                    choices=("submit", "status", "list", "cancel",
                             "result", "wait"))
    ap.add_argument("--addr", required=True,
                    help="front-end (or replica) host:port")
    ap.add_argument("--job", default=None,
                    help="client-chosen job id (idempotency key)")
    ap.add_argument("--op", default="pagerank",
                    help="registered job kind (serve/workloads.JOB_KINDS)")
    ap.add_argument("--param", action="append", default=[],
                    metavar="K=V",
                    help="job parameter override, repeatable "
                    "(e.g. --param nodes=8192 --param iters=96)")
    ap.add_argument("--wait-s", type=float, default=120.0,
                    help="wait: give up after this many seconds")
    ap.add_argument("--out", default=None,
                    help="result: write the array here as .npy")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    from .serve import wire
    from .serve.transport import TransportClient

    if args.verb != "list" and not args.job:
        print("fleet jobs: --job is required", file=sys.stderr)
        return 2
    params = {}
    for kv in args.param:
        k, sep, v = kv.partition("=")
        if not sep:
            print(f"fleet jobs: bad --param {kv!r} (want K=V)",
                  file=sys.stderr)
            return 2
        params[k] = v

    def show(doc: dict) -> None:
        if args.as_json:
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            job = doc.get("job")
            if isinstance(job, dict):
                print(f"job {job['job']}: {job['state']} "
                      f"epoch {job['epoch']}/{job['total_epochs']} "
                      f"iters {job['iters']}/{job['total_iters']} "
                      f"residual {job.get('residual')} "
                      f"resumes {job['resumes']} "
                      f"preemptions {job['preemptions']}")
            else:
                print(json.dumps(doc, sort_keys=True))

    with TransportClient(args.addr, timeout_s=30.0) as c:
        if args.verb == "submit":
            reply = c.control("job-submit", job=args.job, op=args.op,
                              params=params)
        elif args.verb == "status":
            reply = c.control("job-status", job=args.job)
        elif args.verb == "list":
            reply = c.control("job-list")
            if reply.get("ok") and not args.as_json:
                for job in reply.get("jobs", []):
                    print(f"{job['job']:24s} {job['op']:10s} "
                          f"{job['state']:10s} "
                          f"epoch {job['epoch']}/{job['total_epochs']}")
                return 0
        elif args.verb == "cancel":
            reply = c.control("job-cancel", job=args.job)
        elif args.verb == "wait":
            deadline = time.monotonic() + args.wait_s
            reply = {"ok": False, "error": "wait timeout"}
            while time.monotonic() < deadline:
                reply = c.control("job-status", job=args.job)
                state = (reply.get("job") or {}).get("state")
                if state in ("DONE", "FAILED", "STALLED"):
                    break
                time.sleep(0.25)
            else:
                show(reply)
                return 1
        else:  # result
            reply = c.control("job-result", job=args.job)
            if reply.get("ok"):
                value = wire.nd_b64_decode(reply.pop("value"))
                if args.out:
                    import numpy as np

                    np.save(args.out, value)
                    reply["saved"] = args.out
                reply["shape"] = list(value.shape)
                reply["dtype"] = str(value.dtype)
    show(reply)
    if not reply.get("ok"):
        return 1
    if args.verb == "wait":
        return 0 if (reply.get("job") or {}).get("state") == "DONE" else 1
    return 0


def main(argv: list[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m cme213_tpu_torch fleet <up|worker|jobs> "
              "[args...]\n\n"
              "subcommands:\n"
              "  up      spawn N supervised server replicas behind a "
              "tenant-fair socket front end\n"
              "  worker  one replica process (spawned by `up`)\n"
              "  jobs    submit/inspect durable long jobs on a running "
              "fleet (submit|status|list|cancel|result|wait)")
        return 0 if argv else 2
    if argv[0] == "up":
        return _up_main(argv[1:])
    if argv[0] == "worker":
        from .serve.fleet import worker_main

        return worker_main(argv[1:])
    if argv[0] == "jobs":
        return _jobs_main(argv[1:])
    print(f"fleet: unknown subcommand {argv[0]!r} (try up | worker | jobs)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
