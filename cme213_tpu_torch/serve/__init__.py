"""Multi-tenant serving front end over the solver stack.

Counterpart of ``cme213_tpu/serve``.  The paper's solvers assume one
caller with one problem; this package puts a front door on them that stays
up under many callers: a bounded request queue, shape-class batching
(same-class solves stacked into one solve on the device), per-request
deadlines, memory-budget admission, a per-(op, rung) circuit breaker over
the fallback ladders, and graceful degradation under pressure, every
refusal structured and every mode shift visible in ``trace summary``.

Beyond the in-process server, ``transport.py`` adds a concurrent socket
front end (v1 JSON frames and the v2 binary frames of ``wire.py``, with a
shared-memory lane, ``shm.py``), ``jobs.py`` a durable long-job lane, and
``loadgen.py`` / ``warmup.py`` the CLIs (``python -m cme213_tpu_torch
serve loadgen|warmup``).  The replicated fleet (the JAX package's
``router.py`` and ``fleet.py``) is not ported yet (ROADMAP.md, queue A,
item 7b).  Public names resolve on first access (PEP 562), so ``import
cme213_tpu_torch.serve`` imports neither torch nor sockets.
"""

from importlib import import_module

#: public name -> the submodule that defines it
_NAMES = {
    "ADMISSION": "request", "DEADLINE": "request", "FAILED": "request",
    "OK": "request", "PHASES": "request", "QUEUE_FULL": "request",
    "SHED": "request", "RequestSpec": "request", "SolveRequest": "request",
    "SolveResult": "request",
    "BoundedQueue": "server", "Server": "server",
    "tuned_batch_cap": "server",
    "Objective": "slo", "SLOMonitor": "slo",
    "ADAPTERS": "workloads", "CipherRequest": "workloads",
}

__all__ = sorted(_NAMES)


def __getattr__(name: str):
    if name in _NAMES:
        return getattr(import_module(f".{_NAMES[name]}", __name__), name)
    try:  # a submodule, imported on first access
        return import_module(f".{name}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))


def main(argv: list[str]) -> int:
    """``python -m cme213_tpu_torch serve <subcommand>`` dispatcher."""
    import sys

    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m cme213_tpu_torch serve <loadgen|warmup> "
              "[args...]\n\n"
              "subcommands:\n"
              "  loadgen   drive the server with synthetic load and print "
              "an SLO report\n"
              "  warmup    pre-compile the canonical serving buckets "
              "(into the program cache and the conformance verdicts; "
              "CME213_COMPILE_CACHE does not apply to eager torch)\n\n"
              "loadgen --transport HOST:PORT drives a socket front end "
              "(a TransportServer of either package) with real concurrent "
              "client threads")
        return 0 if argv else 2
    if argv[0] == "loadgen":
        from . import loadgen

        return loadgen.main(argv[1:])
    if argv[0] == "warmup":
        from . import warmup

        return warmup.main(argv[1:])
    print(f"serve: unknown subcommand {argv[0]!r} (try loadgen | warmup)",
          file=sys.stderr)
    return 2
