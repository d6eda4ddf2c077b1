"""Multi-process start-up — the ``mpirun -np`` / PBS layer.

Counterpart of ``cme213_tpu/dist/multihost.py``.  The reference launches
distributed runs with ``mpirun -np N`` under Torque/PBS
(``hw/hw5/PA5_Handout.pdf`` §4); the JAX package joins N processes with
``jax.distributed.initialize``.  Here each process joins a
``torch.distributed`` process group, and every mesh of ``dist/mesh.py``
spans the gang: rank r holds the shards it owns, in the "fill each node
first" order (rank-major), and halos, scan carries and gathers cross ranks
through the group.

**The backend comes from the gang's layout** (``choose_backend``), once,
before ``init_process_group``, and is never changed on a failure:

- ``nccl`` when the gang runs on CUDA and every rank's shards lie on a card
  no other rank uses: world ≤ ``torch.cuda.device_count()`` and rank r on
  ``cuda:r``, as ``mesh.default_devices`` maps it (with any
  ``--devices-per-proc``).  Slabs and gathers then go card to card.
- ``gloo`` otherwise: ranks that share a card (NCCL refuses two ranks on
  one card), a device named with its index, or the CPU.  gloo's ops take
  CPU tensors, so a slab on a card is staged through a host buffer
  (``dist/halo.py``).

Each rank makes the choice itself, from the device its entry point runs
on: the launcher cannot see where a rank's shards will lie.
``CME213_DIST_BACKEND=gloo`` (``dist.launch --backend gloo``) asks for
gloo where the layout allows ``nccl``; ``auto``, the default, takes the
layout's choice.  An NCCL rank sets its card before the group forms
(``torch.cuda.set_device`` and ``device_id=``), and an NCCL start-up that
fails raises ``FrameworkError``: the gang never re-forms on gloo.

Under NCCL the control traffic (``all_true``'s agreed verdicts,
``barrier``) runs on a gloo side group made at start-up (``control``).
Those values are host booleans: on the side group they cost no copy to
the card, no kernel and no synchronising copy back, and a vote never
queues behind the card's work on NCCL's stream.

Arguments default from torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), which ``dist/launch.py``
exports.  Importing this module does not import ``torch``.
"""

from __future__ import annotations

import contextlib
import os

#: the backend a gang asks for: ``auto`` (the layout's choice, the
#: default) or ``gloo`` (``dist.launch --backend``)
BACKEND_ENV = "CME213_DIST_BACKEND"
#: the backends ``CME213_DIST_BACKEND`` may name
BACKENDS = ("auto", "gloo")
#: the message ``torch.distributed`` raises when it was built without
#: distributed support — a missing capability, not a bug in the workload
MULTIPROCESS_UNSUPPORTED_MSG = "torch.distributed is not available"
#: shards a rank holds on its own device (``dist.launch --devices-per-proc``)
DEVICES_PER_PROC_ENV = "CME213_DEVICES_PER_PROC"
#: the process group's timeout in seconds (``dist.launch
#: --handshake-timeout``)
HANDSHAKE_TIMEOUT_ENV = "CME213_HANDSHAKE_TIMEOUT"


def multiprocess_unsupported(output: str) -> bool:
    """True iff captured worker output shows this torch build's missing
    distributed capability (skip-worthy); False for every other failure
    (hard-fail-worthy)."""
    return MULTIPROCESS_UNSUPPORTED_MSG in output


#: this process's gang: the backend it joined with and, under NCCL, the
#: gloo side group of the control traffic
_GANG: dict = {"backend": None, "control": None}


def choose_backend(world: int, device=None, device_count: int = 0) -> str:
    """The backend of a gang of ``world`` ranks whose entry points run on
    ``device`` (``None``: the entry points' default, ``cuda``, when the
    host has a card) on a host with ``device_count`` cards: ``nccl`` when
    each rank gets a card of its own (rank r on ``cuda:r``), else
    ``gloo``."""
    if device is None:
        device = "cuda" if device_count else "cpu"
    kind, _, index = str(device).partition(":")
    if kind != "cuda" or index or world > device_count:
        return "gloo"
    return "nccl"


def resolve_backend(world: int, device=None, asked: str | None = None
                    ) -> str:
    """The backend this gang joins with: ``choose_backend`` over this
    host's cards, or ``gloo`` where ``asked`` (default
    ``CME213_DIST_BACKEND``) names it.  Raises ``ValueError`` for a name
    outside ``BACKENDS``."""
    if asked is None:
        asked = os.environ.get(BACKEND_ENV, "").strip() or "auto"
    if asked not in BACKENDS:
        raise ValueError(f"{BACKEND_ENV}={asked!r}: expected one of "
                         f"{', '.join(BACKENDS)}")
    if asked == "gloo":
        return "gloo"
    count = 0
    if str(device or "cuda").startswith("cuda"):
        import torch

        count = torch.cuda.device_count()
    return choose_backend(world, device, count)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device=None) -> None:
    """Join the gang's process group (a no-op at world size 1, or when this
    process has joined already).

    ``coordinator_address`` (``host:port``) defaults to
    ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE`` and
    ``process_id`` to ``RANK``, as ranks come from an MPI launcher's
    environment; ``device`` is the one the entry point runs on (its
    ``--device``; ``None`` for the default), from which, with the host's
    cards, the backend is chosen (``resolve_backend``) and named in the
    start line.
    ``CME213_HANDSHAKE_TIMEOUT`` (seconds) becomes the group's timeout:
    the rendezvous, and every later exchange, fails after it instead of
    torch's 30-minute default, so a rank whose peer never appears exits
    and can be restarted.  Under NCCL the rank's card is set first, the
    control side group is made, and one all-reduce over every rank forms
    the communicator before any exchange that only some ranks join; a
    failure there raises ``FrameworkError``.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError(MULTIPROCESS_UNSUPPORTED_MSG)
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                               f":{os.environ['MASTER_PORT']}")
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    chosen = resolve_backend(num_processes, device)
    kwargs = {}
    deadline = os.environ.get(HANDSHAKE_TIMEOUT_ENV)
    if deadline:
        from datetime import timedelta

        kwargs["timeout"] = timedelta(seconds=max(1, int(float(deadline))))
    if chosen == "nccl":
        _join_nccl(f"tcp://{coordinator_address}", num_processes, process_id,
                   kwargs)
    else:
        dist.init_process_group(chosen,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                **kwargs)
    _GANG["backend"] = chosen
    print(f"rank {process_id}/{num_processes}: torch.distributed backend "
          f"{chosen}, coordinator {coordinator_address}", flush=True)


def _join_nccl(init_method: str, world: int, rank: int, kwargs: dict) -> None:
    """The NCCL start-up of rank ``rank``: its card, the group, the gloo
    side group, one all-reduce over every rank; ``FrameworkError`` on any
    failure."""
    import atexit

    import torch
    import torch.distributed as dist

    from ..core.errors import FrameworkError

    card = torch.device("cuda", rank)
    try:
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=world, rank=rank, device_id=card,
                                **kwargs)
        _GANG["control"] = dist.new_group(backend="gloo")
        probe = torch.ones(1, device=card)
        dist.all_reduce(probe)
        if int(probe.item()) != world:
            raise RuntimeError(f"all-reduce of ones gave {probe.item()}")
    except Exception as e:
        raise FrameworkError(f"rank {rank}/{world}: NCCL start-up on {card} "
                             f"failed: {type(e).__name__}: {e}") from e
    # an NCCL group left to the interpreter's teardown may outlive its
    # watchdog; a finished rank releases it itself
    atexit.register(_leave)


def _leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def backend() -> str | None:
    """The backend this process's gang joined with (``None`` outside a
    gang)."""
    return _GANG["backend"]


def control():
    """The process group of control traffic: the gloo side group under
    NCCL, else the default group (``None``)."""
    return _GANG["control"]


@contextlib.contextmanager
def collective(what: str):
    """Run a cross-rank ``what``; under NCCL a failure inside raises
    ``FrameworkError`` (the rank exits non-zero, and the gang is never
    re-formed on gloo), otherwise it propagates as it is."""
    try:
        yield
    except Exception as e:
        if backend() != "nccl":
            raise
        from ..core.errors import FrameworkError

        rank, world = process_info()
        raise FrameworkError(f"rank {rank}/{world}: NCCL {what} failed: "
                             f"{type(e).__name__}: {e}") from e


def process_info() -> tuple[int, int]:
    """(rank, world size) — the MPI_Comm_rank/size analog; (0, 1) outside
    a gang."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def devices_per_proc() -> int | None:
    """The shards each rank holds (``CME213_DEVICES_PER_PROC``), or None
    when unset."""
    raw = os.environ.get(DEVICES_PER_PROC_ENV, "").strip()
    return int(raw) if raw else None


def all_true(flag: bool) -> bool:
    """``flag`` agreed over the gang: true iff it is true on every rank
    (``flag`` itself outside a gang), a CPU tensor reduced on the control
    group.  Every rank must call it."""
    rank, world = process_info()
    if world == 1:
        return bool(flag)
    import torch
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=control())
    return bool(t.item())


def barrier() -> None:
    """Every rank of the gang reaches this point (a no-op outside one);
    under NCCL on the control side group."""
    if process_info()[1] > 1:
        import torch.distributed as dist

        dist.barrier(group=control())


def agreed_check(op: str, rung: str, shape_class: str, candidate,
                 reference, **tolerance) -> bool:
    """``core.conformance.check`` with one verdict for the whole gang.

    Each rank probes the same rung on the gang's mesh (the probe solves
    exchange halos, so every rank must run them, or none); the verdict is
    true only if it is true on every rank, so a fault that perturbs one
    rank's probe demotes the rung on all of them and no rank waits in an
    exchange that its peer left.  A verdict cached on some ranks only is
    dropped, and all ranks probe.  Outside a gang this is ``check``."""
    from ..core import conformance

    if not all_true(conformance.cached(op, rung, shape_class)):
        conformance.forget(op, rung, shape_class)
    ok = conformance.check(op, rung, shape_class, candidate=candidate,
                           reference=reference, **tolerance).ok
    return all_true(ok)
