"""Multi-process start-up — the ``mpirun -np`` / PBS layer.

Counterpart of ``cme213_tpu/dist/multihost.py``.  The reference launches
distributed runs with ``mpirun -np N`` under Torque/PBS
(``hw/hw5/PA5_Handout.pdf`` §4); the JAX package joins N processes with
``jax.distributed.initialize``.  Here each process joins a
``torch.distributed`` process group, and every mesh of ``dist/mesh.py``
spans the gang: rank r holds the shards it owns, in the "fill each node
first" order (rank-major), and halos, scan carries and gathers cross ranks
through the group.

The backend is gloo in every gang (``BACKEND``), chosen here once and never
changed on a failure.  gloo's point-to-point and collective ops take CPU
tensors, so a slab on a card is staged through a host buffer
(``dist/halo.py``); NCCL refuses two ranks on one card.

Arguments default from torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), which ``dist/launch.py``
exports.  Importing this module does not import ``torch``.
"""

from __future__ import annotations

import os

#: the process group's backend in every gang
BACKEND = "gloo"
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


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join the gang's process group (a no-op at world size 1, or when this
    process has joined already).

    ``coordinator_address`` (``host:port``) defaults to
    ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE`` and
    ``process_id`` to ``RANK``, as ranks come from an MPI launcher's
    environment.  ``CME213_HANDSHAKE_TIMEOUT`` (seconds) becomes the
    group's timeout: the rendezvous, and every later exchange, fails after
    it instead of torch's 30-minute default, so a rank whose peer never
    appears exits and can be restarted.
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
    kwargs = {}
    deadline = os.environ.get(HANDSHAKE_TIMEOUT_ENV)
    if deadline:
        from datetime import timedelta

        kwargs["timeout"] = timedelta(seconds=max(1, int(float(deadline))))
    dist.init_process_group(BACKEND, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    print(f"rank {process_id}/{num_processes}: torch.distributed backend "
          f"{BACKEND}, coordinator {coordinator_address}", flush=True)


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
    (``flag`` itself outside a gang).  Every rank must call it."""
    rank, world = process_info()
    if world == 1:
        return bool(flag)
    import torch
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


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
