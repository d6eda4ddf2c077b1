"""Workload adapters: how each solver batches, buckets, and degrades.

Counterpart of ``cme213_tpu/serve/workloads.py``.  The request population
is the paper's hw workload mix (heat grids, hw2/hw5; SpMV-scan problems,
hw_final; shift ciphers, hw1; key sorts, hw4), and each adapter maps its
payload type onto the serving layer's four needs:

- **shape-class keying** (``shape_class``): requests whose batched solve
  would be the same program share a bucket: spmv by canonical ``n``
  bucket and iterations, heat by grid shape, order and iterations, cipher
  and sort by length.  Spmv sizes are always snapped to their power-of-two
  bucket (``core/programs.canonical_size``; requests are zero-padded with
  a quarantined tail segment, ``apps.spmv_scan.pad_problem``, and outputs
  sliced back), and each (bucket, rung, device) is probed once
  (``apps.spmv_scan._bucket_gate``: padded-then-sliced bitwise the
  unpadded solve) before it serves.  Heat, cipher and sort classes are
  exact.
- **batched execution** (``run_batch``): all payloads of one bucket run as
  ONE stacked solve on the server's device through the apps' batched entry
  points, each lane bitwise its serial solve; the results come back as
  numpy, copied off the device once a batch.
- **rung ladders** (``rungs``): the candidates ``with_fallback`` walks,
  per mode.  The rungs are the JAX package's, all plain torch: it serves
  XLA programs only (no Pallas kernel batches), so no hand-written kernel
  lies on this path.
- **admission preflight** (``preflight_builder``): a ``size -> Decision``
  closure for ``core/admission.admit_batch`` when a memory budget is set.
  Torch has no compiled program to analyse, so each adapter counts the
  batch's device bytes from its code (heat: ``ops.stencil.
  run_heat_bytes``; spmv: ``apps.spmv_scan.spmv_chunk_bytes``; sort: the
  radix one-hot, ``ops.sort.radix_peak_bytes``), times the width.

The device reaches every adapter explicitly, a ``device=`` keyword of
``run_batch`` and ``preflight_builder`` (the server passes its own);
``None`` means ``cuda``, and with no card that raises ``FrameworkError``
(:func:`serving_device`).  ``StubAdapter`` imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _next_pow2(n: int) -> int:
    from ..core.programs import canonical_size

    return canonical_size(n)


def serving_device(device=None):
    """The ``torch.device`` a serving entry point runs on: ``device`` if
    given, else ``cuda``; with no card and no ``device``, a
    ``FrameworkError`` (the CPU only when asked for)."""
    from ..core.errors import FrameworkError
    from ..core.platform import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise FrameworkError(f"serve: {e}") from None


@dataclass
class CipherRequest:
    """A shift-cipher solve: encrypt/decrypt ``text`` by ``shift``."""

    text: np.ndarray        # (n,) uint8
    shift: int


class SpmvAdapter:
    """``apps.spmv_scan.Problem`` payloads; the torch scan rungs only, as
    the JAX package serves its XLA scans only (serving wants predictable
    latency, and a kernel rung does not stack)."""

    op = "spmv_scan"

    def shape_class(self, prob, coarse: bool = False) -> str:
        # always the canonical power-of-two bucket: near-sized requests
        # share one cached program whatever the serving mode; degraded
        # mode differs only in its rung ladder
        return f"n{_next_pow2(prob.n)}/i{prob.iters}"

    def rungs(self, degraded: bool = False) -> tuple[str, ...]:
        # blocked is the O(n) throughput rung; flat is the bitwise-stable
        # reference every other rung is conformance-checked against, so
        # degraded mode serves from it alone
        return ("flat",) if degraded else ("blocked", "flat")

    def run_batch(self, probs, rung: str, coarse: bool = False,
                  device=None):
        import torch

        from ..apps.spmv_scan import (_bucket_gate, pad_problem,
                                      run_spmv_scan_batched)

        dev = serving_device(device)
        ns = [p.n for p in probs]
        n_to = _next_pow2(max(ns))
        if any(n != n_to for n in ns):
            # one probe per (bucket, rung, device): padded-then-sliced must
            # be bitwise the unpadded solve before the bucket serves.  A
            # failing probe raises so the ladder demotes to a rung whose
            # padding IS exact instead of serving silently wrong prefixes.
            if not _bucket_gate(n_to, rung, torch.float32, dev):
                raise RuntimeError(
                    f"pad-and-mask probe failed for bucket n{n_to} on "
                    f"rung {rung!r}")
            probs = [pad_problem(p, n_to) for p in probs]
        outs = run_spmv_scan_batched(list(probs), kernel=rung, device=dev)
        return [o[:n] for n, o in zip(ns, outs)]

    def preflight_builder(self, probs, rung: str, coarse: bool = False,
                          device=None):
        from ..apps.spmv_scan import spmv_chunk_bytes
        from ..core import admission

        dev = serving_device(device)
        n = _next_pow2(max(p.n for p in probs))
        # the padded tail is one more segment
        p = max(p.p for p in probs) + 1
        lane = spmv_chunk_bytes(n, p, 4, rung)

        def preflight_at(size: int) -> admission.Decision:
            return admission.preflight(f"serve.{self.op}", size * lane, dev)

        return preflight_at


class HeatAdapter:
    """``config.SimParams`` payloads: the initial grid is derived from the
    params as the reference's heat program built it, and CFL factors ride as
    per-lane scalars (so requests need not share diffusivity to share a
    bucket)."""

    op = "heat"

    def shape_class(self, params, coarse: bool = False) -> str:
        return f"{params.gy}x{params.gx}/order{params.order}/i{params.iters}"

    def rungs(self, degraded: bool = False) -> tuple[str, ...]:
        # one conformant rung, the JAX package's: the plain stencil
        # (``xla`` there); batching the heat kernels is not this layer's
        return ("xla",)

    def run_batch(self, params_list, rung: str, coarse: bool = False,
                  device=None):
        from ..apps.heat2d import run_heat_batched
        from ..grid import make_initial_grid

        if rung != "xla":
            raise ValueError(f"unknown heat rung {rung!r}")
        dev = serving_device(device)
        p0 = params_list[0]
        grids = [make_initial_grid(p, device=dev) for p in params_list]
        return run_heat_batched(grids, p0.iters, p0.order,
                                [p.xcfl for p in params_list],
                                [p.ycfl for p in params_list], device=dev)

    def preflight_builder(self, params_list, rung: str,
                          coarse: bool = False, device=None):
        from ..core import admission
        from ..ops.stencil import run_heat_bytes

        dev = serving_device(device)
        p0 = params_list[0]
        # the stacked solve's bytes, and the lanes' initial grids beside it
        lane = run_heat_bytes(p0.gy, p0.gx, p0.order, 4) + 4 * p0.gy * p0.gx

        def preflight_at(size: int) -> admission.Decision:
            return admission.preflight(f"serve.{self.op}", size * lane, dev)

        return preflight_at


class CipherAdapter:
    """:class:`CipherRequest` payloads.  Two bitwise-identical rungs:
    ``packed`` (4 bytes a lane, the reference's uint kernel) and ``bytes``
    (plain per-byte), which is what makes this op the breaker
    demonstration: a ``fail:serve.cipher.packed``-injected rung opens its
    circuit and the ``bytes`` rung serves bitwise-equal results."""

    op = "cipher"

    def shape_class(self, req: CipherRequest, coarse: bool = False) -> str:
        return f"n{req.text.shape[0]}/u8"

    def rungs(self, degraded: bool = False) -> tuple[str, ...]:
        return ("packed", "bytes")

    def run_batch(self, reqs, rung: str, coarse: bool = False,
                  device=None):
        import torch

        from ..core import check_op, programs, span
        from ..ops.elementwise import (
            shift_cipher_batched,
            shift_cipher_packed_batched,
        )

        if rung == "packed":
            kernel_fn = shift_cipher_packed_batched
        elif rung == "bytes":
            kernel_fn = shift_cipher_batched
        else:
            raise ValueError(f"unknown cipher rung {rung!r}")
        dev = serving_device(device)
        b, n = len(reqs), int(reqs[0].text.shape[0])
        shape_class = f"n{n}/u8/b{b}"

        def warm(fn):
            check_op(f"cipher_batched.{rung}",
                     fn(torch.zeros((b, n), dtype=torch.uint8, device=dev),
                        torch.zeros((b,), dtype=torch.int32)))

        runner = programs.get("cipher_batched", rung, shape_class,
                              lambda: kernel_fn, dtype="u8", device=dev,
                              warm=warm, batch=b)
        data = torch.from_numpy(np.stack([r.text for r in reqs])).to(dev)
        shifts = torch.from_numpy(np.array([r.shift for r in reqs],
                                           dtype=np.int32))
        with span("cipher_batched.run", kernel=rung,
                  shape_class=shape_class) as sp:
            out = runner(data, shifts)
            sp.block(out)
        out = out.cpu().numpy()
        return [out[i] for i in range(len(reqs))]

    def preflight_builder(self, reqs, rung: str, coarse: bool = False,
                          device=None):
        return None  # bytes in ≈ bytes out: admission adds nothing here


def _sort_gate(n: int, rung: str, device=None) -> bool:
    """One verdict per (bucket, rung, device): prove the device sort
    matches the host ``np.sort`` golden bitwise before the bucket serves,
    hw4's offline checker (``radixsort.cpp``'s host compare) made an
    in-path gate.  Probe keys are fixed-seed, so the verdict is
    deterministic and cacheable (``CME213_CONFORMANCE_CACHE``)."""
    from ..core import conformance
    from ..core.platform import build_identity

    dev = serving_device(device)
    probe = np.random.default_rng(99).integers(
        0, 2**32, size=n, dtype=np.uint32)
    return conformance.check(
        "serve.sort", rung, shape_class=f"n{n}/u32/{build_identity(dev)}",
        candidate=lambda: _sort_one(probe, rung, dev),
        reference=lambda: np.sort(probe)).ok


def _sort_one(keys: np.ndarray, rung: str, device=None) -> np.ndarray:
    """One unbatched solve on the named rung (gate probes, references)."""
    import torch

    from ..ops.sort import bitonic_sort, radix_sort, sort as lib_sort

    dev = serving_device(device)
    x = torch.from_numpy(np.ascontiguousarray(keys, np.uint32)).to(dev)
    if rung == "lax":
        out = lib_sort(x)
    elif rung == "radix":
        out = radix_sort(x, block_size=_sort_block(int(x.shape[0])))
    elif rung == "bitonic":
        out = bitonic_sort(x)
    else:
        raise ValueError(f"unknown sort rung {rung!r}")
    return out.cpu().numpy()


def _sort_block(n: int) -> int:
    # serving sizes are far below the CLI's 8192 default; a block the
    # size of the (padded) input keeps the one-hot affordable without
    # changing the 4-phase structure
    return min(8192, max(256, n))


def _sort_batched(rung: str, n: int):
    """The (B, n) uint32 -> (B, n) uint32 solve of one sort rung: the
    library sort along rows on the int64 carry, or the batched radix and
    bitonic sorts (``ops/sort.py``), where the JAX package ``vmap``s its
    1-D sorts."""
    import torch

    from ..ops.sort import bitonic_sort_batched, radix_sort_batched

    if rung == "lax":
        return lambda x: torch.sort(x.to(torch.int64), dim=1,
                                    stable=True).values.to(x.dtype)
    if rung == "radix":
        return lambda x: radix_sort_batched(x, block_size=_sort_block(n))
    if rung == "bitonic":
        return bitonic_sort_batched
    raise ValueError(f"unknown sort rung {rung!r}")


class SortAdapter:
    """``np.ndarray`` uint32 key payloads over the hw4 sort pipelines
    (``ops/sort.py``).  Three bitwise-identical rungs: ``lax`` (the
    library sort, the JAX package's name; single-lane batches dispatch
    through ``ops.sort.sort_auto`` so a tuned winner serves), ``radix``
    (the 4-phase LSD passes) and ``bitonic`` (the merge network), each
    gated once per (bucket, rung, device) against the host ``np.sort``
    golden before it serves (:func:`_sort_gate`).  Sorted uint32 keys are
    unique per input whatever the kernel, so every rung is
    bitwise-substitutable."""

    op = "sort"

    def shape_class(self, keys, coarse: bool = False) -> str:
        return f"n{int(np.asarray(keys).shape[0])}/u32"

    def rungs(self, degraded: bool = False) -> tuple[str, ...]:
        return ("lax",) if degraded else ("lax", "radix", "bitonic")

    def run_batch(self, payloads, rung: str, coarse: bool = False,
                  device=None):
        import torch

        from ..core import check_op, programs, span
        from ..ops.sort import sort_auto

        dev = serving_device(device)
        n = int(np.asarray(payloads[0]).shape[0])
        if not _sort_gate(n, rung, dev):
            raise RuntimeError(
                f"np.sort golden probe failed for sort bucket n{n} on "
                f"rung {rung!r}")
        b = len(payloads)
        if rung == "lax" and b == 1:
            # a single lane rides the tuned dispatch (ops.sort.sort_auto):
            # a `tune run` winner serves here, and the golden gate above
            # holds whatever kernel it picked to bitwise np.sort
            out = sort_auto(torch.from_numpy(
                np.ascontiguousarray(payloads[0], np.uint32)).to(dev))
            return [out.cpu().numpy()]
        kernel_fn = _sort_batched(rung, n)
        shape_class = f"n{n}/u32/b{b}"

        def warm(fn):
            check_op(f"sort_batched.{rung}",
                     fn(torch.zeros((b, n), dtype=torch.int64,
                                    device=dev).to(torch.uint32)))

        runner = programs.get("sort_batched", rung, shape_class,
                              lambda: kernel_fn, dtype="u32", device=dev,
                              warm=warm, batch=b)
        data = torch.from_numpy(np.stack([np.asarray(p, np.uint32)
                                          for p in payloads])).to(dev)
        with span("sort_batched.run", kernel=rung,
                  shape_class=shape_class) as sp:
            out = runner(data)
            sp.block(out)
        out = out.cpu().numpy()
        return [out[i] for i in range(b)]

    def preflight_builder(self, payloads, rung: str, coarse: bool = False,
                          device=None):
        """Bytes a lane, counted from the code: the radix rung's one-hot
        peak (``ops.sort.radix_peak_bytes``), else the int64 carry and the
        sort's output and indices beside the uint32 keys in and out."""
        from ..core import admission
        from ..ops.sort import radix_peak_bytes

        dev = serving_device(device)
        n = int(np.asarray(payloads[0]).shape[0])
        if rung == "radix":
            lane = radix_peak_bytes(n, block_size=_sort_block(n))
        else:
            m = _next_pow2(n) if rung == "bitonic" else n
            lane = 8 + 4 * n + 3 * 8 * m

        def preflight_at(size: int) -> admission.Decision:
            return admission.preflight(f"serve.{self.op}", size * lane, dev)

        return preflight_at


class StubAdapter:
    """``np.ndarray`` payloads echoed back untouched, no torch anywhere on
    the path.  This is the transport's honest-measurement op: with the
    solve stubbed out, a closed-loop loadgen run measures exactly what the
    wire + queue + batcher cost a request, and any device time would only
    hide transport regressions."""

    op = "stub"

    def shape_class(self, arr: np.ndarray, coarse: bool = False) -> str:
        return f"n{int(np.asarray(arr).size)}"

    def rungs(self, degraded: bool = False) -> tuple[str, ...]:
        return ("echo",)

    def run_batch(self, payloads, rung: str, coarse: bool = False,
                  device=None):
        if rung != "echo":
            raise ValueError(f"unknown stub rung {rung!r}")
        return [np.asarray(p) for p in payloads]

    def preflight_builder(self, payloads, rung: str, coarse: bool = False,
                          device=None):
        return None


#: the default adapter registry: the hw workload mix as request types
ADAPTERS = {a.op: a for a in (SpmvAdapter(), HeatAdapter(),
                              CipherAdapter(), SortAdapter(),
                              StubAdapter())}


# ---------------------------------------------------------------- job kinds
#
# Long-job kinds are the batch-queue analog of the adapters above: where
# an adapter maps a *request payload* onto one batched solve, a job kind
# maps a *job record's params* onto a checkpointable solve the executor
# (serve/jobs.py) drives one epoch at a time.  The contract:
#   normalize(params) -> validated param dict (what the record stores)
#   totals(params)    -> (total_iters, epoch_iters, total_epochs)
#   make(params, device) -> (state0, step_fn) for run_with_checkpoints
#   tracker(params, job) -> ConvergenceTracker (stall policy + job tag)
#   finalize(state)   -> np.ndarray result to persist
#   reference(params) -> host-golden result for conformance checks

class PageRankJob:
    """hw1's PageRank power iteration as a durable long job: the solve the
    reference queued through Torque ``qsub`` (``jobs/``), now submitted
    over the serving wire and chunked into epochs through
    ``apps/pagerank.py``'s checkpointed step."""

    op = "pagerank"

    _DEFAULTS = {"nodes": 4096, "avg_edges": 8, "iters": 48, "epoch": 8,
                 "seed": 0, "stall_epochs": 25, "tol": 0.0}

    @classmethod
    def normalize(cls, params: dict) -> dict:
        p = dict(cls._DEFAULTS)
        unknown = set(params) - set(p)
        if unknown:
            raise ValueError(f"unknown pagerank job params {sorted(unknown)}"
                             f" (have: {sorted(p)})")
        p.update(params)
        for k in ("nodes", "avg_edges", "iters", "epoch", "seed",
                  "stall_epochs"):
            p[k] = int(p[k])
        p["tol"] = float(p["tol"])
        if p["nodes"] < 2 or p["avg_edges"] < 1:
            raise ValueError("pagerank job needs nodes >= 2, avg_edges >= 1")
        # the reference iterates in even pairs (pagerank.cu:61,127); an
        # even epoch keeps every chunk on the fused even-iteration loop
        if p["iters"] < 2 or p["iters"] % 2:
            raise ValueError(f"iters must be even and >= 2, got {p['iters']}")
        if p["epoch"] < 2 or p["epoch"] % 2:
            raise ValueError(f"epoch must be even and >= 2, got {p['epoch']}")
        return p

    @staticmethod
    def totals(p: dict) -> tuple[int, int, int]:
        total, epoch = p["iters"], min(p["epoch"], p["iters"])
        return total, epoch, -(-total // epoch)

    @staticmethod
    def make(p: dict, device=None):
        from ..apps.pagerank import build_graph, pagerank_step

        graph = build_graph(p["nodes"], p["avg_edges"], p["seed"])
        return pagerank_step(graph, serving_device(device))

    @staticmethod
    def tracker(p: dict, job: str):
        from ..core.numerics import ConvergenceTracker

        return ConvergenceTracker("job.pagerank",
                                  stall_epochs=p["stall_epochs"], job=job)

    @staticmethod
    def finalize(state) -> np.ndarray:
        from ..core.numerics import host_array

        return host_array(state)

    @staticmethod
    def reference(p: dict) -> np.ndarray:
        from ..apps.pagerank import build_graph
        from ..verify import golden

        g = build_graph(p["nodes"], p["avg_edges"], p["seed"])
        return golden.host_graph_iterate(g.indices, g.edges, g.rank0,
                                         g.inv_deg, p["iters"])


#: registered long-job kinds (serve/jobs.py executes these)
JOB_KINDS = {PageRankJob.op: PageRankJob}
