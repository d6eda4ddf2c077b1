"""Headline benchmark of the port: the hw2 2-D heat stencil, order 8,
4000×4000, f32, on the card.

Usage::

    python -m cme213_tpu_torch.bench.headline [--dtype=f32|f64]
        [--device=cuda|cpu]
    python -m cme213_tpu_torch.bench.headline --spmv [--device=cuda|cpu]

Counterpart of the repository's ``bench.py``, the JAX package's headline.
It mirrors the reference's measurement: a hot iteration loop, effective
bandwidth = (1 read + 1 write) × elem × nx × ny per iteration (the
accounting behind ``hw/hw2/programming/data/data.ods``; see BASELINE.md).
Baseline to beat: the shared-memory order-8 kernel at 4000² on a GTX 580,
**23.97 GB/s**.

Prints ONE JSON line, ``{"metric", "value", "unit", "vs_baseline", ...}``,
with roofline context (``pct_hbm_peak``, ``pct_peak``, ``bound``,
``gflops``) from ``core/roofline.py``'s peak for the card it ran on, and a
row per candidate kernel.  The candidates, by the JAX package's names:

- ``xla``: ``ops.stencil.run_heat``, the reference rung;
- ``xla-roll``, ``xla-roll-k8``: ``ops.stencil.run_heat_roll``;
- ``xla-conv``: ``ops.stencil.run_heat_conv`` (``conv2d``, a yardstick);
- ``pipeline-k1/2/4/8``: ``ops.stencil_pipeline.run_heat_pipeline``, the
  hand-written kernel ``csrc/heat_stencil.cu`` at k fused steps;
- ``pipeline2d-k1/k8``: ``run_heat_pipeline2d``, the same kernel at the
  caller's width.

Every candidate runs in its OWN child process (``--run-measurement
--kernel=NAME``) with its own device preflight, so a kernel that poisons
its CUDA context (a sticky launch error) reports a row of its own instead
of failing the candidates after it.  A kernel that cannot be built or
launched becomes its row with ``ok: false``, its error text and its stage
(``core/diag.failure_stage``: ``compile`` for ``nvcc``/``ptxas``,
``execute`` for a launch error); it is never replaced by another tile or
by a plain version.  The parent retries a child only when its preflight
found no device (``core/resilience.RetryPolicy``, one retry after
``CME213_BENCH_RETRY_S`` seconds, default 120), short-circuits the rest
after two such children in a row, and records each failed row as a
``kernel-failure`` event (``CME213_TRACE_FILE``).

Each pipeline candidate runs one tile: the launch plan's
(``stencil_pipeline.pick_pipeline_tile``), or ``BENCH_TILE_Y`` when set
(clamped to a block's shared memory); ``pipeline2d`` runs at
``BENCH_TILE_X`` columns when set.  Each child times a short calibration
run, then sizes the timed run to at most ``_MAX_ITERS`` steps and
``_EXEC_CAP_S`` seconds; the input is uploaded and synchronised before the
host clock starts, and the clock stops after the device synchronises.

With ``--device=cpu`` only ``xla`` runs (on the CPU); the others report
"skipped: not on CUDA".  ``--dtype=f64`` runs ``xla`` only, as the
reference's double rows do.

``--spmv`` instead prints the iterated SpMV-scan engine's row (``flat``,
``blocked``, ``pallas`` = the scan kernel B6, ``pallas-fused`` = B7, from
``bench.sweeps.spmv_scan_sweep`` at n = 2^16, 2^20 and 2^22) as one JSON
line of the same shape.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

BASELINE_GBS = 23.97  # hw2 shared-memory order-8 4000² float (BASELINE.md)

_CHILD_FLAG = "--run-measurement"
_PREFLIGHT_EXIT = 42

#: candidate kernel names (the JAX package's, in its order); each runs in
#: its own child process
KERNELS = ("xla", "pipeline-k4", "pipeline-k2", "pipeline-k8",
           "pipeline2d-k8", "xla-roll-k8", "pipeline-k1", "pipeline2d-k1",
           "xla-roll", "xla-conv")
_EXEC_CAP_S = 30.0
_MAX_ITERS = 400

#: the headline grid: 4000² interior, order 8
SIZE, ORDER = 4000, 8

#: the repository root (the package's parent) and the port's results
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(ROOT, "bench_results_torch")

SKIP_NOT_CUDA = "skipped: not on CUDA"


class DeviceUnreachable(RuntimeError):
    """Preflight watchdog failure — classifies RUNTIME, the one failure
    kind the bench retry policy backs off and retries on."""


def _preflight(seconds: float = 90.0, retry_sleep=None,
               device=None) -> bool:
    """Device-reachability watchdog (``core/platform.device_preflight``),
    retried once through ``core.resilience.RetryPolicy`` so a single
    dropped probe does not fail the whole child."""
    import time as _time

    from ..core.platform import device_preflight
    from ..core.resilience import FailureKind, RetryPolicy

    def probe() -> bool:
        if not device_preflight(seconds, device=device):
            raise DeviceUnreachable(f"no device response in {seconds}s")
        return True

    policy = RetryPolicy(max_retries=1, base_delay_s=5.0, multiplier=1.0,
                         max_delay_s=5.0, retry_on=(FailureKind.RUNTIME,),
                         sleep=retry_sleep or _time.sleep)
    try:
        return policy.run(probe, op="bench.preflight")
    except DeviceUnreachable:
        return False


def _make_candidate(name: str, params, elem: int = 4):
    """Return (fn(u, iters) or [(label, fn)], iters_quantum) for a kernel
    name."""
    from ..ops.stencil import run_heat, run_heat_conv, run_heat_roll

    order = params.order
    if name == "xla":
        return (lambda u, it: run_heat(u, it, order, params.xcfl,
                                       params.ycfl), 1)
    if name == "xla-roll":
        return (lambda u, it: run_heat_roll(u, it, order, params.xcfl,
                                            params.ycfl, params.bc), 1)
    if name.startswith("xla-roll-k"):
        k = int(name.split("-k")[1])
        return (lambda u, it: run_heat_roll(u, it, order, params.xcfl,
                                            params.ycfl, params.bc, k=k), k)
    if name == "xla-conv":
        return (lambda u, it: run_heat_conv(u, it, order, params.xcfl,
                                            params.ycfl), 1)
    if name.startswith("pipeline-k") or name.startswith("pipeline2d-k"):
        k = int(name.split("-k")[1])
        return (_pipeline_candidates(name, params, k, elem), k)
    raise SystemExit(f"unknown kernel {name!r}")


def _pipeline_candidates(name: str, params, k: int, elem: int = 4):
    """The one (label, fn) variant of a pipeline kernel: the launch plan's
    tile height (``pick_pipeline_tile``), or ``BENCH_TILE_Y`` when set
    (clamped to a block's shared memory); ``pipeline2d`` at
    ``BENCH_TILE_X`` columns when set, else its entry point's width.

    One variant, not a ladder: a build or launch failure is the kernel's
    result and must show as its row, not move on to another tile.
    """
    from ..ops.stencil_pipeline import (PIPELINE2D_TILE_BYTES,
                                        PIPELINE_TILE_BYTES,
                                        pick_pipeline_tile,
                                        run_heat_pipeline,
                                        run_heat_pipeline2d)

    order = params.order
    target = os.environ.get("BENCH_TILE_Y")
    if name.startswith("pipeline2d-k"):
        tile_x = int(os.environ.get("BENCH_TILE_X")
                     or PIPELINE2D_TILE_BYTES // elem)
        ty = pick_pipeline_tile(params.gy, k, order,
                                target=int(target) if target else None,
                                tile_x=tile_x, dtype_bytes=elem)
        return [(f"tile_y={ty},tile_x={tile_x}",
                 lambda u, it: run_heat_pipeline2d(
                     u, it, order, params.xcfl, params.ycfl, params.bc,
                     k=k, tile_y=ty, tile_x=tile_x))]
    ty = pick_pipeline_tile(params.gy, k, order,
                            target=int(target) if target else None,
                            tile_x=PIPELINE_TILE_BYTES // elem,
                            dtype_bytes=elem)
    return [(f"tile_y={ty}",
             lambda u, it: run_heat_pipeline(u, it, order, params.xcfl,
                                             params.ycfl, params.bc, k=k,
                                             tile_y=ty))]


def _failure_row(name: str, platform: str, e: BaseException) -> dict:
    from ..core.diag import failure_stage
    from ..core.resilience import classify_failure

    return {"kernel": name, "ok": False, "platform": platform,
            "error": f"{type(e).__name__}: {e}"[:2000],
            "kind": classify_failure(e).value, "stage": failure_stage(e)}


def measure_one(name: str, dtype_name: str, device=None) -> dict:
    """Time one candidate on ``device`` (default ``cuda``) and return its
    row: ms/iter, GB/s, GF/s, ``pct_peak`` and ``bound`` against the card's
    peak, the variant (tile), the iteration counts (two calibration runs
    of ``calibration_iters``, ``final_runs`` of ``iters``) and the kernel
    launches they made (``stencil_pipeline.LAUNCHES``)."""
    import time

    import torch

    from ..config import SimParams
    from ..core import roofline
    from ..core.platform import resolve_device
    from ..grid import make_initial_grid

    dev = resolve_device(device)
    platform = dev.type
    kind = (torch.cuda.get_device_name(dev) if platform == "cuda"
            else platform)
    print(f"device: {dev} ({kind})", file=sys.stderr)
    if platform != "cuda" and name != "xla":
        # the hand-written kernels run on the card only; the plain
        # versions at 4000² on the CPU would measure nothing of them
        return {"kernel": name, "ok": False, "platform": platform,
                "error": SKIP_NOT_CUDA}
    if dtype_name == "f64" and name != "xla":
        # the reference's double rows measure one kernel too
        return {"kernel": name, "ok": False, "platform": platform,
                "error": "skipped: f64 runs xla only"}

    params = SimParams(nx=SIZE, ny=SIZE, order=ORDER, iters=1000)
    dtype = {"f32": torch.float32, "f64": torch.float64}[dtype_name]
    u0 = make_initial_grid(params, dtype=dtype, device="cpu")
    elem = u0.element_size()

    def sync():
        if platform == "cuda":
            torch.cuda.synchronize(dev)

    from ..ops import stencil_pipeline

    before = dict(stencil_pipeline.LAUNCHES)
    try:
        cand, quantum = _make_candidate(name, params, elem)
        label, fn = cand[0] if isinstance(cand, list) else ("", cand)

        def timed(iters: int) -> float:
            # upload and wait for it BEFORE the clock starts, so the copy
            # is not inside the timed region
            u = u0.to(dev)
            sync()
            start = time.perf_counter()
            fn(u, iters)
            sync()
            return time.perf_counter() - start

        # a short calibration run (its first call also builds or loads
        # the kernel), then the timed run sized from it
        iters_cal = 8 * quantum
        timed(iters_cal)
        per_iter = timed(iters_cal) / iters_cal
        iters = max(int(_EXEC_CAP_S / max(per_iter, 1e-9)), iters_cal)
        iters = min(iters - iters % quantum or quantum, _MAX_ITERS)
        warm = iters != iters_cal
        if warm:
            timed(iters)              # warm at the final count
        elapsed = timed(iters)
    except Exception as e:  # noqa: BLE001 — every failure is the row
        return _failure_row(name, platform, e)

    per_iter = elapsed / iters
    launches = {k: v - before[k] for k, v in stencil_pipeline.LAUNCHES.items()
                if v != before[k]}
    cost = roofline.heat_cost(SIZE, SIZE, order=ORDER, iters=1,
                              dtype=dtype_name)
    gbs = round(cost.nbytes / per_iter / 1e9, 2)
    gflops = round(cost.flops / per_iter / 1e9, 2)
    att = roofline.attribute(gbs, gflops, device=kind)
    return {
        "kernel": name, "ok": True, "iters": iters,
        "calibration_iters": iters_cal, "final_runs": 1 + warm,
        "launches": launches,
        "variant": label,
        "platform": platform,
        "device_kind": kind,
        "dtype": dtype_name,
        "ms_per_iter": round(per_iter * 1e3, 4),
        "gbs": gbs,
        "gflops": gflops,
        "pct_peak": att["pct_peak"],
        "bound": att["bound"],
    }


def _attempt_kernel(name: str, dtype_name: str, device=None) -> dict:
    """One child-process measurement attempt.

    Raises :class:`DeviceUnreachable` on a preflight exit (retryable: the
    retry policy backs off and reruns in a new child); returns an error
    row for a timeout (not retryable: a second attempt would do the same
    work again) or any other child failure.
    """
    cmd = [sys.executable, "-m", "cme213_tpu_torch.bench.headline",
           _CHILD_FLAG, f"--kernel={name}", f"--dtype={dtype_name}"]
    if device is not None:
        cmd.append(f"--device={device}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    try:
        proc = subprocess.run(cmd, timeout=900, capture_output=True,
                              text=True, env=env)
    except subprocess.TimeoutExpired:
        return {"kernel": name, "ok": False, "error": "timeout (900s)"}
    sys.stderr.write(proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if lines:
        return json.loads(lines[-1])
    if proc.returncode == _PREFLIGHT_EXIT:
        raise DeviceUnreachable(f"{name}: preflight device unreachable")
    return {"kernel": name, "ok": False,
            "error": f"child exit {proc.returncode}: "
                     f"{proc.stderr.strip()[-500:]}"}


def run_children(dtype_name: str, budget_s: float = 2700.0,
                 retry_sleep=None, device=None) -> list[dict]:
    """Run every candidate in its own subprocess; collect per-kernel rows.

    Per-kernel retry goes through ``core.resilience.RetryPolicy``: one
    retry after a deterministic backoff (``CME213_BENCH_RETRY_S``, default
    120 s), and ONLY on a device-unreachable preflight (RUNTIME) —
    timeouts, child crashes and failed builds or launches are not retried.
    ``retry_sleep`` is injectable so tests never wait the backoff.  Two
    consecutive device-unreachable kernels (or an exhausted budget)
    short-circuit the remaining candidates.
    """
    import time as _time

    from ..core import diag, trace
    from ..core.resilience import FailureKind, RetryPolicy

    retry_s = float(os.environ.get("CME213_BENCH_RETRY_S", "120") or 120)
    policy = RetryPolicy(max_retries=1, base_delay_s=retry_s, multiplier=1.0,
                         max_delay_s=retry_s, retry_on=(FailureKind.RUNTIME,),
                         sleep=retry_sleep or _time.sleep)
    deadline = _time.monotonic() + budget_s
    rows = []
    dead_streak = 0
    platform = None
    kernels = ("xla",) if dtype_name == "f64" else KERNELS
    for name in kernels:
        if platform is not None and platform != "cuda" and name != "xla":
            rows.append({"kernel": name, "ok": False,
                         "error": SKIP_NOT_CUDA})
            continue
        if dead_streak >= 2 or _time.monotonic() > deadline:
            rows.append({"kernel": name, "ok": False,
                         "error": "skipped: device unreachable"
                         if dead_streak >= 2 else "skipped: bench budget"})
            continue
        try:
            row = policy.run(
                lambda: _attempt_kernel(name, dtype_name, device),
                op="bench.heat2d")
        except DeviceUnreachable:
            row = {"kernel": name, "ok": False,
                   "error": "preflight: device unreachable"}
        platform = row.get("platform", platform)
        # only preflight failures mean a dead device; a child timeout is a
        # slow kernel on a live one
        unreachable = (not row.get("ok")
                       and "unreachable" in row.get("error", ""))
        dead_streak = dead_streak + 1 if unreachable else 0
        rows.append(row)
        if not row.get("ok"):
            # the stage the child attributed, else one from the error text
            # (the exception object died with the child)
            trace.record_event(
                "kernel-failure", op="heat2d", kernel=name,
                error=str(row.get("error", ""))[:500],
                stage=row.get("stage")
                or diag.stage_for_message(row.get("error", "")))
        detail = (f"{row['ms_per_iter']} ms/iter, {row['gbs']} GB/s eff, "
                  f"{row['gflops']} GF/s" if row.get("ok")
                  else f"failed ({row.get('error')})")
        print(f"{name}: {detail}", file=sys.stderr)
    return rows


def _banked_rows(dtype_name: str = "f32") -> list[dict]:
    """Card measurements banked from earlier runs: the JSON rows in
    ``bench_results_torch/headline_*.json``.  NOT live numbers — each row
    is tagged with its file.  Only rows measured on a card (platform
    ``cuda``) of the requested dtype are read."""
    out = []
    try:
        names = sorted(os.listdir(RESULTS_DIR))
    except OSError:
        return out
    for fname in names:
        if not (fname.startswith("headline_") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(RESULTS_DIR, fname)) as f:
                row = json.load(f)
        except (OSError, ValueError):
            continue
        if (isinstance(row, dict) and row.get("ok")
                and row.get("platform") == "cuda"
                and row.get("dtype", "f32") == dtype_name):
            out.append({"evidence": f"bench_results_torch/{fname}", **row})
    return out


def _pct_hbm_peak(gbs: float, kind) -> float | None:
    """``gbs`` in percent of the card's memory peak (None off the card)."""
    from ..core import roofline

    peak = roofline.peak_for(kind)
    return round(100 * gbs / peak.gbs, 1) if peak else None


def run_spmv_bench(device=None) -> None:
    """``--spmv``: the iterated SpMV-scan engine's row — ``flat``,
    ``blocked``, ``pallas`` (B6) and ``pallas-fused`` (B7) effective
    bandwidth at the sweep's largest n, as one JSON line with the scan
    kernel's launches (``segmented_pallas.LAUNCHES``).  Runs in-process
    (the sweep turns a kernel's failure into its row)."""
    from ..core import diag, roofline, trace
    from ..core.platform import resolve_device
    from .sweeps import spmv_scan_sweep

    from ..ops import segmented_pallas

    dev = resolve_device(device)
    kind = roofline.detect_device() if dev.type == "cuda" else dev.type
    before = dict(segmented_pallas.LAUNCHES)
    rows = spmv_scan_sweep(device=dev)
    launches = {k: v - before[k]
                for k, v in segmented_pallas.LAUNCHES.items()}
    ok = [r for r in rows if not r.get("error") and r["gbs"] > 0]
    for r in rows:
        if r.get("error"):
            trace.record_event("kernel-failure", op="spmv_scan",
                               kernel=r.get("kernel", "?"),
                               error=str(r["error"])[:500],
                               stage=diag.stage_for_message(r["error"]))
    if not ok:
        print(json.dumps({
            "metric": "spmv_scan iterated segmented-scan effective "
                      "bandwidth (NO MEASUREMENT)",
            "value": 0.0, "unit": "GB/s", "platform": dev.type,
            "device_kind": kind, "launches": launches, "kernels": rows}))
        return
    n_max = max(r["n"] for r in ok)
    best = max((r for r in ok if r["n"] == n_max), key=lambda r: r["gbs"])
    print(json.dumps({
        "metric": f"spmv_scan iterated segmented-scan effective bandwidth "
                  f"at n={n_max} (best kernel: {best['kernel']})",
        "value": best["gbs"], "unit": "GB/s",
        "pct_hbm_peak": _pct_hbm_peak(best["gbs"], kind),
        "pct_peak": best.get("pct_peak"), "bound": best.get("bound"),
        "platform": dev.type, "device_kind": kind, "launches": launches,
        "kernels": rows,
    }))


def _flag(argv, name: str, default):
    return next((a.split("=", 1)[1] for a in argv
                 if a.startswith(f"--{name}=")), default)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = _flag(argv, "device", None)
    if "--spmv" in argv:
        run_spmv_bench(device)
        return 0
    dtype_name = _flag(argv, "dtype", "f32")
    if _CHILD_FLAG in argv:
        kernel = _flag(argv, "kernel", "xla")
        if not _preflight(device=device):
            print("preflight: device unreachable within 90s", file=sys.stderr)
            sys.exit(_PREFLIGHT_EXIT)
        print(json.dumps(measure_one(kernel, dtype_name, device)))
        return 0

    rows = run_children(dtype_name, device=device)
    ok = [r for r in rows if r.get("ok")]
    # rows from older children may predate in-child attribution: fill
    # pct_peak/bound from the card each row names
    from ..core import roofline

    for r in ok:
        if "pct_peak" not in r:
            att = roofline.attribute(r.get("gbs", 0.0), r.get("gflops", 0.0),
                                     device=r.get("device_kind")
                                     or r.get("platform"))
            r["pct_peak"], r["bound"] = att["pct_peak"], att["bound"]
    best = max(ok, key=lambda r: r["gbs"]) if ok else None
    if best is None:
        # value stays 0 (nothing was measured) but the banked card rows
        # are pointed at, and a dead device gets a doctor report
        unreachable = any("unreachable" in str(r.get("error", ""))
                          for r in rows)
        doc = {
            "metric": f"heat2d stencil order-8 4000x4000 {dtype_name} "
                      "effective bandwidth (DEVICE UNAVAILABLE)",
            "value": 0.0, "unit": "GB/s", "vs_baseline": 0.0,
            "kernels": rows,
            "banked_device_rows": _banked_rows(dtype_name),
        }
        if unreachable:
            # the parent's own view of the device, in-process
            try:
                from ..core import diag

                doc["doctor"] = diag.health_report(device=device)
            except Exception as e:  # noqa: BLE001 — the tail must print
                doc["doctor"] = {"error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps(doc, default=str))
        # nonzero on a dead device; the JSON above still says everything
        return 1 if unreachable else 0
    print(json.dumps({
        "metric": f"heat2d stencil order-8 4000x4000 {dtype_name} effective "
                  f"bandwidth (best kernel: {best['kernel']})",
        "value": best["gbs"],
        "unit": "GB/s",
        "vs_baseline": round(best["gbs"] / BASELINE_GBS, 3),
        "pct_hbm_peak": _pct_hbm_peak(best["gbs"], best.get("device_kind")),
        "pct_peak": best.get("pct_peak"),
        "bound": best.get("bound"),
        "gflops": best["gflops"],
        "platform": best.get("platform"),
        "device_kind": best.get("device_kind"),
        "kernels": rows,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
