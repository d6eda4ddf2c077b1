"""The benchmark's engine, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
``workloads/<cell>.json`` adds the driver that runs it; the harness finds
every piece by name:

- ``configs/<config>.json``: the configuration's sizes and source;
- ``traffic/<traffic>.json``: the mix's parameters, read by the driver;
- ``drivers/<driver>.py``: the entry the window drives (``Driver``);
- ``metrics/<metric>.py``: one reader a metric (``read(run)``), for the
  end-to-end metrics (``--trace 0``) and the per-layer ones (``--trace 1``).

A run: set-up (inputs from the seed, the driver's warm-up), then a closed
loop of solves for ``--seconds``, then the comparison of a sample of the
window's answers, drawn from the seed, with the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
import traceback
import warnings
from dataclasses import dataclass, field
from pathlib import Path

from . import devtrace, faults, inputs

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in a measured process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cme213_tpu")


def spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(loader)
    sys.modules[mod_name] = mod
    loader.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    tops = {m.partition(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


@dataclass
class Cell:
    """One entry of ``workloads``, with its files read."""

    name: str
    entry: dict
    workload: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @classmethod
    def load(cls, name: str, entry: dict | None = None) -> "Cell":
        """The cell ``name`` as ``BENCHMARK.json`` declares it, or as
        ``entry`` declares it where one is given (a rank of a gang gets
        its parent's; the harness's tests run cells that
        ``BENCHMARK.json`` does not hold yet)."""
        if entry is None:
            entries = {w["name"]: w for w in spec()["workloads"]}
            if name not in entries:
                raise KeyError(f"no workload {name!r} in BENCHMARK.json")
            entry = entries[name]
        workload = load_json("workloads", name)
        for key in ("config", "traffic"):
            if workload[key] != entry[key]:
                raise ValueError(f"workloads/{name}.json names {key} "
                                 f"{workload[key]!r}, BENCHMARK.json "
                                 f"{entry[key]!r}")
        return cls(name, entry, workload, load_json("configs",
                                                    entry["config"]),
                   load_json("traffic", entry["traffic"]))

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports in a run with or without trace."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in spec()[key]
                if "workloads" not in m or self.name in m["workloads"]]


@dataclass
class Context:
    """What a driver is given: the cell, the seed, the device."""

    cell: Cell
    seed: int
    device: str
    sizes: dict = field(default_factory=dict)

    def param(self, key: str):
        """A parameter of the traffic, else of the configuration, as a test
        may shrink it."""
        if key in self.sizes:
            return self.sizes[key]
        if key in self.cell.traffic:
            return self.cell.traffic[key]
        return self.cell.config[key]


class Reservoir:
    """A sample of ``size`` answers drawn uniformly, from the seed, from
    all the window's answers, whose number is known only at its end."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = inputs.rng(seed, 3)
        self.kept: list = []
        self.seen = 0

    def offer(self, index: int, answer) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((index, answer))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = (index, answer)


@dataclass
class Run:
    """A finished window, as the metric readers see it."""

    cell: Cell
    setup_s: float
    wall_s: float
    units: float
    latencies_s: list
    counters: dict
    spans: dict
    trace: "devtrace.DeviceTrace | None"
    w0: float
    w1: float
    params: dict = field(default_factory=dict)


def program_spans(start_index: int, names) -> dict:
    """``{name: [(begin, end, ms), ...]}`` (wall seconds) of the program's
    spans named ``names`` recorded since event ``start_index``."""
    from cme213_tpu_torch.core import trace

    evs = trace.events()[start_index:]
    begins = {e["id"]: e["t"] for e in evs
              if e["event"] == "span-begin" and e.get("span") in names}
    out: dict = {n: [] for n in names}
    for e in evs:
        if e["event"] == "span-end" and e.get("id") in begins:
            out[e["span"]].append((begins[e["id"]], e["t"], e["ms"]))
    return out


def event_count() -> int:
    from cme213_tpu_torch.core import trace

    return len(trace.events())


def window(driver, ctx: Context, seconds: float, trace: bool, stop=None,
           device_index: int | None = 0):
    """Set-up has ended: run solves back to back for ``seconds`` (``stop``,
    when given, turns this process's verdict into the gang's), and return
    ``(Run, Reservoir, attempted, failed)``.  A traced window lasts at most
    the traffic's ``trace_seconds``, so that its trace stays small enough
    to read within the run's time."""
    import torch

    sample = Reservoir(int(ctx.param("sample")), ctx.seed)
    before = driver.counters()
    first_event = event_count()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and ctx.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        seconds = min(seconds, float(ctx.param("trace_seconds")))
        prof = profile(activities=acts)
        prof.__enter__()
        marker = devtrace.clock_marker()
    lat, units, failed, i = [], 0.0, 0, 0
    w0 = time.time()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            done_units, answer = driver.solve(i)
        except Exception:  # noqa: BLE001 — a failed solve is counted
            traceback.print_exc(file=sys.stderr)
            failed += 1
            done_units, answer = 0, None
        te = time.perf_counter()
        lat.append(te - ts)
        units += done_units
        if answer is not None:
            sample.offer(i, answer)
        i += 1
        done = te - t0 >= seconds
        if stop is not None:
            done = stop(done)
        if done:
            break
    wall = time.perf_counter() - t0
    w1 = w0 + wall
    tr = None
    if prof is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prof.__exit__(None, None, None)
        tr = devtrace.read(prof, w0, w1, marker, device_index)
        del prof
    after = driver.counters()
    counters = {k: after[k] - before.get(k, 0) for k in after}
    run = Run(ctx.cell, 0.0, wall, units, lat, counters,
              program_spans(first_event, driver.span_names), tr, w0, w1,
              {**ctx.cell.config, **ctx.cell.traffic, **ctx.sizes})
    return run, sample, i, failed


def read_metrics(run: Run, trace: bool) -> dict:
    out = {}
    for m in run.cell.metrics(trace):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(checks: list[dict], failed: int) -> bool:
    return failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks)


def print_checks(checks: list[dict]) -> None:
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)


def checks_key(checks: list[dict]) -> dict:
    return {c["name"]: {"value": c["value"], "limit": c["limit"]}
            for c in checks}


def measure(ctx: Context, seconds: float, trace: bool, t_start: float,
            stop=None, device_index: int | None = 0, checking: bool = True
            ) -> dict:
    """Set-up, window and check of one single-process driver (or of one
    rank of a gang, with ``stop``).  Returns the result's fields: the
    metrics, attempted, failed, the checks and what was read of the
    device (``busy_s``, ``window_s``, ``breakdown``, peak bytes)."""
    import torch

    name = ctx.cell.workload["driver"]
    faults.install_from_env(name)
    driver = load_module("drivers", name).Driver(ctx)
    driver.setup()
    on_card = ctx.device != "cpu"
    if on_card:
        # the peak of the timed path, not of the inputs' making or warm-up
        torch.cuda.reset_peak_memory_stats()
    run, sample, attempted, failed = window(driver, ctx, seconds, trace,
                                            stop, device_index)
    run.setup_s = run.w0 - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    out = {"attempted": attempted, "failed": failed,
           "memory_peak_bytes": int(peak),
           "metrics": read_metrics(run, trace)}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s()
        out["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    out["checks"] = driver.check(sample.kept) if checking else []
    return out
