"""Batch job runner: the Torque/PBS layer, framework-native.

Counterpart of ``cme213_tpu/bench/batch.py``; the runner does not care
which workload a job runs.  The port's own job files sit in
``cme213_tpu_torch/jobs/`` and write into ``bench_results_torch/jobs``.
The reference drives its measurement campaigns through batch scripts whose
header directives declare resources and whose body is re-run across an
environment sweep, with every run's stdout/stderr captured to job files
(``hw/hw4/programming/pa4.pbs:20-28`` sweeps ``OMP_NUM_THREADS`` over
1..64 and leaves ``pa4.pbs.o26386``/``.e26386`` logs; submission via
``qsub``, ``hw/hw4/PA4_Handout.pdf`` §7).  There is no cluster queue here,
but the *artifact discipline* — declarative sweep, one captured ``.o``/
``.e`` pair per point, a machine-readable summary — is the part worth
keeping, so this runner reproduces it for any framework workload:

    python -m cme213_tpu_torch.bench.batch \
        cme213_tpu_torch/jobs/spmv_scaling.job

Job-file format (shell script + ``#CME`` header directives, the ``#PBS``
analog)::

    #CME name=heat_kernels
    #CME out=bench_results_torch/jobs
    #CME sweep LOCAL_KERNEL=xla,pallas
    #CME timeout=900
    python -m cme213_tpu_torch heat2d params_dist.in --distributed \
        --local-kernel=$LOCAL_KERNEL

Multiple ``sweep`` directives form a cartesian product, evaluated in
directive order (last directive varies fastest).  Each sweep point ``i``
runs the body under ``bash`` with the point's variables exported, writing
``<out>/<name>.o<i>`` and ``<name>.e<i>``; a ``<name>.jobs.csv`` summary
records the variable values, exit status, and wall seconds per point.
Exit status is nonzero if any point failed — batch evidence with a silent
hole should not look green.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field


@dataclass
class JobSpec:
    name: str
    out: str = "batch_logs"
    timeout: float = 3600.0
    sweeps: list[tuple[str, list[str]]] = field(default_factory=list)
    body: str = ""

    def points(self) -> list[dict[str, str]]:
        """Cartesian product of the sweep axes (one dict per run)."""
        if not self.sweeps:
            return [{}]
        axes = [[(var, v) for v in values] for var, values in self.sweeps]
        return [dict(combo) for combo in itertools.product(*axes)]


def parse_job(path: str) -> JobSpec:
    spec = JobSpec(name=os.path.splitext(os.path.basename(path))[0])
    body_lines = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            stripped = line.strip()
            if not stripped.startswith("#CME"):
                body_lines.append(line)
                continue
            directive = stripped[len("#CME"):].strip()
            if directive.startswith("sweep "):
                assignment = directive[len("sweep "):].strip()
                var, _, csv_values = assignment.partition("=")
                values = [v.strip() for v in csv_values.split(",") if v.strip()]
                if not var.strip() or not values:
                    raise ValueError(
                        f"{path}:{lineno}: bad sweep directive {stripped!r}")
                spec.sweeps.append((var.strip(), values))
            elif "=" in directive:
                key, _, value = directive.partition("=")
                key, value = key.strip(), value.strip()
                if key == "name":
                    spec.name = value
                elif key == "out":
                    spec.out = value
                elif key == "timeout":
                    spec.timeout = float(value)
                else:
                    raise ValueError(
                        f"{path}:{lineno}: unknown directive key {key!r}")
            else:
                raise ValueError(
                    f"{path}:{lineno}: unparseable directive {stripped!r}")
    spec.body = "".join(body_lines)
    if not spec.body.strip():
        raise ValueError(f"{path}: job body is empty")
    return spec


def run_job(spec: JobSpec, dry_run: bool = False) -> list[dict]:
    if not dry_run:
        os.makedirs(spec.out, exist_ok=True)
    rows = []
    for i, env_point in enumerate(spec.points()):
        label = " ".join(f"{k}={v}" for k, v in env_point.items()) or "(none)"
        if dry_run:
            print(f"[{spec.name}.{i}] {label}")
            rows.append({"point": i, **env_point, "rc": "", "seconds": ""})
            continue
        out_path = os.path.join(spec.out, f"{spec.name}.o{i}")
        err_path = os.path.join(spec.out, f"{spec.name}.e{i}")
        env = {**os.environ, **env_point}
        t0 = time.perf_counter()
        with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
            # own process group: on timeout, kill the whole tree — killing
            # only bash would orphan the workload, which then skews the
            # wall-clock of every later sweep point
            proc = subprocess.Popen(
                ["bash", "-c", spec.body], env=env, stdout=out_f,
                stderr=err_f, start_new_session=True)
            try:
                rc = proc.wait(timeout=spec.timeout)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                rc = 124
        secs = time.perf_counter() - t0
        print(f"[{spec.name}.{i}] {label}: rc={rc} ({secs:.1f} s)")
        rows.append({"point": i, **env_point, "rc": rc,
                     "seconds": round(secs, 2)})
    if not dry_run:
        summary = os.path.join(spec.out, f"{spec.name}.jobs.csv")
        with open(summary, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"summary: {summary}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cme213_tpu_torch.bench.batch",
        description="Run a #CME batch job file (the PBS-script analog).")
    ap.add_argument("jobfile")
    ap.add_argument("--dry-run", action="store_true",
                    help="list sweep points without running")
    args = ap.parse_args(argv)
    spec = parse_job(args.jobfile)
    rows = run_job(spec, dry_run=args.dry_run)
    failed = [r for r in rows if r["rc"] not in ("", 0)]
    if failed:
        print(f"{len(failed)}/{len(rows)} points failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
