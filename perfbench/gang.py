"""A cell whose entry is a gang of processes, one rank a card.

The benchmark's process starts the gang with the program's own launcher
(``cme213_tpu_torch.dist.launch.launch``); each rank runs
``python3 -m perfbench.rank``, which sets its driver up, runs the window
(rank 0 decides when it has ended and tells every rank through a
broadcast on the control group after each solve), and writes what it read
to a file.  Rank 0 also reads the metrics and makes the comparison.  This
process merges the ranks' files: the peak of the fullest card, the busy
seconds averaged over the cards, the forbidden modules any rank loaded.
It opens no CUDA context of its own.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

from . import harness


def rank_command(ctx: harness.Context, seconds: float, trace: bool,
                 t_start: float, out_dir: str) -> list[str]:
    cmd = [sys.executable, "-m", "perfbench.rank", "--workload",
           ctx.cell.name, "--seed", str(ctx.seed), "--seconds", str(seconds),
           "--trace", str(int(trace)), "--t-start", repr(t_start),
           "--out", out_dir, "--device", ctx.device,
           "--entry", json.dumps(ctx.cell.entry)]
    for key, value in ctx.sizes.items():
        cmd += ["--size", f"{key}={json.dumps(value)}"]
    return cmd


def run(ctx: harness.Context, seconds: float, trace: bool, t_start: float,
        ranks: int, timeout: float = 340.0) -> tuple[dict, str]:
    """Launch the gang, wait for it, and merge its ranks' files.  Returns
    the merged fields (as ``harness.measure`` returns them) and the name of
    rank 0's card."""
    from cme213_tpu_torch.dist.launch import launch

    out_dir = tempfile.mkdtemp(prefix="perfbench-gang-")
    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(harness.ROOT)] + ([path] if path else []))
    try:
        rc = launch(ranks, rank_command(ctx, seconds, trace, t_start,
                                        out_dir), timeout=timeout)
        if rc != 0:
            raise RuntimeError(f"the gang exited {rc}")
        parts = []
        for r in range(ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                parts.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out = dict(parts[0])
    out["memory_peak_bytes"] = max(p["memory_peak_bytes"] for p in parts)
    if trace:
        out["busy_s"] = sum(p.get("busy_s", 0.0) for p in parts) / ranks
    out["forbidden"] = sorted({m for p in parts for m in p["forbidden"]})
    return out, parts[0]["kind"]
