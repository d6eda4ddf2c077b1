"""Helpers of the port's gang tests: a worker script, run as a gang of
ranks by the port's launcher on the CPU (gloo), that writes what it
computed into a directory the test reads back."""

import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def write_worker(tmp_path, body: str, name: str = "worker.py",
                 **constants) -> str:
    """A worker script: the checkout on ``sys.path``, ``constants`` as
    module-level names (their ``repr``), then ``body``."""
    head = [f"import sys; sys.path.insert(0, {str(ROOT)!r})"]
    head += [f"{k} = {v!r}" for k, v in constants.items()]
    path = Path(tmp_path) / name
    path.write_text("\n".join(head) + "\n" + textwrap.dedent(body))
    return str(path)


def run_gang(tmp_path, body: str, np_procs: int = 2,
             devices_per_proc: int | None = 2, timeout: float = 240,
             backend: str = "gloo", **constants) -> int:
    """Launch ``body`` as a gang of ``np_procs`` ranks, each with
    ``devices_per_proc`` shards, asking for ``backend`` (``gloo``: the
    gang is on the CPU, whatever cards the host has; ``auto``: each rank's
    layout decides); the worker's ``sys.argv[1]`` is ``tmp_path``.
    Returns the launcher's exit code."""
    from cme213_tpu_torch.dist.launch import launch

    script = write_worker(tmp_path, body, **constants)
    return launch(np_procs, [sys.executable, script, str(tmp_path)],
                  devices_per_proc=devices_per_proc, timeout=timeout,
                  backend=backend)
