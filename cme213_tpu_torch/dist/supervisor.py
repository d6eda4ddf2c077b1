"""Gang supervision: the heartbeat files a supervised rank publishes.

Counterpart of ``cme213_tpu/dist/supervisor.py``, cut to the reader that
``top --hb-dir`` calls.  Each rank of a supervised gang publishes its
current step as ``rank<r>.json`` in the heartbeat directory, by an atomic
rename, so a reader never sees a torn beat.  The writer, the supervisor
and the gang launcher come with the multi-process gang.
"""

from __future__ import annotations

import glob
import json
import os


def read_all_heartbeats(hb_dir: str) -> dict[int, dict]:
    """Every rank's latest beat in ``hb_dir``, keyed by rank — discovered
    by globbing ``rank*.json`` so callers (``top --hb-dir``) need not know
    the world size.  Unreadable or malformed files are skipped."""
    out: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(hb_dir, "rank*.json"))):
        try:
            with open(path) as f:
                beat = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(beat, dict) and isinstance(beat.get("rank"), int):
            out[beat["rank"]] = beat
    return out
