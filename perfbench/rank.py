"""One rank of a gang cell (``perfbench/gang.py`` starts it through the
program's launcher, which sets ``RANK``, ``WORLD_SIZE`` and the
rendezvous).  Writes ``<out>/rank<r>.json``."""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import harness
from .run import set_cache_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.rank")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", action="append", default=[])
    ap.add_argument("--entry", required=True)
    args = ap.parse_args(argv)
    rank = int(os.environ.get("RANK", "0"))
    cell = harness.Cell.load(args.workload, json.loads(args.entry))
    set_cache_env(cell.name, rank)
    sizes = {}
    for item in args.size:
        key, _, value = item.partition("=")
        sizes[key] = json.loads(value)
    ctx = harness.Context(cell, args.seed, args.device, sizes)
    import torch
    import torch.distributed as dist

    from cme213_tpu_torch.dist import multihost

    multihost.initialize_multihost(device=args.device)

    def stop(done: bool) -> bool:
        flag = torch.tensor([int(done)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=multihost.control())
        return bool(flag.item())

    on_card = args.device != "cpu"
    index = torch.cuda.current_device() if on_card else None
    out = harness.measure(ctx, args.seconds, bool(args.trace), args.t_start,
                          stop=stop, device_index=index,
                          checking=rank == 0)
    out["kind"] = torch.cuda.get_device_name(index) if on_card else "cpu"
    out["forbidden"] = harness.forbidden_loaded()
    path = os.path.join(args.out, f"rank{rank}.json")
    with open(path + ".part", "w") as f:
        json.dump(out, f)
    os.replace(path + ".part", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
