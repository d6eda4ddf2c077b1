"""``dist.nccl_pct``: share of rank 0's traced window in which an NCCL
kernel ran on its card, waits for the other ranks included."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    busy, end = 0.0, tr.w0
    for name, s, e in tr.ops:
        if "nccl" not in name.lower() or e <= end:
            continue
        busy += e - max(s, end)
        end = e
    if busy <= 0:
        return None
    return 100.0 * busy / tr.window_s
