"""The port's transport bench (``cme213_tpu_torch/bench/transport_sweep.py``)
on the CPU: its rows have the JAX package's identity and metric columns,
the codec gate holds (v2 binary frames at least 5x the v1 base64 JSON at
1 MiB, the JAX package's tier-1 pin), and the CSV lands where the port's
harness writes, never in the JAX package's ``bench_results/``.
"""

import csv

from cme213_tpu.bench import transport_sweep as j_sweep
from cme213_tpu_torch.bench import RESULTS_DIR
from cme213_tpu_torch.bench import transport_sweep as sweep


def _identity(rows):
    return [(r["sweep"], r["lane"], r["msg_bytes"], r["depth"])
            for r in rows]


def test_codec_rows_match_the_reference_and_hold_the_gate(tmp_path,
                                                          capsys):
    out = tmp_path / "ts.csv"
    assert sweep.main(["--quick", "--codec-only", "--out", str(out),
                       "--assert-speedup", "5"]) == 0
    text = capsys.readouterr().out
    assert "codec speedup @ 1048576 B" in text and "OK" in text
    with open(out) as f:
        rows = list(csv.DictReader(f))
    ref = j_sweep.codec_sweep(j_sweep.QUICK_SIZES, iters=1)
    assert list(rows[0]) == list(ref[0])
    assert [(r["sweep"], r["lane"], int(r["msg_bytes"]), int(r["depth"]))
            for r in rows] == _identity(ref)
    assert all(float(r["mbs"]) > 0 and float(r["req_s"]) > 0 for r in rows)


def test_wire_rows_over_the_port_s_stub_server():
    rows = sweep.wire_sweep(sizes=(1 << 16,), quick=True)
    lanes = {(r["lane"], r["depth"]) for r in rows}
    assert {("v1json", 1), ("v2bin", 1), ("v2bin", 32)} <= lanes
    assert all(r["sweep"] == "wire" and r["req_s"] > 0 for r in rows)
    assert list(rows[0]) == ["sweep", "lane", "msg_bytes", "depth", "ms",
                             "mbs", "req_s"]


def test_default_output_is_the_port_s_results_dir():
    assert sweep.SIZES == j_sweep.SIZES
    assert sweep.QUICK_SIZES == j_sweep.QUICK_SIZES
    assert RESULTS_DIR == "bench_results_torch"
    assert sweep.DEFAULT_OUT == "bench_results_torch/transport_sweep.csv"
