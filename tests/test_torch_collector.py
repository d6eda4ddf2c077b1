"""The port's live collector, ``collect`` and ``top`` consoles and the
heartbeat reader against the JAX package's, over the same sink files.

``Collector.state()`` of both packages must be equal over every record
set, and so must the text both render; the tailer's rotation, truncation
and torn-line cases and the CLI cases are ports of
``tests/test_fleet_telemetry.py`` and ``test_waterfall.py`` (the gang cases
there wait for the multi-process gang).
"""

import io
import json
import os

import pytest

import torch_telemetry_records as R
from cme213_tpu import top_cli as jtop
from cme213_tpu.core import collector as jcollector
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import trace as jtrace
from cme213_tpu.dist import supervisor as jsupervisor
from cme213_tpu_torch import top_cli
from cme213_tpu_torch.core import collector as collector_cli
from cme213_tpu_torch.core import metrics, trace
from cme213_tpu_torch.core.collector import (Collector, SinkTailer,
                                             write_fleet_exposition)
from cme213_tpu_torch.dist.supervisor import read_all_heartbeats


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for var in ("CME213_TRACE_FILE", "CME213_METRICS_FILE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for tr, me in ((jtrace, jmetrics), (trace, metrics)):
        tr.flush_sink()
        tr.clear_events()
        me.reset()
    yield
    for tr, me in ((jtrace, jmetrics), (trace, metrics)):
        tr.flush_sink()
        tr.clear_events()
        me.reset()


def _line(step, t=1.0, rank=0):
    return json.dumps({"event": "heartbeat", "t": t, "rank": rank,
                       "step": step, "pid": 1, "incarnation": 0,
                       "trace": "T1"}) + "\n"


def _fleet(tmp_path):
    return [R.write_sink(tmp_path / f, recs)
            for f, recs in R.fleet_records().items()]


def _sets(tmp_path):
    sets = {"fleet": _fleet(tmp_path)}
    for name, files in (("gang", R.gang_records()),
                        ("perf_gang", R.perf_gang_records())):
        sets[name] = [R.write_sink(tmp_path / f"{name}-{f}", recs)
                      for f, recs in files.items()]
    for name, recs in (("skewed_fleet", R.skewed_fleet_records()),
                       ("slowest_hops", R.slowest_hop_records()),
                       ("numerics", R.numerics_records())):
        sets[name] = [R.write_sink(tmp_path / f"{name}.jsonl", recs)]
    return sets


SETS = ("fleet", "gang", "perf_gang", "skewed_fleet", "slowest_hops",
        "numerics")


# ------------------------------------------------------------- the tailer

def test_tailer_partial_lines_buffered(tmp_path):
    p = tmp_path / "s.jsonl"
    tailer = SinkTailer(str(p))
    assert tailer.poll() == []
    full, torn = _line(1), _line(2, t=2.0)
    p.write_text(full + torn[:10])
    assert [r["step"] for r in tailer.poll()] == [1]
    with open(p, "a") as f:
        f.write(torn[10:])
    assert [r["step"] for r in tailer.poll()] == [2]
    assert tailer.malformed == 0


def test_tailer_survives_rotation(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text(_line(1) + _line(2, t=2.0))
    tailer = SinkTailer(str(p))
    assert len(tailer.poll()) == 2
    fresh = tmp_path / "s.jsonl.new"
    fresh.write_text(_line(7, t=3.0))
    os.replace(fresh, p)
    assert [r["step"] for r in tailer.poll()] == [7]


def test_tailer_survives_truncation(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text(_line(1) + _line(2, t=2.0))
    tailer = SinkTailer(str(p))
    assert len(tailer.poll()) == 2
    p.write_text(_line(9, t=3.0))
    assert [r["step"] for r in tailer.poll()] == [9]


def test_tailer_counts_malformed_lines(tmp_path):
    p = tmp_path / "s.jsonl"
    p.write_text("not json\n" + json.dumps({"no_event": 1}) + "\n"
                 + _line(4))
    tailer = SinkTailer(str(p))
    assert [r["step"] for r in tailer.poll()] == [4]
    assert tailer.malformed == 2


def test_tailer_matches_reference_through_torn_and_rotated_writes(
        tmp_path):
    """Both tailers, fed the same sequence of appends, tears, a rotation
    and a truncation, return the same records at every poll."""
    p = tmp_path / "s.jsonl"
    ours, ref = SinkTailer(str(p)), jcollector.SinkTailer(str(p))
    torn = _line(3, t=3.0)

    def append(text):
        with open(p, "a") as f:
            f.write(text)

    def rotate(text):
        (tmp_path / "n").write_text(text)
        os.replace(tmp_path / "n", p)

    steps = [lambda: p.write_text(_line(1) + "junk\n" + torn[:7]),
             lambda: append(torn[7:] + _line(4, t=4.0)),
             lambda: rotate(_line(5, t=5.0)),
             lambda: p.write_text(""),
             lambda: p.write_text(_line(6, t=6.0))]
    for step in steps:
        step()
        assert ours.poll() == ref.poll()
        assert ours.malformed == ref.malformed


# ---------------------------------------------------------- the collector

def test_collector_merges_and_aggregates(tmp_path):
    _fleet(tmp_path)
    coll = Collector([str(tmp_path / "f-*.jsonl")])
    batch = coll.poll()
    assert [r["t"] for r in batch] == sorted(r["t"] for r in batch)
    st = coll.state()
    assert st["trace_ids"] == ["T1"]
    assert list(st["ranks"]) == ["r0", "r1", "main"]
    assert st["fleet"] == {"exits": 1, "launches": 2, "restarts": 1,
                           "verdicts": 1, "commits": 1}
    assert st["verdicts"] == [{"rank": 1, "reason": "exit",
                               "incarnation": 0, "t": 3.0}]
    r1 = st["ranks"]["r1"]
    assert r1["pid"] == 13 and r1["state"] == "running" and r1["step"] == 5
    assert r1["incarnation"] == 1
    assert r1["heartbeat_age_s"] == 2.0
    assert st["ranks"]["main"]["pid"] == 9 and st["last_rc"] == 0
    assert st["spans"]["solve"] == {"count": 1, "total_ms": 2000.0,
                                    "max_ms": 2000.0}
    assert st["commit_lag_s"] == 7.0
    assert coll.fleet_snapshots() == {
        "r0": {"counters": {"fleet.steps": 6}, "gauges": {},
               "histograms": {}}}
    assert coll.poll() == [] and coll.state()["events"] == st["events"]


@pytest.mark.parametrize("name", SETS)
def test_collector_state_equal_reference(tmp_path, name):
    files = _sets(tmp_path)[name]
    ours, ref = Collector(files), jcollector.Collector(files)
    assert ours.poll() == ref.poll()
    assert ours.state() == ref.state()
    assert ours.fleet_snapshots() == ref.fleet_snapshots()
    text, ref_text = io.StringIO(), io.StringIO()
    collector_cli.render_state(ours.state(), text)
    jcollector.render_state(ref.state(), ref_text)
    assert text.getvalue() == ref_text.getvalue()
    text, ref_text = io.StringIO(), io.StringIO()
    top_cli.render_top(ours.state(), text)
    jtop.render_top(ref.state(), ref_text)
    assert text.getvalue() == ref_text.getvalue()


def test_collector_state_equal_reference_on_real_runs(tmp_path,
                                                      monkeypatch):
    """Sinks the port's and the JAX package's CPU runs wrote, read by both
    collectors at once."""
    files = [R.port_cpu_sink(tmp_path / "port.jsonl", monkeypatch),
             R.jax_cpu_sink(tmp_path / "jax.jsonl", monkeypatch)]
    ours, ref = Collector(files), jcollector.Collector(files)
    ours.poll()
    ref.poll()
    st = ours.state()
    assert st == ref.state()
    assert st["solvers"]["heat2d"]["stalled"] is False
    assert {"heat.run", "spmv_scan.run", "checkpoint.chunk"} <= \
        set(st["spans"])


def test_collector_tracks_slowest_request_hops(tmp_path, capsys):
    path = R.write_sink(tmp_path / "s.jsonl", R.slowest_hop_records())
    coll = Collector([path])
    coll.poll()
    state = coll.state()
    ribbon = state["slowest_traces"]
    assert len(ribbon) == Collector._SLOWEST_N
    assert [e["rid"] for e in ribbon] == [11, 10, 9, 8, 7, 6, 5, 4]
    assert ribbon[0]["ms"] == 120.0 and ribbon[0]["requeues"] == 1
    assert ribbon[0]["trace"] == "T"
    top_cli.render_top(state)
    text = capsys.readouterr().out
    assert "slowest requests" in text
    assert "rid=11" in text and "1 requeue(s)" in text


def test_write_fleet_exposition_equal_reference(tmp_path, monkeypatch):
    paths = _fleet(tmp_path)
    ours = write_fleet_exposition(paths, str(tmp_path / "ours.prom"))
    ref = jcollector.write_fleet_exposition(paths,
                                            str(tmp_path / "ref.prom"))
    text = open(ours).read()
    assert text == open(ref).read()
    assert 'rank="r0"' in text
    assert write_fleet_exposition(paths, None) is None
    assert write_fleet_exposition(_sets(tmp_path)["gang"],
                                  str(tmp_path / "none.prom")) is None


# ------------------------------------------------------------------- CLIs

def test_collect_cli_once_json_and_text(tmp_path, capsys):
    paths = _fleet(tmp_path)
    assert collector_cli.main([*paths, "--once", "--json"]) == 0
    out = capsys.readouterr().out
    st = json.loads(out)
    assert st["trace_ids"] == ["T1"] and set(st["ranks"]) == {
        "r0", "r1", "main"}
    assert jcollector.main([*paths, "--once", "--json"]) == 0
    assert capsys.readouterr().out == out
    assert collector_cli.main([*paths, "--once"]) == 0
    out = capsys.readouterr().out
    assert "3 proc(s)" in out and "1 trace id(s)" in out
    assert "verdict: rank 1 exit" in out


def test_collect_cli_follow_streams_jsonl(tmp_path, capsys):
    paths = _fleet(tmp_path)
    assert collector_cli.main(
        [*paths, "--follow", "--interval", "0.01",
         "--max-seconds", "0.05"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(recs) == 12 and all("_file" not in r for r in recs)
    assert [r["t"] for r in recs] == sorted(r["t"] for r in recs)


def test_top_once_json_and_text(tmp_path, capsys):
    paths = _fleet(tmp_path)
    assert top_cli.main([*paths, "--once", "--json"]) == 0
    out = capsys.readouterr().out
    st = json.loads(out)
    assert st["fleet"]["restarts"] == 1 and "r1" in st["ranks"]
    assert jtop.main([*paths, "--once", "--json"]) == 0
    assert capsys.readouterr().out == out
    assert top_cli.main([*paths, "--once"]) == 0
    out = capsys.readouterr().out
    assert "cme213 fleet" in out and "trace T1" in out
    assert "PROC" in out and "HB AGE" in out
    assert "restarts=1" in out and "solve" in out


def test_top_live_frames_stop_after_iterations(tmp_path, capsys):
    paths = _fleet(tmp_path)
    assert top_cli.main([*paths, "--json", "--interval", "0",
                         "--iterations", "2"]) == 0
    frames = capsys.readouterr().out.splitlines()
    assert len(frames) == 2
    assert json.loads(frames[0]) == json.loads(frames[1])
    assert top_cli.main([*paths, "--interval", "0",
                         "--iterations", "1"]) == 0
    assert capsys.readouterr().out.startswith("\x1b[2J\x1b[H")


def _beat(hb_dir, rank, step):
    """A heartbeat file as a supervised rank publishes it."""
    with open(jsupervisor.heartbeat_path(str(hb_dir), rank), "w") as f:
        json.dump({"rank": rank, "step": step, "pid": 100 + rank,
                   "incarnation": 0, "t": 1.0 + rank}, f)


def test_read_all_heartbeats_equal_reference(tmp_path):
    _beat(tmp_path, 0, 4)
    _beat(tmp_path, 1, 9)
    (tmp_path / "rank2.json").write_text('{"rank": ')      # torn
    (tmp_path / "rank3.json").write_text('{"step": 3}')    # no rank
    (tmp_path / "other.json").write_text('{"rank": 7}')    # not a beat
    beats = read_all_heartbeats(str(tmp_path))
    assert {r: b["step"] for r, b in beats.items()} == {0: 4, 1: 9}
    assert beats == jsupervisor.read_all_heartbeats(str(tmp_path))
    assert read_all_heartbeats(str(tmp_path / "absent")) == {}


def test_top_folds_supervisor_heartbeats(tmp_path, capsys):
    _beat(tmp_path, 0, 4)
    jsupervisor.HeartbeatWriter(str(tmp_path), rank=1).beat(9)
    sink = tmp_path / "s.jsonl"
    sink.write_text(_line(None, t=1.0, rank=0).replace('"step": null',
                                                       '"x": 0'))
    argv = [str(sink), "--once", "--json", "--hb-dir", str(tmp_path)]
    assert top_cli.main(argv) == 0
    out = capsys.readouterr().out
    st = json.loads(out)
    assert st["heartbeats"]["1"]["step"] == 9
    assert st["ranks"]["r0"]["step"] == 4
    assert jtop.main(argv) == 0
    assert capsys.readouterr().out == out


def test_collect_and_top_workloads_dispatch(tmp_path, capsys):
    from cme213_tpu_torch import models

    paths = _fleet(tmp_path)
    assert models.dispatch(["collect", *paths, "--once", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["fleet"]["launches"] == 2
    assert models.dispatch(["top", *paths, "--once"]) == 0
    assert "cme213 fleet" in capsys.readouterr().out
