"""The port's trace CLI (``cme213_tpu_torch/trace_cli.py``) against the JAX
package's over the same JSON-lines records.

Every record set goes through both packages' ``summarize``,
``render_timeline``, ``to_chrome_trace``, ``clock_shifts``,
``resolve_shifts``, ``build_waterfalls`` and ``render_waterfall``, and the
results must be equal; text output differs only in the two lines the port
words for itself (the attribution-mismatch header, a flight dump's platform
line).  The record sets: the reference's own fixtures
(``tests/torch_telemetry_records.py``), a sink the port's CPU runs wrote
and one the JAX package's CPU runs wrote — each package's CLI reads the
other's.  The rest ports the trace-CLI cases of ``tests/test_telemetry.py``,
the summary and export cases of ``test_perf_observability.py``, the window
and follow cases of ``test_fleet_telemetry.py``, the waterfall cases of
``test_waterfall.py`` and the ``trace flight`` cases of ``test_flight.py``.
"""

import copy
import io
import json
import os

import pytest

import torch_telemetry_records as R
from cme213_tpu import trace_cli as jcli
from cme213_tpu.core import faults as jfaults
from cme213_tpu.core import flight as jflight
from cme213_tpu.core import metrics as jmetrics
from cme213_tpu.core import trace as jtrace
from cme213_tpu_torch import trace_cli
from cme213_tpu_torch.core import faults, flight, metrics, trace
from cme213_tpu_torch.core.trace import validate_record

ENV = ("CME213_FAULTS", "CME213_TRACE_FILE", "CME213_TRACE_BUFFER",
       "CME213_TRACE_CONTEXT", "CME213_INCARNATION", "RANK",
       "CME213_FLIGHT_DIR", "CME213_METRICS_FILE", "CME213_DEVICE_PEAKS")
#: the one header line the port words for itself in ``summarize``
MISMATCH = ("(cost model vs XLA cost_analysis)", "(cost model vs staged plan)")


def _reset():
    for tr, me, fa in ((jtrace, jmetrics, jfaults), (trace, metrics, faults)):
        tr.flush_sink()
        tr.clear_events()
        me.reset()
        fa.reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def record_sets(tmp_path_factory):
    """Record-set name -> the sink files holding it."""
    d = tmp_path_factory.mktemp("sinks")
    sets = {}
    for name, files in (("gang", R.gang_records()),
                        ("perf_gang", R.perf_gang_records()),
                        ("fleet", R.fleet_records())):
        sets[name] = [R.write_sink(d / f"{name}-{f}", recs)
                      for f, recs in files.items()]
    for name, recs in (("skewed_fleet", R.skewed_fleet_records()),
                       ("slowest_hops", R.slowest_hop_records()),
                       ("numerics", R.numerics_records())):
        sets[name] = [R.write_sink(d / f"{name}.jsonl", recs)]
    with pytest.MonkeyPatch.context() as mp:
        for var in ENV:
            mp.delenv(var, raising=False)
        sets["port_cpu"] = [R.port_cpu_sink(d / "port.jsonl", mp)]
        sets["jax_cpu"] = [R.jax_cpu_sink(d / "jax.jsonl", mp)]
    _reset()
    return sets


SETS = ("gang", "perf_gang", "fleet", "skewed_fleet", "slowest_hops",
        "numerics", "port_cpu", "jax_cpu")


def _events(files):
    return jcli.load_events(files)


# ------------------------------------------------------ parity, every set

@pytest.mark.parametrize("name", SETS)
def test_load_events_equal_reference(record_sets, name):
    files = record_sets[name]
    assert trace_cli.load_events(files) == jcli.load_events(files)


@pytest.mark.parametrize("name", SETS)
def test_summarize_equal_reference(record_sets, name):
    events = _events(record_sets[name])
    ref_text, text = io.StringIO(), io.StringIO()
    ref = jcli.summarize(copy.deepcopy(events), out=ref_text)
    ours = trace_cli.summarize(copy.deepcopy(events), out=text)
    assert ours == ref
    assert json.dumps(ours, indent=2, default=str) == \
        json.dumps(ref, indent=2, default=str)
    assert text.getvalue() == ref_text.getvalue().replace(*MISMATCH)


@pytest.mark.parametrize("name", SETS)
def test_timeline_equal_reference(record_sets, name):
    events = _events(record_sets[name])
    for show_all in (False, True):
        ref, ours = io.StringIO(), io.StringIO()
        jcli.render_timeline(copy.deepcopy(events), out=ref,
                             show_all=show_all)
        trace_cli.render_timeline(copy.deepcopy(events), out=ours,
                                  show_all=show_all)
        assert ours.getvalue() == ref.getvalue()


@pytest.mark.parametrize("name", SETS)
def test_chrome_export_equal_reference(record_sets, name):
    events = _events(record_sets[name])
    assert trace_cli.to_chrome_trace(copy.deepcopy(events)) == \
        jcli.to_chrome_trace(copy.deepcopy(events))


@pytest.mark.parametrize("name", SETS)
def test_waterfall_equal_reference(record_sets, name):
    events = _events(record_sets[name])
    edges = trace_cli.clock_shifts(events)
    assert edges == jcli.clock_shifts(events)
    for pid in sorted({e["pid"] for e in events
                       if isinstance(e.get("pid"), int)}):
        assert trace_cli.resolve_shifts(edges, pid) == \
            jcli.resolve_shifts(edges, pid)
    keys = {"3", "7", "11", "T", "no-such-rid"} | {
        str(e["trace"]) for e in events if e.get("trace")}
    for key in sorted(keys):
        doc = trace_cli.build_waterfalls(copy.deepcopy(events), key)
        assert doc == jcli.build_waterfalls(copy.deepcopy(events), key)
        ref, ours = io.StringIO(), io.StringIO()
        jcli.render_waterfall(doc, out=ref)
        trace_cli.render_waterfall(doc, out=ours)
        assert ours.getvalue() == ref.getvalue()


@pytest.mark.parametrize("name", SETS)
def test_cli_documents_equal_reference(record_sets, name, capsys):
    """``summary --json``, ``export``, ``merge`` and ``timeline --all`` print
    the reference's bytes."""
    files = record_sets[name]
    for argv in (["summary", *files, "--json"], ["export", *files],
                 ["merge", *files], ["timeline", *files, "--all"],
                 ["summary", *files, "--last", "5", "--json"]):
        assert jcli.main(list(argv)) == 0
        ref = capsys.readouterr().out
        assert trace_cli.main(list(argv)) == 0
        assert capsys.readouterr().out == ref


# ------------------------------------------------------------- interop

def test_reference_summary_reads_the_port_s_sink(record_sets, capsys):
    sink = record_sets["port_cpu"]
    assert jcli.main(["summary", *sink, "--require",
                      "heat.run,spmv_scan.run,checkpoint.chunk,"
                      "conformance-probe,solver-progress"]) == 0
    out = capsys.readouterr().out
    assert "heat.run [pipeline]" in out
    assert "spmv_scan: pallas-fused x1" in out
    assert all(validate_record(e) == [] for e in _events(sink))


def test_port_summary_reads_the_reference_s_sink(record_sets, capsys):
    sink = record_sets["jax_cpu"]
    assert trace_cli.main(["summary", *sink, "--require",
                           "heat.run,spmv_scan.run,checkpoint.chunk,"
                           "conformance-probe,solver-progress"]) == 0
    out = capsys.readouterr().out
    assert "heat.run [pipeline]" in out and "% of peak" in out
    assert "convergence: 1 solver(s)" in out


def test_port_and_reference_runs_summarize_alike(record_sets):
    """The same workloads on the CPU record the same spans, rungs, probes
    and convergence epochs in both packages."""
    port = trace_cli.summarize(_events(record_sets["port_cpu"]),
                               out=io.StringIO())
    ref = trace_cli.summarize(_events(record_sets["jax_cpu"]),
                              out=io.StringIO())
    assert sorted(port["spans"]) == sorted(ref["spans"])
    assert {k: len(v) for k, v in port["spans"].items()} == \
        {k: len(v) for k, v in ref["spans"].items()}
    assert sorted(port["counts"]) == sorted(ref["counts"])
    assert port["conformance"].keys() == ref["conformance"].keys()
    assert port["convergence"]["heat2d"]["epochs"] == \
        ref["convergence"]["heat2d"]["epochs"]


# ------------------------------------------------ test_telemetry.py cases

def _gang(tmp_path):
    return [R.write_sink(tmp_path / f, recs)
            for f, recs in R.gang_records().items()]


def test_cli_summary_reconstructs_gang_view(tmp_path, capsys):
    paths = _gang(tmp_path)
    assert trace_cli.main(["summary", *paths]) == 0
    out = capsys.readouterr().out
    assert "ranks: main, r0, r1" in out
    assert "epoch commits: 3" in out and "p50=6.00" in out
    assert "resume: epoch 2, step 4 from COMMIT" in out
    assert "gang: 2 launch(es), 1 verdict(s) [exit], 1 restart(s), " \
           "final rc 0" in out
    assert "rankkill x1" in out


def test_cli_summary_require_missing_span(tmp_path, capsys):
    paths = _gang(tmp_path)
    assert trace_cli.main(["summary", *paths, "--require", "solve"]) == 0
    assert trace_cli.main(
        ["summary", *paths, "--require", "solve,absent-span"]) == 1
    assert "absent-span" in capsys.readouterr().err


def test_cli_timeline_orders_ranks_chronologically(tmp_path, capsys):
    paths = _gang(tmp_path)
    assert trace_cli.main(["merge", "--timeline", *paths]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[2] for line in lines][0] == "main"
    joined = "\n".join(lines)
    assert joined.index("fault-injected") < joined.index("rank-failed") \
        < joined.index("gang-restart") < joined.index("commit-loaded") \
        < joined.index("gang-exit")
    assert "span-begin" not in joined and "solve ms=5500.0" in joined


def test_cli_merge_emits_sorted_jsonl(tmp_path):
    paths = _gang(tmp_path)
    out_path = tmp_path / "merged.jsonl"
    assert trace_cli.main(["merge", *paths, "--out", str(out_path)]) == 0
    recs = [json.loads(line)
            for line in out_path.read_text().splitlines()]
    assert len(recs) == 14
    assert [r["t"] for r in recs] == sorted(r["t"] for r in recs)
    assert all("_file" not in r for r in recs)


def test_cli_parse_error_is_fatal(tmp_path, capsys):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"event": "heartbeat", "t": 1.0}\nnot json\n')
    assert trace_cli.main(["summary", str(p)]) == 2
    assert "bad.jsonl:2" in capsys.readouterr().err


def test_cli_summary_counts_schema_violations(tmp_path, capsys):
    p = R.write_sink(tmp_path / "t.jsonl", [
        {"event": "served", "t": 1.0, "op": "x", "rung": "a",
         "demoted": False}])
    assert trace_cli.main(["summary", p]) == 0
    assert "served: missing failed_rungs x1" in capsys.readouterr().out


def test_spmv_demotion_flows_to_trace_file(tmp_path, monkeypatch, capsys):
    """End to end on the port: fault-injected dispatch, the process's sink,
    then the CLI."""
    from cme213_tpu_torch.apps import spmv_scan as sp
    from cme213_tpu_torch.core import conformance
    from cme213_tpu_torch.core.faults import injected

    conformance.reset()
    path = tmp_path / "t.jsonl"
    monkeypatch.setenv(trace.TRACE_FILE_ENV, str(path))
    prob = sp.generate_problem(512, 8, 7, iters=3, seed=0)
    with injected("fail:spmv_scan.pallas-fused"):
        sp.run_spmv_scan(prob, kernel="pallas-fused", device="cpu")
    trace.flush_sink()
    monkeypatch.delenv(trace.TRACE_FILE_ENV)
    served = trace.events("served")[-1]["rung"]
    assert trace_cli.main(
        ["summary", str(path),
         "--require", "spmv_scan.compile,spmv_scan.run"]) == 0
    out = capsys.readouterr().out
    assert f"spmv_scan: {served} x1" in out
    assert "spmv_scan.pallas-fused x1" in out
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert all(validate_record(r) == [] for r in recs)
    run_end = [r for r in recs if r["event"] == "span-end"
               and r["span"] == "spmv_scan.run"]
    assert run_end and run_end[0]["kernel"] == served


# ----------------------------------- test_perf_observability.py cases

def _perf(tmp_path):
    files = R.perf_gang_records()
    files["trace-0.jsonl"] = files["trace-0.jsonl"][:5]  # the reference's
    return [R.write_sink(tmp_path / f, recs) for f, recs in files.items()]


def test_summary_json_machine_readable(tmp_path, capsys):
    paths = _perf(tmp_path)
    assert trace_cli.main(["summary", *paths, "--json"]) == 0
    agg = json.loads(capsys.readouterr().out)
    assert agg["events"] == 10
    assert agg["ranks"] == ["main", "r0", "r1"]
    assert agg["spans"]["solve"] == [700.0, 1000.0]
    assert agg["compile_run"]["solve [n64]"]["compiles"] == 1
    assert agg["counts"]["heartbeat"] == 1


def test_summary_json_respects_require(tmp_path):
    paths = _perf(tmp_path)
    assert trace_cli.main(["summary", *paths, "--json",
                           "--require", "absent"]) == 1


def test_summary_roofline_rows_carry_pct_peak(tmp_path, capsys):
    paths = [R.write_sink(tmp_path / f, recs)
             for f, recs in R.perf_gang_records().items()]
    assert trace_cli.main(["summary", *paths, "--json"]) == 0
    row = json.loads(capsys.readouterr().out)["attribution"][
        "heat.run [pipeline]"]
    assert row["count"] == 2 and row["best_gbs"] == 2293.907
    assert row["pct_peak"] == round(100 * 2293.907 / 3350.0, 2)
    assert row["bound"] == "memory"
    assert trace_cli.main(["summary", *paths]) == 0
    out = capsys.readouterr().out
    assert "attribution mismatches: 1 (cost model vs staged plan)" in out
    assert "kernel forensics: 2 failure(s), 1 crash(es), 1 conformance" \
        in out


def test_chrome_export_round_trip(tmp_path):
    paths = _perf(tmp_path)
    out_path = tmp_path / "chrome.json"
    assert trace_cli.main(["export", *paths, "--out", str(out_path)]) == 0
    doc = json.loads(out_path.read_text())
    evs = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    names = {e["pid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert names == {0: "main", 1: "rank 0", 2: "rank 1"}
    stacks = {}
    for e in sorted((e for e in evs if e["ph"] in "BE"),
                    key=lambda e: e["ts"]):
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        else:
            assert stacks.get(key), f"E without B on {key}"
            assert stacks[key].pop() == e["name"]
    assert all(not s for s in stacks.values())
    n_b = sum(1 for e in evs if e["ph"] == "B")
    assert n_b == sum(1 for e in evs if e["ph"] == "E") == 3
    compile_b = next(e for e in evs if e["ph"] == "B"
                     and e["name"] == "solve.compile")
    assert compile_b["tid"] == 1 and compile_b["pid"] == 1
    xs = [e for e in evs if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["orphan"]
    assert xs[0]["dur"] == 50.0 * 1e3
    assert not any(e.get("name") == "open" for e in evs)
    assert {e["name"] for e in evs if e["ph"] == "i"} >= {"heartbeat",
                                                          "gang-launch"}
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_chrome_export_stdout_and_parse_error(tmp_path, capsys):
    paths = _perf(tmp_path)
    assert trace_cli.main(["export", *paths]) == 0
    assert json.loads(capsys.readouterr().out)["traceEvents"]
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    assert trace_cli.main(["export", str(bad)]) == 2


# -------------------------------------- test_fleet_telemetry.py cases

def _windowed(tmp_path):
    recs = [{"event": "heartbeat", "t": float(t), "rank": 0, "step": i,
             "pid": 1, "incarnation": 0, "trace": "T1"}
            for i, t in enumerate((100.0, 200.0, 300.0))]
    return R.write_sink(tmp_path / "w.jsonl", recs), recs


def test_window_events_units(tmp_path):
    from datetime import datetime

    _, recs = _windowed(tmp_path)
    assert [e["step"] for e in trace_cli.window_events(
        recs, since="150000")] == [1, 2]
    iso = datetime.fromtimestamp(200.0).isoformat()
    assert [e["step"] for e in trace_cli.window_events(recs, since=iso)] \
        == [1, 2]
    assert [e["step"] for e in trace_cli.window_events(recs, last=1)] == [2]
    assert trace_cli.window_events(recs, last=0) == []
    with pytest.raises(ValueError):
        trace_cli.window_events(recs, since="yesterday-ish")


def test_cli_since_last_and_single_trace(tmp_path, capsys):
    path, _ = _windowed(tmp_path)
    assert trace_cli.main(["timeline", path, "--last", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("heartbeat") == 1 and "step=2" in out
    assert trace_cli.main(["summary", path, "--since", "150000"]) == 0
    assert "2 events" in capsys.readouterr().out
    assert trace_cli.main(["summary", path, "--since", "garbage"]) == 2
    capsys.readouterr()
    assert trace_cli.main(["summary", path, "--single-trace"]) == 0
    with open(path, "a") as f:
        f.write(json.dumps({"event": "heartbeat", "t": 400.0, "rank": 1,
                            "step": 9, "pid": 2, "incarnation": 0,
                            "trace": "T2"}) + "\n")
    assert trace_cli.main(["summary", path, "--single-trace"]) == 1
    assert "expected exactly one trace id" in capsys.readouterr().err


def test_cli_merge_follow_streams(tmp_path, capsys):
    paths = [R.write_sink(tmp_path / f, recs)
             for f, recs in R.fleet_records().items()]
    assert trace_cli.main(
        ["merge", "--follow", *paths, "--interval", "0.01",
         "--max-seconds", "0.05"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(recs) == 12 and all("_file" not in r for r in recs)
    assert trace_cli.main(
        ["merge", "--follow", "--timeline", *paths, "--interval", "0.01",
         "--max-seconds", "0.05"]) == 0
    out = capsys.readouterr().out
    assert "gang-launch" in out and "rank-failed" in out


def test_summary_reports_trace_ids_and_pids(tmp_path):
    paths = [R.write_sink(tmp_path / f, recs)
             for f, recs in R.fleet_records().items()]
    agg = trace_cli.summarize(trace_cli.load_events(paths),
                              out=io.StringIO())
    assert agg["trace_ids"] == ["T1"]
    assert agg["pids"] == [9, 10, 11, 12, 13]


# ------------------------------------------------ test_waterfall.py cases

def test_waterfall_aligns_hops_across_skewed_clocks():
    doc = trace_cli.build_waterfalls(R.skewed_fleet_records(), "3")
    assert len(doc["trees"]) == 1
    tree = doc["trees"][0]
    assert tree["ref_pid"] == 200
    assert tree["pids"] == [100, 200, 300]
    assert tree["trace_ids"] == ["T"]
    hops = {h["id"]: h for h in tree["hops"]}
    assert len(hops) == 7
    assert [hops[i]["depth"] for i in ("c.1", "f.1", "f.2", "r.1", "r.2")] \
        == [0, 1, 2, 2, 3]
    assert hops["c.1"]["start_ms"] == pytest.approx(0.0)
    assert hops["f.1"]["start_ms"] == pytest.approx(10.0)
    assert hops["r.1"]["start_ms"] == pytest.approx(32.0)
    assert hops["r.2"]["start_ms"] == pytest.approx(35.0)
    for h in tree["hops"]:
        parent = hops.get(h["parent"])
        if parent is not None:
            slack = h["err_ms"] + parent["err_ms"] + 1e-6
            assert h["start_ms"] >= parent["start_ms"] - slack
    assert hops["f.1"]["err_ms"] == 0.0
    assert hops["c.1"]["err_ms"] == pytest.approx(1.5)
    assert hops["r.2"]["err_ms"] == pytest.approx(2.0)
    assert all(h["aligned"] for h in tree["hops"])
    assert hops["f.2"]["requeued"] is True
    assert hops["f.3"]["span"] == "serve.hop.requeue"


def test_waterfall_unsynced_pid_is_flagged_not_shifted():
    evs = [e for e in R.skewed_fleet_records()
           if e["event"] != "clock-offset" or e["pid"] != 200]
    hops = {h["id"]: h for h in
            trace_cli.build_waterfalls(evs, "3")["trees"][0]["hops"]}
    assert hops["r.1"]["aligned"] is False
    assert hops["c.1"]["aligned"] is True


def test_waterfall_rid_domains_yield_separate_trees():
    evs = R.skewed_fleet_records() + [
        R._hop("span-begin", "serve.hop.client", "c2.1", None, 100,
               5.0, trace_id="T2", rid=3),
        R._hop("span-end", "serve.hop.client", "c2.1", None, 100,
               5.01, trace_id="T2", ms=10.0, rid=3),
    ]
    doc = trace_cli.build_waterfalls(evs, "3")
    assert doc == jcli.build_waterfalls(evs, "3")
    assert {tuple(t["trace_ids"]) for t in doc["trees"]} == {("T",),
                                                             ("T2",)}


def test_waterfall_matches_by_trace_id_too():
    assert len(trace_cli.build_waterfalls(
        R.skewed_fleet_records(), "T")["trees"]) == 1


def test_waterfall_open_hop_survives_reconstruction():
    evs = [e for e in R.skewed_fleet_records()
           if not (e.get("id") == "r.1" and e["event"] == "span-end")]
    doc = trace_cli.build_waterfalls(evs, "3")
    assert doc == jcli.build_waterfalls(evs, "3")
    hops = {h["id"]: h for h in doc["trees"][0]["hops"]}
    assert hops["r.1"]["open"] is True and hops["r.1"]["dur_ms"] is None
    assert hops["r.2"]["open"] is False


def test_waterfall_cli_text_and_json(tmp_path, capsys):
    path = R.write_sink(tmp_path / "t.jsonl", R.skewed_fleet_records())
    assert trace_cli.main(["waterfall", "3", path]) == 0
    text = capsys.readouterr().out
    assert "serve.hop.client" in text and "REQUEUED" in text
    assert "±1.500" in text
    assert trace_cli.main(["waterfall", "3", "--json", path]) == 0
    assert json.loads(capsys.readouterr().out)["trees"][0]["pids"] == \
        [100, 200, 300]
    assert trace_cli.main(["waterfall", "no-such-rid", path]) == 1


def test_waterfall_tolerates_a_torn_tail(tmp_path, capsys):
    path = R.write_sink(tmp_path / "t.jsonl", R.skewed_fleet_records())
    with open(path, "a") as f:
        f.write('{"event": "span-end", "span": "serve.ho')
    assert trace_cli.main(["waterfall", "3", path]) == 0
    assert trace_cli.main(["summary", path]) == 2


def test_export_emits_flow_arrows_across_pid_lanes():
    doc = trace_cli.to_chrome_trace(R.skewed_fleet_records())
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "flow"]
    assert [e["ph"] for e in sorted(flows, key=lambda e: e["ts"])] \
        == ["s", "t", "t", "t", "t", "t", "f"]
    assert len({e["id"] for e in flows}) == 1
    assert [e for e in flows if e["ph"] == "f"][0]["bp"] == "e"


def test_export_single_hop_request_gets_no_flow():
    evs = [
        R._hop("span-begin", "serve.hop.client", "c.9", None, 100, 1.0,
               rid=9),
        R._hop("span-end", "serve.hop.client", "c.9", None, 100, 1.1,
               ms=100.0, rid=9),
    ]
    doc = trace_cli.to_chrome_trace(evs)
    assert not [e for e in doc["traceEvents"] if e.get("cat") == "flow"]


# ------------------------------------------------- metrics and flight

def test_load_metrics_snapshot_equal_reference(record_sets, tmp_path):
    snap = {"counters": {"a.b": 2}, "gauges": {"g": 1.5},
            "histograms": {}}
    doc = tmp_path / "snap.json"
    doc.write_text(json.dumps(snap))
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps({"reason": "x", "events": [],
                                "metrics": snap}))
    for path in (*record_sets["port_cpu"], *record_sets["jax_cpu"],
                 *record_sets["fleet"][1:2], str(doc), str(dump)):
        assert trace_cli.load_metrics_snapshot(path) == \
            jcli.load_metrics_snapshot(path)
    for path in record_sets["gang"]:
        with pytest.raises(trace_cli.TraceParseError):
            trace_cli.load_metrics_snapshot(path)


def test_trace_metrics_renders_the_reference_s_exposition(record_sets,
                                                          capsys):
    for path in (*record_sets["port_cpu"], *record_sets["jax_cpu"]):
        assert jcli.main(["metrics", path]) == 0
        ref = capsys.readouterr().out
        assert trace_cli.main(["metrics", path]) == 0
        assert capsys.readouterr().out == ref
        assert "# TYPE" in ref
    assert trace_cli.main(["metrics", record_sets["gang"][0]]) == 2
    assert "no metrics snapshot" in capsys.readouterr().err


def _dump_pair(tmp_path, monkeypatch):
    """A flight dump of each package, taken at the same point."""
    paths = {}
    for name, tr, me, fl in (("jax", jtrace, jmetrics, jflight),
                             ("port", trace, metrics, flight)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv(fl.FLIGHT_DIR_ENV, str(d))
        me.counter("serve.batches").inc(2)
        with tr.span("serve.batch", op="echo", shape_class="k", size=2):
            try:
                raise RuntimeError("ladder exhausted")
            except RuntimeError as e:
                paths[name] = fl.dump("serve-crash", exc=e)
    monkeypatch.delenv(flight.FLIGHT_DIR_ENV)
    return paths


def test_load_and_render_flight_equal_reference(tmp_path, monkeypatch):
    paths = _dump_pair(tmp_path, monkeypatch)
    for path in paths.values():
        doc = trace_cli.load_flight(path)
        assert doc == jcli.load_flight(path)
        ref, ours = io.StringIO(), io.StringIO()
        jcli.render_flight(copy.deepcopy(doc), out=ref)
        trace_cli.render_flight(copy.deepcopy(doc), out=ours)
        ref_lines = ref.getvalue().splitlines()
        lines = ours.getvalue().splitlines()
        assert len(lines) == len(ref_lines)
        differ = [i for i, (a, b) in enumerate(zip(lines, ref_lines))
                  if a != b]
        assert differ == [1] and lines[1].startswith("  platform: python")


def test_flight_platform_line_names_torch_and_cuda(tmp_path, monkeypatch,
                                                   capsys):
    import torch

    path = _dump_pair(tmp_path, monkeypatch)["port"]
    assert trace_cli.main(["flight", path]) == 0
    platform = capsys.readouterr().out.splitlines()[1]
    assert f"torch {torch.__version__}" in platform
    assert f"CUDA {torch.version.cuda}" in platform


def test_trace_flight_renders_dump(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    metrics.counter("serve.batches").inc(2)
    with trace.span("serve.batch", op="echo", shape_class="k", size=2):
        try:
            raise RuntimeError("ladder exhausted")
        except RuntimeError as e:
            path = flight.dump("serve-crash", exc=e)
    assert trace_cli.main(["flight", path]) == 0
    out = capsys.readouterr().out
    assert "flight dump: reason 'serve-crash'" in out
    assert "ladder exhausted" in out
    assert "serve.batch" in out
    assert "metrics at death: 1 counters" in out


def test_trace_flight_rejects_non_dump(tmp_path, capsys):
    bad = tmp_path / "not-a-dump.json"
    bad.write_text('{"counters": {}}')
    assert trace_cli.main(["flight", str(bad)]) == 2
    assert "not a flight dump" in capsys.readouterr().err
    torn = tmp_path / "torn.json"
    torn.write_text('{"reason": ')
    assert trace_cli.main(["flight", str(torn)]) == 2


def test_trace_workload_dispatches(tmp_path, capsys):
    from cme213_tpu_torch import models

    assert {"trace", "collect", "top", "numerics"} <= set(models.WORKLOADS)
    paths = _gang(tmp_path)
    assert models.dispatch(["trace", "summary", *paths, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["events"] == 14
    assert os.path.basename(paths[0]) == "trace-main.jsonl"


# ------------------------------------- what the traced runs leave behind

def test_kernel_launches_reach_the_exit_snapshot(tmp_path):
    """A process's kernel launches land in its last ``metrics-snapshot``
    as ``kernel.launches.<kernel>`` counters, which ``trace metrics``
    renders; a process that launched nothing adds none."""
    import subprocess
    import sys

    sink = tmp_path / "s.jsonl"
    code = ("import cme213_tpu_torch.ops as ops\n"
            "from cme213_tpu_torch.core import metrics\n"
            "metrics.counter('x').inc()\n"
            "ops.stencil_pipeline.LAUNCHES['pipeline'] += 1006\n"
            "ops.segmented_pallas.LAUNCHES['spmv_fused'] += 26\n")
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env.update(CME213_TRACE_FILE=str(sink), PYTHONPATH=R.REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    snap = trace_cli.load_metrics_snapshot(str(sink))
    assert snap["counters"] == {"x": 1, "kernel.launches.pipeline": 1006,
                                "kernel.launches.spmv_fused": 26}
    from cme213_tpu_torch.core.metrics import render_prometheus

    assert "kernel_launches_pipeline" in render_prometheus(snap)


def test_run_all_profile_dir_hook(tmp_path, monkeypatch, capsys):
    """``CME213_PROFILE_DIR`` wraps the sweeps in ``torch.profiler`` and
    writes a Chrome trace there; on the CPU there is no device memory to
    snapshot.  The rows are those of an unprofiled run."""
    from cme213_tpu_torch.bench import run_all

    argv = ["--quick", "--only", "scan_bandwidth", "--device=cpu"]
    assert run_all.main(["--out", str(tmp_path / "plain"), *argv]) == 0
    prof = tmp_path / "prof"
    monkeypatch.setenv(run_all.PROFILE_DIR_ENV, str(prof))
    assert run_all.main(["--out", str(tmp_path / "out"), *argv]) == 0
    traces = sorted(prof.glob("trace-*.json"))
    assert len(traces) == 1
    doc = json.loads(traces[0].read_text())
    assert doc["traceEvents"]
    assert not trace.events("device-memory")
    assert not list(prof.glob("memory_*.json"))
    rows = (tmp_path / "out" / "scan_bandwidth.csv").read_text()
    plain = (tmp_path / "plain" / "scan_bandwidth.csv").read_text()
    assert [r.split(",")[:2] for r in rows.splitlines()] == \
        [r.split(",")[:2] for r in plain.splitlines()]

    def broken(path):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(trace, "device_trace", broken)
    capsys.readouterr()
    assert run_all.main(["--out", str(tmp_path / "out2"), *argv]) == 0
    assert "CME213_PROFILE_DIR: profiler unavailable (RuntimeError: no " \
        "profiler here)" in capsys.readouterr().err
    assert (tmp_path / "out2" / "scan_bandwidth.csv").is_file()
