"""The port's five reporting tools against the JAX package's ``tools/``
scripts: on the same artifacts (audit summaries and metrics dumps, stats
CSVs, traces, event logs, task records, time series, capacity ledgers,
profile spools, run ledgers, or one live obs server) each prints the same
output and exits with the same code.

The port's tools are modules of the package (``python -m
ray_shuffling_data_loader_tpu_torch.<tool>``) on its own telemetry
modules; the JAX tools are loaded from their files here only, to compare.
"""

import csv
import importlib
import importlib.util
import json
import os
import re
import socket

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
TOOLS = ("audit_report", "epoch_report", "run_ledger", "rsdl_prof", "rsdl_top")
_JAX_TOOLS = {}


def _jax_tool(name):
    if name not in _JAX_TOOLS:
        spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JAX_TOOLS[name] = mod
    return _JAX_TOOLS[name]


def _port_tool(name):
    return importlib.import_module(f"ray_shuffling_data_loader_tpu_torch.{name}")


def _run(mod, argv, capsys):
    rc = mod.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


# A capacity row's age is the fold's clock less the segment's stamp: each
# run of a tool reads its own clock.
_AGE = re.compile(r'"oldest_age_s": [-0-9.e+]+')


def _same(name, argv, capsys):
    """``(rc, stdout, stderr)`` of the port's tool, after checking that the
    JAX tool gives the same on the same arguments."""
    got = _run(_port_tool(name), argv, capsys)
    want = _run(_jax_tool(name), argv, capsys)
    assert (got[0], _AGE.sub("_", got[1]), got[2]) == (want[0], _AGE.sub("_", want[1]), want[2])
    return got


def _ndjson(path, records):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)


def _json(path, obj, noise=False):
    with open(path, "w") as f:
        if noise:  # log lines around the JSON line, for the tolerant parser
            f.write("[bench] a log line\n")
        f.write(json.dumps(obj) + "\n")
    return str(path)


def test_tools_and_the_resolver_load_no_torch_and_no_jax():
    """The tools and the URI resolver (which the pool's workers import)
    load neither ``torch`` nor anything of JAX, and no tool loads a file by
    path."""
    import subprocess
    import sys

    for name in TOOLS:
        with open(os.path.join(REPO, "ray_shuffling_data_loader_tpu_torch", f"{name}.py")) as f:
            assert "spec_from_file_location" not in f.read(), name
    script = (
        f"import sys; sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        f"for name in {TOOLS!r} + ('utils', 'shuffle', 'data_generation', 'stats'):\n"
        "    importlib.import_module('ray_shuffling_data_loader_tpu_torch.' + name)\n"
        "print('LOADED', sorted({m.split('.')[0] for m in sys.modules} & "
        "{'torch', 'jax', 'flax', 'optax', 'ray_shuffling_data_loader_tpu', 'fsspec'}))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


# -- audit_report ----------------------------------------------------------------------


def _verdict(epoch, ok, delivered=2000):
    return {"epoch": epoch, "ok": ok, "mismatch": [] if ok in (True, None) else ["delivered"],
            "rows_mapped": 2000, "rows_reduced": 2000, "rows_delivered": delivered, "rows_consumed": delivered,
            "map_digest": "aa:bb", "reduce_digest": "aa:bb", "delivered_digest": "aa:bb" if ok else "dd:ee",
            "delivered_seq": f"{epoch:04x}", "adjacent_pair_retention": None if epoch == 0 else 0.001,
            "mean_normalized_displacement": 0.34, "source_entropy_mean": 0.98}


def _audit_artifacts(tmp_path, ok):
    epochs = [_verdict(0, True), _verdict(1, ok, 2000 if ok else 1999)]
    bench = _json(tmp_path / "bench.json", {"metric": "m", "value": 1.5, "unit": "GB/s", "vs_baseline": 0.9,
                                            "stall_pct": 3.2, "backend": "cuda", "loader": "mapreduce",
                                            "audit": {"ok": ok, "mismatch_epochs": [] if ok else [1],
                                                      "epochs": epochs}}, noise=True)
    audit_json = _json(tmp_path / "audit.json", {"ok": ok, "mismatch_epochs": [] if ok else [1], "epochs": epochs})
    metrics = _json(tmp_path / "run.metrics.json", {"samples": [], "final": {
        "audit.rows_mapped": 4000.0, "audit.rows_delivered": 4000.0 if ok else 3999.0,
        "audit.digest_mismatch": 0.0 if ok else 1.0, "audit.epoch_ok{epoch=0}": 1.0,
        "audit.epoch_ok{epoch=1}": 1.0 if ok else 0.0, "audit.adjacent_pair_retention{epoch=1}": 0.001}})
    trial = str(tmp_path / "trial_stats.csv")
    with open(trial, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["trial", "duration", "num_rows", "num_epochs", "row_throughput",
                                          "audit_epochs_ok", "audit_mismatch_epochs"])
        w.writeheader()
        w.writerow({"trial": 0, "duration": 12.5, "num_rows": 2000, "num_epochs": 2, "row_throughput": 320.0,
                    "audit_epochs_ok": 2 if ok else 1, "audit_mismatch_epochs": "" if ok else "1"})
    epoch_csv = str(tmp_path / "epoch_stats.csv")
    with open(epoch_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["trial", "epoch", "duration", "map_stage_duration",
                                          "reduce_stage_duration", "throttle_duration"])
        w.writeheader()
        for trial_id in (0, 1):
            for e in (0, 1):
                w.writerow({"trial": trial_id, "epoch": e, "duration": 5.0 + e + 10 * trial_id,
                            "map_stage_duration": 2.0, "reduce_stage_duration": 1.5, "throttle_duration": 0.1})
    return {"bench": bench, "audit": audit_json, "metrics": metrics, "trial": trial, "epoch": epoch_csv}


AUDIT_CASES = {
    "full_join": (True, ["--bench", "{bench}", "--metrics", "{metrics}", "--trial-csv", "{trial}", "--epoch-csv",
                         "{epoch}"], 0),
    "audit_json": (True, ["--audit-json", "{audit}", "--epoch-csv", "{epoch}", "--trial-csv", "{trial}"], 0),
    "mismatch": (False, ["--bench", "{bench}"], 1),
    "mismatch_json": (False, ["--bench", "{bench}", "--metrics", "{metrics}", "--json"], 1),
    "metrics_only": (True, ["--metrics", "{metrics}", "--json"], 0),
    "metrics_only_mismatch": (False, ["--metrics", "{metrics}"], 1),
    "usage": (True, [], 2),
    "missing_file": (True, ["--bench", "{bench}.nope"], 2),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_report_matches_jax(tmp_path, capsys, case):
    ok, argv, rc = AUDIT_CASES[case]
    paths = _audit_artifacts(tmp_path, ok)
    got = _same("audit_report", [a.format(**paths) for a in argv], capsys)
    assert got[0] == rc
    if case == "full_join":
        assert "value: 1.5" in got[1] and "row_throughput: 320.0" in got[1] and "epoch_s" in got[1]


def test_audit_report_zero_coverage_is_not_a_pass(tmp_path, capsys):
    bench = _json(tmp_path / "bench.json", {"metric": "m", "value": 1.0, "audit": {"ok": None, "epochs": [
        {"epoch": 0, "ok": None, "detail": "no records"}, {"epoch": 1, "ok": None, "detail": "no records"}]}})
    rc, _, err = _same("audit_report", ["--bench", bench], capsys)
    assert rc == 3 and "zero coverage" in err


# -- epoch_report ----------------------------------------------------------------------


def _span(name, epoch, start_s, dur_s, **args):
    return {"name": name, "cat": "x", "ph": "X", "ts": start_s * 1e6, "dur": dur_s * 1e6, "pid": 1, "tid": 1,
            "args": {"epoch": epoch, **args}}


def _trace(tmp_path, spans, name="trace.json"):
    return _json(tmp_path / name, {"traceEvents": spans})


def _task(stage, epoch, dur, host="hA", pid=1, ts=10.0, **kw):
    return {"ts": ts, "stage": stage, "host": host, "pid": pid, "epoch": epoch, "dur_s": dur, **kw}


def _cap(op, rid, ts, nbytes=0, tier=None, epoch=None, **kw):
    rec = {"ts": ts, "op": op, "id": rid, "pid": 1, **kw}
    if nbytes:
        rec["nbytes"] = nbytes
    if tier:
        rec["tier"] = tier
    if epoch is not None:
        rec["epoch"] = epoch
    return rec


def _profile(spool, role, pid, hz, stacks):
    os.makedirs(spool, exist_ok=True)
    with open(os.path.join(spool, f"profile-{role}-{pid}.json"), "w") as f:
        json.dump({"source": {"role": role, "host": "h", "pid": pid}, "ts": 1.0, "t0": 0.0, "hz": hz,
                   "samples": sum(s["count"] for s in stacks), "stacks": stacks}, f)
    return spool


def _epoch_inputs(tmp_path):
    """Every artifact the report reads, with two tenants' records."""
    p = {"fixtures": os.path.join(FIXTURES, "epoch_report")}
    p["trace"] = _trace(tmp_path, [
        _span("map", 0, 0.0, 1.0), _span("map", 0, 0.5, 1.0), _span("reduce", 0, 1.0, 8.0),
        _span("deliver", 0, 9.0, 0.2), _span("stage:h2d", 0, 9.1, 0.3),
        _span("stall", 0, 9.5, 0.25, cause="upstream"), _span("stall", 0, 9.8, 0.75, cause="staging"),
        _span("map", 1, 20.0, 0.5), _span("reduce", 1, 20.5, 0.5), _span("stage:h2d", 1, 21.0, 7.0)])
    p["empty_trace"] = _trace(tmp_path, [], "empty.json")
    p["bench"] = _json(tmp_path / "bench.json", {"value": 1.0, "stall_pct": 1.0, "backend": "cuda"})
    p["wrapped"] = _json(tmp_path / "wrapped.json", {"n": 5, "parsed": {"value": 1.0, "stall_pct": 10.0}})
    p["slow"] = _json(tmp_path / "slow.json", {"value": 0.2, "stall_pct": 12.0})
    events = tmp_path / "events"
    _ndjson(events / "events-1.ndjson", [
        {"ts": 10.0, "kind": "epoch.start", "epoch": 0, "job": "dlrm-a--1"},
        {"ts": 11.0, "kind": "stage.retry", "epoch": 0, "stage": "map", "attempt": 1, "job": "dlrm-a--1"},
        {"ts": 11.5, "kind": "stage.retry", "epoch": 0, "stage": "reduce", "attempt": 1, "job": "dlrm-b--2"},
        {"ts": 12.0, "kind": "recovery", "epoch": 0, "counter": "recovery.rematerialized"},
        {"ts": 12.5, "kind": "store.spill", "nbytes": 4096},
        {"ts": 13.0, "kind": "epoch.done", "epoch": 0, "job": "dlrm-a--1"}])
    p["events"] = str(events)
    _ndjson(tmp_path / "metrics" / "tasks" / "tasks-1.ndjson", [
        _task("reduce", 0, 0.2, job="dlrm-a--1"), _task("reduce", 0, 0.25, ts=10.5, job="dlrm-a--1"),
        _task("reduce", 0, 0.21, host="hB", pid=2, ts=11.0, job="dlrm-b--2"),
        _task("reduce", 0, 5.0, host="hB", pid=2, ts=12.0, job="dlrm-a--1"),
        _task("map", 1, 0.3, ts=13.0), _task("map", 1, 0.4, host="hB", pid=2, ts=14.0)])
    p["tasks"] = str(tmp_path / "metrics" / "tasks")
    _ndjson(tmp_path / "ts" / "timeseries.ndjson", [
        {"ts": 100.0, "dt": None, "metrics": {"shuffle.map_rows": {"kind": "counter", "value": 10.0}}},
        {"ts": 102.0, "dt": 2.0, "metrics": {"shuffle.map_rows": {"kind": "counter", "value": 30.0, "rate": 10.0}}},
        {"ts": 104.0, "dt": 2.0, "metrics": {"shuffle.map_rows": {"kind": "counter", "value": 34.0, "rate": 2.0}}}])
    p["ts_dir"] = str(tmp_path)
    _ndjson(tmp_path / "metrics" / "capacity" / "ledger-1.ndjson", [
        _cap("create", "a", 1.0, nbytes=1_000_000, tier="shm", epoch=0, job="dlrm-a--1"),
        _cap("create", "b", 2.0, nbytes=2_000_000, tier="spill", epoch=1, job="dlrm-b--2"),
        _cap("create", "c", 2.5, nbytes=500_000, tier="cache", epoch=0),
        _cap("delete", "a", 3.0)])
    p["metrics"] = str(tmp_path / "metrics")
    _ndjson(tmp_path / "empty-cap" / "ledger-2.ndjson", [])
    p["empty_cap"] = str(tmp_path / "empty-cap" / "ledger-2.ndjson")
    _ndjson(tmp_path / "empty-events" / "events-3.ndjson", [])
    p["empty_events"] = str(tmp_path / "empty-events")
    p["profile"] = _profile(str(tmp_path / "profiles"), "task", 11, 67.0, [
        {"stack": "thread:M;shuffle:_gather_rows", "count": 100, "tags": {"stage": "reduce"}},
        {"stack": "thread:M;shuffle:read_parquet_columns", "count": 40, "tags": {"stage": "map"}}])
    _profile(p["profile"], "driver", 12, 100.0, [{"stack": "thread:M;a:f", "count": 10, "tags": {}}])
    p["empty_profile"] = _profile(str(tmp_path / "empty-profiles"), "task", 13, 67.0, [])
    p["never"] = str(tmp_path / "never-made")
    return p


EPOCH_CASES = {
    "fixture_clean": (["--trace", "{fixtures}/trace.json", "--epoch-csv", "{fixtures}/epoch_stats.csv", "--bench",
                       "{fixtures}/bench_clean.json", "--baseline", "{fixtures}/baseline.json"], 0),
    "fixture_regressed": (["--trace", "{fixtures}/trace.json", "--bench", "{fixtures}/bench_regressed.json",
                           "--baseline", "{fixtures}/baseline.json"], 1),
    "fixture_json": (["--trace", "{fixtures}/trace.json", "--epoch-csv", "{fixtures}/epoch_stats.csv", "--json"], 0),
    "wrapped_baseline": (["--bench", "{slow}", "--baseline", "{wrapped}"], 1),
    "thresholds": (["--bench", "{slow}", "--baseline", "{wrapped}", "--threshold-pct", "90",
                    "--stall-threshold-pts", "5"], 0),
    "trace": (["--trace", "{trace}"], 0),
    "empty_trace": (["--trace", "{empty_trace}"], 3),
    "usage": ([], 2),
    "absent_temporal": (["--bench", "{bench}", "--events", "{never}", "--task-records", "{never}", "--timeseries",
                         "{never}", "--capacity", "{never}", "--profile", "{never}"], 0),
    "present_empty_events": (["--bench", "{bench}", "--events", "{empty_events}"], 3),
    "events_and_stragglers": (["--trace", "{trace}", "--events", "{events}", "--task-records", "{tasks}"], 0),
    "events_and_stragglers_json": (["--events", "{events}", "--task-records", "{tasks}", "--json"], 0),
    "straggler_k": (["--task-records", "{tasks}", "--straggler-k", "1.5"], 0),
    "timeseries_dir": (["--timeseries", "{ts_dir}", "--json"], 0),
    "capacity_spool": (["--capacity", "{metrics}"], 0),
    "capacity_json": (["--capacity", "{metrics}/capacity", "--json"], 0),
    "capacity_empty": (["--capacity", "{empty_cap}"], 3),
    "capacity_absent": (["--bench", "{bench}", "--capacity", "{never}"], 0),
    "profile": (["--profile", "{profile}"], 0),
    "profile_json": (["--trace", "{trace}", "--profile", "{profile}", "--json"], 0),
    "profile_never_made": (["--bench", "{bench}", "--profile", "{never}"], 0),
    "profile_empty": (["--bench", "{bench}", "--profile", "{empty_profile}"], 3),
    "job": (["--events", "{events}", "--task-records", "{tasks}", "--capacity", "{metrics}", "--job", "dlrm-a"], 0),
    "job_json": (["--events", "{events}", "--task-records", "{tasks}", "--capacity", "{metrics}", "--job",
                  "dlrm-b--2", "--json"], 0),
    "everything": (["--trace", "{trace}", "--events", "{events}", "--task-records", "{tasks}", "--timeseries",
                    "{ts_dir}", "--capacity", "{metrics}", "--profile", "{profile}", "--bench", "{bench}"], 0),
}


@pytest.mark.parametrize("case", sorted(EPOCH_CASES))
def test_epoch_report_matches_jax(tmp_path, capsys, case):
    argv, rc = EPOCH_CASES[case]
    paths = _epoch_inputs(tmp_path)
    got = _same("epoch_report", [a.format(**paths) for a in argv], capsys)
    assert got[0] == rc, got
    out, err = got[1], got[2]
    if case == "fixture_clean":
        assert "critical_path: reduce" in out
    elif case == "events_and_stragglers":
        assert "straggler table" in out and "STRAGGLER:" in out and "notable events" in out
    elif case == "capacity_spool":
        assert "capacity ledger" in out and "spill" in out and "shm" in out
    elif case == "profile":
        assert "hot frames (profile)" in out and "shuffle:_gather_rows" in out
    elif case == "profile_never_made":
        assert "no profile spool present" in err
    elif case in ("profile_empty", "present_empty_events", "capacity_empty"):
        assert "present but empty" in err
    elif case == "job_json":
        report = json.loads(out)
        # Its one record of epoch 0, and the unstamped records of epoch 1.
        assert {r["epoch"]: r["tasks"] for r in report["stragglers"]} == {0: 1, 1: 2}
        assert report["header"]["events_by_kind"]["stage.retry"] == 1


def test_epoch_report_posthoc_matches_the_live_critical_path():
    """The post-hoc report and the port's live ``/critical`` analyzer give
    the same verdicts and figures on the same intervals (both are the
    port's ``telemetry/critical.py``), and the JAX report the same rows."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import critical

    fixture = {0: {"map": [(0.0, 6.0), (2.0, 8.0)], "reduce": [(5.0, 9.0)]},
               1: {"map": [(0.0, 2.0)], "reduce": [(1.0, 9.5), (3.0, 4.0)]},
               2: {"map": [(0.0, 4.0)], "reduce": [(0.0, 4.0)]}}  # an exact tie
    records = [{"ts": b, "dur_s": b - a, "stage": s, "epoch": e, "host": "h", "pid": 1}
               for e, stages in fixture.items() for s, ivs in stages.items() for a, b in ivs]
    spans = [{"name": s, "ph": "X", "ts": a * 1e6, "dur": (b - a) * 1e6, "pid": 1, "tid": 1, "args": {"epoch": e}}
             for e, stages in fixture.items() for s, ivs in stages.items() for a, b in ivs]
    live = critical.analyze(records=records, now=100.0)
    by_epoch = {r["epoch"]: r for r in live["epochs"]}
    posthoc = _port_tool("epoch_report").collect_epochs(spans)
    assert posthoc == _jax_tool("epoch_report").collect_epochs(spans)
    assert set(by_epoch) == set(posthoc) == set(fixture)
    for epoch in fixture:
        assert by_epoch[epoch]["critical_path"] == posthoc[epoch]["critical_path"]
        for key in ("wall_s", "idle_s", "overlap_s", "map_s", "map_sole_s", "reduce_s", "reduce_sole_s"):
            assert by_epoch[epoch][key] == pytest.approx(posthoc[epoch][key], abs=1e-6), (epoch, key)
    assert posthoc[2]["critical_path"] == "reduce"
    report = _port_tool("epoch_report").build_report(spans, [], [], None, None, 10.0, 10.0)
    assert report["header"]["critical_path"] == live["run_critical_path"]


# -- run_ledger ------------------------------------------------------------------------


def _ledgers(tmp_path):
    clean = os.path.join(FIXTURES, "run_ledger", "clean.ndjson")
    with open(clean) as f:
        base_line = f.readline()
    head = json.loads(base_line)
    head.update(id="run-ffff-1", status="failed")
    head.pop("throughput", None)
    (tmp_path / "failed.ndjson").write_text(base_line + json.dumps(head) + "\n")
    (tmp_path / "empty.ndjson").write_text("")
    return {"clean": clean, "regressed": os.path.join(FIXTURES, "run_ledger", "regressed.ndjson"),
            "failed": str(tmp_path / "failed.ndjson"), "empty": str(tmp_path / "empty.ndjson"),
            "missing": str(tmp_path / "missing.ndjson")}


LEDGER_CASES = {
    "list": (["--ledger", "{clean}", "list"], 0),
    "list_default": (["--ledger", "{regressed}"], 0),
    "list_limit_json": (["--ledger", "{clean}", "list", "--limit", "1", "--json"], 0),
    "list_empty": (["--ledger", "{missing}", "list"], 0),
    "show_prefix": (["--ledger", "{clean}", "show", "run-18f2a4"], 0),
    "show_newest": (["--ledger", "{clean}", "show", "-1"], 0),
    "show_missing": (["--ledger", "{clean}", "show", "run-nope"], 3),
    "diff": (["--ledger", "{regressed}", "diff", "0", "1"], 0),
    "diff_same": (["--ledger", "{clean}", "diff", "0", "0"], 0),
    "diff_missing": (["--ledger", "{clean}", "diff", "0", "run-nope"], 3),
    "regress_clean": (["--ledger", "{clean}", "--regress", "0..1"], 0),
    "regress_regressed": (["--ledger", "{regressed}", "--regress", "0..1"], 1),
    "regress_limits": (["--ledger", "{regressed}", "--regress", "0..1", "--drop-frac", "0.9", "--stall-rise-frac",
                        "50"], 0),
    "regress_missing_ref": (["--ledger", "{clean}", "--regress", "0..run-nope"], 3),
    "regress_empty": (["--ledger", "{empty}", "--regress", "0..1"], 3),
    "regress_bad_spec": (["--ledger", "{clean}", "--regress", "0"], 2),
    "regress_failed_head": (["--ledger", "{failed}", "--regress", "0..1"], 1),
}


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_run_ledger_matches_jax(tmp_path, capsys, case):
    argv, rc = LEDGER_CASES[case]
    got = _same("run_ledger", [a.format(**_ledgers(tmp_path)) for a in argv], capsys)
    assert got[0] == rc, got
    if case == "list":
        assert "run-18f2a3b4c00-4242" in got[1] and got[1].strip().count("\n") == 1
    elif case == "regress_regressed":
        assert "throughput dropped" in got[1] and "stall seconds rose" in got[1]


def test_run_ledger_needs_a_ledger(monkeypatch, capsys):
    monkeypatch.delenv("RSDL_RUN_LEDGER", raising=False)
    assert _same("run_ledger", ["list"], capsys)[0] == 3


def test_run_ledger_over_a_port_shuffle_s_records(tmp_path, monkeypatch, capsys):
    """Records the port's ``shuffle()`` appended, one a run."""
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import runledger

    class _Consumer(BatchConsumer):
        def consume(self, rank, epoch, batches):
            pass

        def producer_done(self, rank, epoch):
            pass

        def wait_until_ready(self, epoch):
            pass

        def wait_until_all_epochs_done(self):
            pass

    ledger = tmp_path / "ledger.ndjson"
    monkeypatch.setenv("RSDL_RUN_LEDGER", str(ledger))
    runtime.init(num_workers=2)
    try:
        files, _ = generate_data(600, 2, 1, 0.0, str(tmp_path / "data"))
        for seed in (1, 2):
            shuffle(files, _Consumer(), num_epochs=1, num_reducers=2, num_trainers=1, seed=seed)
    finally:
        runtime.shutdown()
    records = runledger.read(str(ledger))
    assert [r["status"] for r in records] == ["done", "done"]
    assert _same("run_ledger", ["list"], capsys)[1].strip().count("\n") == 1
    rc, out, _ = _same("run_ledger", ["show", "-1"], capsys)
    assert rc == 0 and json.loads(out)["id"] == records[-1]["id"]
    assert _same("run_ledger", ["diff", "0", "1"], capsys)[0] == 0


# -- rsdl_prof -------------------------------------------------------------------------


def _spools(tmp_path):
    base = _profile(str(tmp_path / "base"), "task", 1, 67.0, [
        {"stack": "thread:M;a:f;b:g", "count": 90, "tags": {"stage": "map", "epoch": "0"}},
        {"stack": "thread:M;a:f;c:h", "count": 10, "tags": {"stage": "reduce", "epoch": "1"}}])
    _profile(base, "driver", 2, 100.0, [{"stack": "thread:M;d:k", "count": 30, "tags": {"job": "j1"}}])
    head = _profile(str(tmp_path / "head"), "task", 1, 67.0, [
        {"stack": "thread:M;a:f;b:g", "count": 10, "tags": {"stage": "map"}},
        {"stack": "thread:M;a:f;c:h", "count": 90, "tags": {"stage": "reduce"}}])
    return {"base": base, "head": head, "none": str(tmp_path / "no"),
            "regressed": os.path.join(FIXTURES, "run_ledger", "regressed.ndjson")}


PROF_CASES = {
    "top": (["top", "--dir", "{base}"], 0),
    "top_json": (["top", "--dir", "{base}", "--json"], 0),
    "top_n": (["top", "--dir", "{base}", "-n", "1"], 0),
    "top_stage": (["top", "--dir", "{base}", "--stage", "reduce", "--json"], 0),
    "top_epoch": (["top", "--dir", "{base}", "--epoch", "0"], 0),
    "top_job": (["top", "--dir", "{base}", "--job", "j1"], 0),
    "top_none": (["top", "--dir", "{none}"], 3),
    "diff": (["diff", "{base}", "{head}"], 0),
    "diff_json": (["diff", "{base}", "{head}", "--json", "-n", "1"], 0),
    "diff_same": (["diff", "{head}", "{head}"], 0),
    "diff_none": (["diff", "{base}", "{none}"], 3),
    "diff_ledger": (["diff", "0", "1", "--ledger", "{regressed}"], 0),
    "diff_ledger_missing": (["diff", "0", "run-nope", "--ledger", "{regressed}"], 3),
}


@pytest.mark.parametrize("case", sorted(PROF_CASES))
def test_rsdl_prof_matches_jax(tmp_path, capsys, case):
    argv, rc = PROF_CASES[case]
    got = _same("rsdl_prof", [a.format(**_spools(tmp_path)) for a in argv], capsys)
    assert got[0] == rc, got
    if case == "top_json":
        assert json.loads(got[1])["top"][0]["frame"] == "b:g"
    elif case == "diff_json":
        shift = json.loads(got[1])
        assert shift["regressed"][0]["frame"] == "c:h" and shift["improved"][0]["frame"] == "b:g"
    elif case == "top_none":
        assert "no profile data" in got[2]


def test_rsdl_prof_flame_matches_jax(tmp_path, capsys):
    paths = _spools(tmp_path)
    pages = {}
    for name, mod in (("port", _port_tool("rsdl_prof")), ("jax", _jax_tool("rsdl_prof"))):
        out = str(tmp_path / "flame.html")
        pages[name] = (_run(mod, ["flame", "--dir", paths["base"], "--stage", "map", "--out", out], capsys),
                       open(out).read())
    assert pages["port"] == pages["jax"]
    assert pages["port"][0][0] == 0 and "<html" in pages["port"][1]


# -- rsdl_top --------------------------------------------------------------------------


@pytest.fixture
def obs_env(monkeypatch, tmp_path):
    from ray_shuffling_data_loader_tpu_torch.runtime import cluster
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, obs_server, slo, timeseries

    for key in [k for k in os.environ if k.startswith("RSDL_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("RSDL_EVENTS_DIR", str(tmp_path / "events"))
    monkeypatch.setenv("RSDL_SLO_RULES", json.dumps([{"name": "rows_moving", "kind": "threshold",
                                                      "metric": "shuffle.map_rows", "op": ">", "value": 0}]))
    monkeypatch.setattr(obs_server, "_providers", {})
    cluster.reset_membership()
    metrics.refresh_from_env()
    for mod in (metrics, timeseries, slo):
        mod.reset()
    yield tmp_path
    obs_server.stop()
    timeseries.stop()
    monkeypatch.undo()
    for mod in (metrics, timeseries, slo):
        mod.reset()
    metrics.refresh_from_env()


def _serve_port(tmp_path):
    """A port obs server over a seeded state: counters, two time-series
    samples, events, task records, a capacity ledger, a fired SLO rule, a
    running trial and a service job."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, obs_server, slo, timeseries

    reg = metrics.registry
    reg.counter("shuffle.map_rows").inc(100)
    reg.gauge("queue.depth", epoch="0", rank="0").set(3)
    reg.counter("recovery.stage_retries", stage="map").inc(2)
    reg.counter("stall_seconds", cause="upstream").inc(0.5)
    timeseries.sample_now(now=1000.0)
    reg.counter("shuffle.map_rows").inc(100)
    timeseries.sample_now(now=1002.0)
    _ndjson(tmp_path / "events" / "events-task-111.ndjson", [
        {"ts": 1001.0, "kind": "epoch.start", "role": "task", "pid": 111, "epoch": 0},
        {"ts": 1002.0, "kind": "stage.retry", "role": "task", "pid": 111, "epoch": 0, "stage": "map", "job": "j1"}])
    _ndjson(tmp_path / "metrics" / "tasks" / "tasks-111.ndjson", [
        _task("map", 0, d, pid=111, ts=1000.0 + i) for i, d in enumerate((0.4, 0.5, 3.0))])
    _ndjson(tmp_path / "metrics" / "capacity" / "ledger-111.ndjson", [
        _cap("create", "seg-a", 1000.0, nbytes=4096, tier="shm", epoch=0)])
    slo.evaluate(now=1003.0)
    obs_server.register_status_provider("shuffle", lambda: {
        "running": True, "job": "_default", "num_epochs": 2, "num_reducers": 2,
        "epochs": {"0": {"state": "done", "delivered_reducers": 2}, "1": {"state": "running",
                                                                          "delivered_reducers": 1}},
        "in_flight_epochs": [1]})
    obs_server.register_status_provider("batch_queue", lambda: {"in_flight_epochs": [1, 2]})
    return f"http://127.0.0.1:{obs_server.start(0)}"


def _strip(value):
    """A frame without what two scrapes of one state differ in."""
    volatile = ("ts", "uptime_s", "pid", "rss_bytes", "seconds", "age_s", "oldest_age_s", "started_ts")
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if k not in volatile and not k.endswith("_free_bytes")}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


@pytest.mark.parametrize("fleet", [False, True])
def test_rsdl_top_once_json_against_a_port_obs_server(obs_env, capsys, fleet):
    url = _serve_port(obs_env)
    argv = ["--url", url, "--once", "--json"] + (["--fleet"] if fleet else [])
    rc, out, _ = _run(_port_tool("rsdl_top"), argv, capsys)
    jrc, jout, _ = _run(_jax_tool("rsdl_top"), argv, capsys)
    frame = json.loads(out)
    assert rc == jrc == 0 and _strip(frame) == _strip(json.loads(jout))
    assert frame["status"]["in_flight_epochs"] == [1, 2]
    assert frame["alerts"]["active"] == ["rows_moving"]
    assert frame["stragglers"]["stages"]["map"]["count"] == 3
    assert "error" not in frame["jobs"] and "error" not in frame["capacity"]
    # One frame renders the same text through either tool.
    for job in (None, "j1"):
        shown = dict(frame, job_filter=job) if job else frame
        assert _port_tool("rsdl_top").render(shown) == _jax_tool("rsdl_top").render(shown)
    assert _port_tool("rsdl_top").render_fleet(frame) == _jax_tool("rsdl_top").render_fleet(frame)
    # The text frame: its heading and gauges (clock, uptime, rss) are each
    # scrape's own.
    rc, out, _ = _run(_port_tool("rsdl_top"), [a for a in argv if a != "--json"], capsys)
    assert rc == 0 and out.startswith("rsdl_top --fleet" if fleet else "rsdl_top  ")


def test_rsdl_top_unreachable_exits_1(capsys):
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    for name in ("rsdl_top",):
        got = _run(_port_tool(name), ["--url", f"http://127.0.0.1:{port}", "--once"], capsys)
        want = _run(_jax_tool(name), ["--url", f"http://127.0.0.1:{port}", "--once"], capsys)
        assert got == want and got[0] == 1 and "unreachable" in got[2]


def test_tools_run_as_modules(tmp_path):
    """``python -m ray_shuffling_data_loader_tpu_torch.<tool>``, as a user
    calls them, with the JAX package nowhere on the path."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if not k.startswith(("RSDL_", "JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    ledger = os.path.join(FIXTURES, "run_ledger", "clean.ndjson")
    script = (
        "import runpy, sys\n"
        "sys.modules['ray_shuffling_data_loader_tpu'] = None\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_module(sys.argv[0], run_name='__main__')\n"
    )
    for argv, rc in ((["run_ledger", "--ledger", ledger, "list"], 0), (["audit_report"], 2),
                     (["epoch_report", "--capacity", str(tmp_path / "never")], 3),
                     (["rsdl_prof", "top", "--dir", str(tmp_path / "no")], 3),
                     (["rsdl_top", "--once", "--url", "http://127.0.0.1:1"], 1)):
        proc = subprocess.run([sys.executable, "-c", script, f"ray_shuffling_data_loader_tpu_torch.{argv[0]}",
                               *argv[1:]], capture_output=True, text=True, timeout=60, env=env, cwd=str(tmp_path))
        assert proc.returncode == rc, (argv, proc.stdout, proc.stderr)
