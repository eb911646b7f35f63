"""The journal's audit records and ``replay`` on the port, against the JAX
package: an audited, journaled run writes the JAX package's ``verdict``
and ``deliver`` records; a run suspended and resumed reconciles as an
uninterrupted one; the port's ``replay`` reproduces its own journal and
the JAX package's, re-arms a recorded fault schedule (and clears one the
run did not record), and refuses a tampered verdict and a suspended run
with the JAX tool's exit codes, as it exits on an unparseable schedule;
``tools/audit_report.py`` reads the port's summary and trial CSV.

Verdict digests and row counts are compared exactly; the source entropies
within 1e-12 (their sums follow the spool's record order)."""

import glob
import json
import os
import subprocess
import sys
import uuid

import pytest

from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import stats as port_stats
from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod
from ray_shuffling_data_loader_tpu_torch.telemetry import audit as port_audit

import torch_port_helpers as helpers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ROWS, NUM_FILES, ROW_GROUPS, NUM_REDUCERS, NUM_TRAINERS, SEED = 4000, 4, 2, 4, 2, 11
CHILD_DEADLINE_S = 120
ENTROPY_TOL = 1e-12


def _same_verdict(p, j):
    close = ("source_entropy_mean", "source_entropy_min")
    assert {k: v for k, v in p.items() if k not in close} == {k: v for k, v in j.items() if k not in close}
    for k in close:
        assert abs(p[k] - j[k]) <= ENTROPY_TOL, (k, p[k], j[k])


def _records(path, kind):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [{k: v for k, v in r.items() if k not in ("kind", "ts")} for r in recs if r.get("kind") == kind]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    yield from helpers.audited_sessions(tmp_path_factory, NUM_ROWS, NUM_FILES, ROW_GROUPS, NUM_REDUCERS,
                                        NUM_TRAINERS, SEED)


@pytest.fixture(scope="module")
def journals(both, tmp_path_factory):
    """Each package's journal of the same audited 2-epoch run, and the
    port's verdicts."""
    out = {}
    saved = os.environ.get("RSDL_INDEX_SHUFFLE")
    os.environ["RSDL_INDEX_SHUFFLE"] = "off"
    try:
        for pkg in ("jax", "port"):
            directory = str(tmp_path_factory.mktemp(f"journal-{pkg}"))
            os.environ["RSDL_JOURNAL"] = directory
            try:
                verdicts, _ = both.run(pkg)
            finally:
                del os.environ["RSDL_JOURNAL"]
            (path,) = glob.glob(os.path.join(directory, "run-*.ndjson"))
            out[pkg] = path
            out[f"{pkg}_verdicts"] = verdicts
    finally:
        if saved is None:
            os.environ.pop("RSDL_INDEX_SHUFFLE", None)
        else:
            os.environ["RSDL_INDEX_SHUFFLE"] = saved
    return out


def _replay(path, *args, env_extra=None, jax_tool=False):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RSDL_", "JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    if jax_tool:
        env["JAX_PLATFORMS"] = "cpu"
    cmd = ([os.path.join(REPO, "tools", "replay.py")] if jax_tool
           else ["-m", "ray_shuffling_data_loader_tpu_torch.replay"])
    return subprocess.run([sys.executable, *cmd, path, *args], capture_output=True, text=True,
                          timeout=CHILD_DEADLINE_S, env=env, cwd=REPO)


def test_journaled_run_writes_the_jax_packages_audit_records(journals):
    port_v, jax_v = _records(journals["port"], "verdict"), _records(journals["jax"], "verdict")
    assert [v["epoch"] for v in port_v] == [0, 1] and all(v["ok"] for v in port_v)
    for p, j in zip(port_v, jax_v):
        _same_verdict(p, j)
    for p, v in zip(port_v, journals["port_verdicts"]):
        _same_verdict(p, v)

    def cursor(rec):
        return tuple(rec[k] for k in ("epoch", "reducer", "rank", "rows", "sampled"))

    # The JAX package delivers its epochs concurrently: compare in
    # (epoch, reducer) order, the order of each epoch's delivery.
    port_d = sorted(cursor(r) for r in _records(journals["port"], "deliver"))
    assert port_d == sorted(cursor(r) for r in _records(journals["jax"], "deliver"))
    assert sum(r[3] for r in port_d) == 2 * NUM_ROWS
    # ``sampled``: rank 0's keys so far, up to the sample cap.
    rank0_rows = sum(r[3] for r in port_d if r[0] == 0 and r[2] == 0)
    assert max(r[4] for r in port_d if r[0] == 0) == min(rank0_rows, port_audit.DEFAULT_SAMPLE_KEYS)
    state = jmod.load_run(journals["port"])
    assert state.done and sorted(state.verdicts) == [0, 1]
    assert state.epochs[0].rank_rows[0] == rank0_rows and sum(state.epochs[0].rank_rows.values()) == NUM_ROWS


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_reproduces_both_packages_journals(journals, tmp_path, writer):
    report = tmp_path / "report.json"
    out = _replay(journals[writer], "--json", str(report))
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(report.read_text())
    assert got["ok"] is True and sorted(got["epochs"]) == ["0", "1"]
    recorded = {v["epoch"]: v["delivered_seq"] for v in journals[f"{writer}_verdicts"]}
    for epoch, rep in got["epochs"].items():
        assert rep["ok"] and rep["diverged"] == {} and rep["delivered_seq"] == recorded[int(epoch)]


def _rewrite(path, dest, edit):
    """Copy a journal with ``edit(record)`` applied to every record."""
    with open(path) as f, open(dest, "w") as g:
        for line in f:
            g.write(json.dumps(edit(json.loads(line))) + "\n")
    return str(dest)


def test_replay_exits_1_on_a_tampered_verdict(journals, tmp_path):
    def edit(rec):
        if rec.get("kind") == "verdict" and rec["epoch"] == 1:
            rec["delivered_seq"] = "0123456789abcdef"
        return rec

    out = _replay(_rewrite(journals["port"], tmp_path / "run-tampered.ndjson", edit), "--epoch", "1")
    assert out.returncode == 1, out.stdout + out.stderr
    report = json.loads(out.stdout)
    assert list(report["epochs"]["1"]["diverged"]) == ["delivered_seq"]


# A map crash in every worker's first map (recovered by the stage budget)
# and a delay on the replay's own delivery loop, where it can be counted.
RECORDED_FAULTS = "task.map/task:crash-entry:1x1,queue.producer/driver:delay:1x2"


def test_replay_rearms_a_recorded_fault_schedule(journals, tmp_path):
    def edit(rec):
        if rec.get("kind") == "run":
            rec["identity"]["faults"], rec["identity"]["faults_seed"] = RECORDED_FAULTS, "7"
        return rec

    report = tmp_path / "report.json"
    out = _replay(_rewrite(journals["port"], tmp_path / "run-faults.ndjson", edit), "--json", str(report))
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(report.read_text())
    assert got["faults"] == {"spec": RECORDED_FAULTS, "seed": "7", "fired": {"queue.producer:delay": 2}}
    assert sorted(got["epochs"]) == ["0", "1"]
    assert all(e["ok"] and e["diverged"] == {} for e in got["epochs"].values())


def test_replay_clears_a_schedule_the_run_did_not_record(journals, tmp_path):
    # A poison in the replay's environment would fail every map: the
    # recorded run had none, so the replay runs none.
    report = tmp_path / "report.json"
    out = _replay(journals["port"], "--epoch", "0", "--json", str(report),
                  env_extra={"RSDL_FAULTS": "task.map:crash-entry:1.0", "RSDL_FAULTS_SEED": "3"})
    assert out.returncode == 0, out.stdout + out.stderr
    # The seed is the recorded one (the run's environment may have held one).
    recorded_seed = jmod.load_run(journals["port"]).identity.get("faults_seed")
    assert json.loads(report.read_text())["faults"] == {"spec": None, "seed": recorded_seed, "fired": {}}


def test_an_unparseable_recorded_schedule_exits_as_the_jax_tool(journals, tmp_path):
    def edit(rec):
        if rec.get("kind") == "run":
            rec["identity"]["faults"] = "task.map:crash@epoch=0"
        return rec

    path = _rewrite(journals["port"], tmp_path / "run-bad-faults.ndjson", edit)
    port = _replay(path, "--epoch", "1")
    jax = _replay(path, "--epoch", "1", jax_tool=True)
    # Both tools disarm a schedule that does not parse (their workers must
    # not fail over a typo) and replay the epoch fault-free.
    assert port.returncode == jax.returncode == 0, (port.stderr[-2000:], jax.stderr[-2000:])


class _Suspending(helpers.Drain):
    """Asks the run to suspend once ``after`` reducers were delivered."""

    def __init__(self, rt, after):
        super().__init__(rt)
        self.after, self.seen = after, 0

    def consume(self, rank, epoch, batches):
        super().consume(rank, epoch, batches)
        self.seen += 1
        if self.seen == self.after:
            jmod.request_suspend()


def test_a_suspended_run_resumes_to_the_uninterrupted_verdicts(both, journals, tmp_path, monkeypatch):
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", "off")
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path / "journal"))
    with pytest.raises(jmod.RunSuspended) as suspended:
        both.run("port", consumer=_Suspending(port_runtime, NUM_REDUCERS + 2))
    state = jmod.load_run(suspended.value.journal_path)
    assert state.suspended and not state.verdicts
    assert state.epochs[1].delivered == 2 and state.epochs[1].sampled > 0
    # A suspended run's journal has no verdict to hold a replay to.
    out = _replay(suspended.value.journal_path)
    assert out.returncode == 2 and "no reconciled verdicts" in out.stderr
    stats = {}
    verdicts, _ = both.run("port", resume_from="auto", stats=stats)
    assert stats["resume"]["from_run"] == state.run_id
    assert [v["ok"] for v in verdicts] == [True, True]
    for got, want in zip(verdicts, journals["port_verdicts"]):
        _same_verdict(got, want)


def test_audit_report_reads_the_ports_summary_and_trial_csv(both, tmp_path):
    def report(label, fault):
        collector = port_runtime.spawn_actor(
            port_stats.TrialStatsCollector, 2, NUM_FILES, NUM_REDUCERS, NUM_ROWS, 500, NUM_TRAINERS,
            name=f"audit-report-{uuid.uuid4().hex[:8]}",
        )
        collector.wait_ready()
        try:
            if fault:
                port_audit.inject_fault("drop-row", 1)
            both.run("port", stats_collector=collector)
            trial = collector.call("get_stats", 60)
        finally:
            collector.terminate()
        work = tmp_path / label
        port_stats.process_stats([trial], stats_dir=str(work))
        (work / "audit.json").write_text(json.dumps(port_audit.summary()))
        return subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "audit_report.py"), "--audit-json", str(work / "audit.json"),
             "--trial-csv", str(work / "trial_stats.csv")],
            capture_output=True, text=True, timeout=CHILD_DEADLINE_S,
        ), trial

    clean, trial = report("clean", fault=False)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert [v["ok"] for v in trial.audit_epochs] == [True, True]
    dropped, trial = report("dropped", fault=True)
    assert dropped.returncode == 1, dropped.stdout + dropped.stderr
    assert trial.row()["audit_mismatch_epochs"] == "1"
