"""The port's critical-path view against the JAX package's
``telemetry/critical.py``.

Parity: the interval core (``merge_intervals``, ``active_profile``,
``profile_epoch`` at both scales, ``run_critical_path``) on seeded
intervals; ``analyze`` over seeded task records with ``now`` injected;
the live ``analyze`` over one spool of task records and registry
snapshots (``stall_by_cause`` from ``stall_seconds{cause=}``); and
``publish_metrics``' ``critical.*`` gauges over two ticks.

The port alone, as the JAX tests do: the merge, the sole-active shares
and the tie toward the later stage, an analysis's rows and current
epoch, the gauges' one-hot path and their zeroing, and the current epoch
taken from the shuffle's live in-flight window.

Comparisons are exact."""

import importlib
import json
import os
import socket

import numpy as np
import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
STAGES = ("map", "plan", "reduce", "gather-reduce", "deliver", "odd")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


@pytest.fixture
def spool(monkeypatch, tmp_path):
    for key in ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_TRACE", "RSDL_PROFILE", "RSDL_TS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    # No trial in either package's live tracker: the current epoch is then
    # the latest seen, whatever an earlier test of this process ran.
    monkeypatch.setattr(_mod("jax", "shuffle"), "_live_jobs", {})
    monkeypatch.setattr(_mod("port", "shuffle"), "_live_jobs", {})

    def refresh():
        for pkg in ROOTS:
            _mod(pkg, "telemetry.metrics").refresh_from_env()
            _mod(pkg, "telemetry.metrics").reset()
            _mod(pkg, "telemetry.stragglers").reset()
            _mod(pkg, "telemetry.critical").reset()

    refresh()
    yield str(tmp_path / "metrics")
    monkeypatch.undo()
    refresh()


def _intervals(rng, n_stages):
    return {STAGES[s]: [(float(a), float(a + rng.uniform(0.0, 3.0))) for a in rng.uniform(0, 10, rng.integers(1, 5))]
            for s in rng.choice(len(STAGES), n_stages, replace=False)}


@pytest.mark.parametrize("seed", range(4))
def test_interval_core_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cases = [_intervals(rng, int(rng.integers(1, 5))) for _ in range(8)]
    cases.append({"map": [(0.0, 4.0)], "reduce": [(0.0, 4.0)]})  # an exact tie
    out = {}
    for pkg in ROOTS:
        crit = _mod(pkg, "telemetry.critical")
        rows = []
        for by_stage in cases:
            merged = {s: crit.merge_intervals(ivs) for s, ivs in by_stage.items()}
            micro = {s: [(a * 1e6, b * 1e6) for a, b in ivs] for s, ivs in by_stage.items()}
            rows.append((merged, {s: crit.intervals_total(m) for s, m in merged.items()},
                         crit.active_profile(merged), crit.profile_epoch(by_stage),
                         crit.profile_epoch(micro, scale=1e6), crit.profile_epoch(by_stage, order=["reduce", "map"])))
        verdicts = [r[3] for r in rows]
        out[pkg] = (rows, crit.run_critical_path(verdicts), crit.run_critical_path(verdicts, order=["reduce", "map"]))
    assert out["port"] == out["jax"]


def _task_records(seed, n=80):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rec = {"ts": 100.0 + float(rng.uniform(0, 50)), "dur_s": float(rng.uniform(0, 6)),
               "stage": STAGES[int(rng.integers(4))], "host": "h", "pid": 1}
        if rng.random() < 0.9:
            rec["epoch"] = int(rng.integers(4))
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_analyze_matches_jax(spool, seed):
    records = _task_records(seed)
    got = {pkg: _mod(pkg, "telemetry.critical").analyze(records=records, now=200.0) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    assert got["port"]["epochs"] and got["port"]["current"]["critical_path"]


def _write_metrics(directory, pid, counters):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"metrics-task-{pid}.json"), "w") as f:
        json.dump({"source": {"role": "task", "host": socket.gethostname(), "pid": pid}, "ts": 1.0,
                   "metrics": {k: {"kind": "counter", "value": v} for k, v in counters.items()}}, f)


def test_live_analyze_and_gauges_match_jax(spool):
    """One spool, both packages: task records and two processes' stall
    counters; the live analysis (memo included, asked twice) and two
    ticks of gauges, the second after the next epoch's records came."""
    records = _task_records(11)
    os.makedirs(os.path.join(spool, "tasks"), exist_ok=True)
    with open(os.path.join(spool, "tasks", "tasks-5.ndjson"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in records if r.get("epoch", 0) < 3)
    _write_metrics(spool, 21, {"stall_seconds{cause=upstream}": 1.5, "stall_seconds{cause=staging}": 0.25})
    _write_metrics(spool, 22, {"stall_seconds{cause=upstream}": 2.0, "other{cause=x}": 9.0})
    got = {}
    for pkg in ROOTS:
        crit, metrics = _mod(pkg, "telemetry.critical"), _mod(pkg, "telemetry.metrics")
        first, again = crit.analyze(now=300.0), crit.analyze(now=300.0)
        crit.publish_metrics(first)
        snap1 = metrics.registry.snapshot()
        got[pkg] = [first, again, snap1, crit.status_section()]
    with open(os.path.join(spool, "tasks", "tasks-5.ndjson"), "a") as f:
        f.writelines(json.dumps(r) + "\n" for r in records if r.get("epoch", 0) == 3)
    for pkg in ROOTS:
        crit, metrics = _mod(pkg, "telemetry.critical"), _mod(pkg, "telemetry.metrics")
        later = crit.analyze(now=301.0)
        crit.publish_metrics(later)
        got[pkg] += [later, metrics.registry.snapshot()]
    for j, p in zip(got["jax"], got["port"]):
        assert p == j
    assert got["port"][0]["stall_by_cause"] == {"upstream": 3.5, "staging": 0.25}
    assert got["port"][4]["current"]["epoch"] == 3


# -- the port alone ------------------------------------------------------------------


def test_merge_profile_and_tie():
    from ray_shuffling_data_loader_tpu_torch.telemetry import critical

    merged = critical.merge_intervals([(3.0, 5.0), (1.0, 2.0), (4.0, 7.0)])
    assert merged == [(1.0, 2.0), (3.0, 7.0)] and critical.intervals_total(merged) == 5.0
    row = critical.profile_epoch({"map": [(0.0, 10.0)], "reduce": [(4.0, 10.0)]})
    assert (row["critical_path"], row["map_sole_s"], row["overlap_s"], row["sole_share"]["map"]) == ("map", 4.0,
                                                                                                    6.0, 0.4)
    row = critical.profile_epoch({"map": [(0.0, 1.0)], "reduce": [(2.0, 3.0)]})
    assert row["critical_path"] == "reduce" and row["idle_s"] == 1.0  # a tie goes to the later stage


def test_analyze_rows_and_current_epoch(spool):
    from ray_shuffling_data_loader_tpu_torch.telemetry import critical

    records = [{"ts": 10.0, "dur_s": 8.0, "stage": "map", "epoch": 0},
               {"ts": 11.0, "dur_s": 1.0, "stage": "reduce", "epoch": 0},
               {"ts": 20.0, "dur_s": 1.0, "stage": "map", "epoch": 1},
               {"ts": 30.0, "dur_s": 9.0, "stage": "reduce", "epoch": 1},
               {"ts": 99.0, "dur_s": 1.0, "stage": "map"}]  # no epoch: not attributed
    analysis = critical.analyze(records=records, now=31.0)
    assert [(r["epoch"], r["critical_path"]) for r in analysis["epochs"]] == [(0, "map"), (1, "reduce")]
    assert analysis["current"]["epoch"] == 1 and analysis["current"]["critical_path"] == "reduce"
    assert analysis["run_critical_path"] == "reduce" and analysis["tasks_total"] == 5


def test_gauges_one_hot_and_zeroed(spool):
    from ray_shuffling_data_loader_tpu_torch.telemetry import critical, metrics

    critical.publish_metrics(critical.analyze(records=[{"ts": 10.0, "dur_s": 8.0, "stage": "map", "epoch": 0},
                                                       {"ts": 11.0, "dur_s": 1.0, "stage": "reduce", "epoch": 0}],
                                              now=12.0))
    snap = metrics.registry.snapshot()
    assert snap["critical.epoch"] == 0.0 and snap["critical.path{stage=map}"] == 1.0
    assert snap["critical.path{stage=reduce}"] == 0.0 and snap["critical.sole_share{stage=map}"] > 0.5
    critical.publish_metrics(critical.analyze(records=[{"ts": 20.0, "dur_s": 2.0, "stage": "plan", "epoch": 1}],
                                              now=22.0))
    snap = metrics.registry.snapshot()
    assert snap["critical.path{stage=map}"] == 0.0 and snap["critical.sole_share{stage=map}"] == 0.0
    assert snap["critical.path{stage=plan}"] == 1.0


def test_current_epoch_follows_the_shuffle_in_flight_window(spool, monkeypatch):
    """With the shuffle module loaded, the current epoch is the latest
    in-flight epoch that has records, not the latest epoch seen."""
    from ray_shuffling_data_loader_tpu_torch import shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import critical

    records = [{"ts": 10.0, "dur_s": 8.0, "stage": "map", "epoch": 0},
               {"ts": 20.0, "dur_s": 1.0, "stage": "reduce", "epoch": 1}]
    shuffle._status_begin_trial(2, 1, 1, 1, 0)
    shuffle._status_epoch(0, state="running")
    shuffle._status_epoch(1, state="done")
    analysis = critical.analyze(records=records, now=21.0)
    assert analysis["in_flight_epochs"] == [0] and analysis["current"]["epoch"] == 0
    assert analysis["current"]["critical_path"] == "map"
