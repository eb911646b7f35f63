"""The port's sampling profiler against the JAX package's
``telemetry/profiler.py``.

Parity: seeded spool records of several processes at mixed rates, with
stage, epoch and job tags, through both modules' ``aggregate_profiles``
(every filter), ``top_table``, ``collapsed_text`` (plain and tagged),
``render_flame_html`` and ``digest``; ``diff_digests`` on seeded digest
pairs; and one live thread's collapsed stack.

The port alone, as the JAX tests do: the rate and top-N knobs, the
sampler thread's start, idempotence, stop and spool, a tick that folds
every other thread and never its own, a stack tagged with the phase its
thread has open and the ambient trial, no spool without samples; then
the wiring: a session starts the profiler and its shutdown stops it,
and a pool worker spools a profile of its own whose stacks carry the
worker's phase.

Comparisons are exact."""

import importlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
ENV = ("RSDL_PROFILE", "RSDL_PROFILE_HZ", "RSDL_PROFILE_DIR", "RSDL_PROFILE_TOP_N", "RSDL_METRICS", "RSDL_TRACE",
       "RSDL_TS", "RSDL_JOB_ID")
FRAMES = ("a:f", "b:g", "c:h", "threading:wait", "runtime.tasks:_worker_main", "shuffle:shuffle_map", "d:k")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _refresh():
    for pkg in ROOTS:
        prof = _mod(pkg, "telemetry.profiler")
        prof.stop()
        prof.reset()
        prof.refresh_from_env()
        _mod(pkg, "telemetry.phases").refresh_from_env()


@pytest.fixture
def profile_on(monkeypatch, tmp_path):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_PROFILE", "1")
    monkeypatch.setenv("RSDL_PROFILE_DIR", str(tmp_path / "profiles"))
    _refresh()
    yield str(tmp_path / "profiles")
    monkeypatch.undo()
    _refresh()


def _records(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(4):
        stacks = []
        for _ in range(int(rng.integers(3, 9))):
            depth = int(rng.integers(1, 6))
            frames = ["thread:MainThread"] + [FRAMES[int(i)] for i in rng.integers(len(FRAMES), size=depth)]
            tags = {}
            if rng.random() < 0.7:
                tags["stage"] = ("map", "reduce", "staging")[int(rng.integers(3))]
            if rng.random() < 0.5:
                tags["epoch"] = str(int(rng.integers(2)))
            if rng.random() < 0.3:
                tags["job"] = "j1"
            stacks.append({"stack": ";".join(frames), "count": int(rng.integers(1, 40)), "tags": tags})
        source = {"role": ("task", "driver", "actor", "task")[k], "host": "h", "pid": 100 + k}
        if k == 3:
            source["job"] = "j1"
        out.append({"source": source, "ts": 1.0, "t0": 0.0, "hz": float((67, 100, 50, 67)[k]),
                    "samples": sum(s["count"] for s in stacks), "stacks": stacks})
    return out


def _write(spool, rec):
    os.makedirs(spool, exist_ok=True)
    with open(os.path.join(spool, f"profile-{rec['source']['role']}-{rec['source']['pid']}.json"), "w") as f:
        json.dump(rec, f)


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_tables_and_digest_match_jax(profile_on, monkeypatch, seed):
    for rec in _records(seed):
        _write(profile_on, rec)
    monkeypatch.setenv("RSDL_PROFILE_TOP_N", "5")
    got = {}
    for pkg in ROOTS:
        prof = _mod(pkg, "telemetry.profiler")
        views = [prof.aggregate_profiles(directory=profile_on, include_local=False, **f)
                 for f in ({}, {"stage": "map"}, {"epoch": "1"}, {"job": "j1"}, {"stage": "reduce", "epoch": "0"})]
        got[pkg] = (views, [prof.top_table(v) for v in views], prof.top_table(views[0], n=50),
                    [prof.collapsed_text(v, tagged=t) for v in views for t in (False, True)],
                    prof.render_flame_html(views[0], title="parity"), prof.digest(directory=profile_on),
                    prof.digest(directory=profile_on, n=3), prof.load_records(profile_on))
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["samples"] > 0 and got["port"][5]["top"]


@pytest.mark.parametrize("seed", range(3))
def test_diff_digests_matches_jax(seed):
    rng = np.random.default_rng(seed)

    def digest():
        frames = rng.choice(len(FRAMES), int(rng.integers(2, 7)), replace=False)
        return {"top": [{"frame": FRAMES[int(i)], "self_frac": float(rng.uniform(0, 0.5))} for i in frames]}

    pairs = [(digest(), digest()) for _ in range(4)]
    got = {pkg: [(_mod(pkg, "telemetry.profiler").diff_digests(a, b),
                  _mod(pkg, "telemetry.profiler").diff_digests(b, a["top"], n=2, min_delta=0.05)) for a, b in pairs]
           for pkg in ROOTS}
    assert got["port"] == got["jax"]


def test_collapsed_live_stack_matches_jax():
    parked, release = threading.Event(), threading.Event()

    def parked_probe():
        parked.set()
        release.wait(timeout=30)

    t = threading.Thread(target=parked_probe, daemon=True)
    t.start()
    try:
        assert parked.wait(timeout=10)
        time.sleep(0.05)
        frame = sys._current_frames()[t.ident]
        got = {pkg: _mod(pkg, "telemetry.profiler")._collapse(frame) for pkg in ROOTS}
        del frame
    finally:
        release.set()
        t.join(timeout=10)
    assert got["port"] == got["jax"] and "parked_probe" in got["port"]


# -- the port alone ------------------------------------------------------------------


def test_rate_and_top_n_knobs(profile_on, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch.telemetry import profiler

    assert profiler.hz() == 67.0
    for raw, want in (("200", 200.0), ("6700", 500.0), ("0.1", 1.0), ("junk", 67.0)):
        monkeypatch.setenv("RSDL_PROFILE_HZ", raw)
        assert profiler.hz() == want, raw
    monkeypatch.setenv("RSDL_PROFILE_TOP_N", "7")
    assert profiler.top_n_default() == 7
    monkeypatch.setenv("RSDL_PROFILE_TOP_N", "junk")
    assert profiler.top_n_default() == 20


def test_sampler_lifecycle_and_spool(profile_on):
    from ray_shuffling_data_loader_tpu_torch.telemetry import profiler

    assert profiler.flush() is None and profiler.load_records(profile_on) == []  # nothing to say yet
    profiler.start(period=0.005)
    try:
        (thread,) = [t for t in threading.enumerate() if t.name == "rsdl-profiler"]
        profiler.start(period=0.005)
        assert [t for t in threading.enumerate() if t.name == "rsdl-profiler"] == [thread] and thread.daemon
        deadline = time.time() + 10
        while time.time() < deadline and profiler.snapshot()["samples"] < 5:
            time.sleep(0.01)
    finally:
        profiler.stop()
    assert not profiler.running() and not any(t.name == "rsdl-profiler" for t in threading.enumerate())
    (rec,) = profiler.load_records(profile_on)
    assert rec["samples"] >= 5 and rec["source"]["pid"] == os.getpid() and rec["source"]["role"] == "driver"
    stack = rec["stacks"][0]["stack"]
    assert stack.startswith("thread:") and all(":" in part for part in stack.split(";"))


def test_tick_folds_others_with_their_phase_and_trial(profile_on):
    from ray_shuffling_data_loader_tpu_torch.telemetry import phases, profiler, trace

    ready, release = threading.Event(), threading.Event()

    def staged():
        with phases.stage_profiler("reduce", epoch=3, reducer=1).phase("gather"):
            ready.set()
            release.wait(timeout=30)

    t = threading.Thread(target=staged, name="staged", daemon=True)
    t.start()
    trace.set_context(trial="t9")
    try:
        assert ready.wait(timeout=10)
        profiler.reset()
        assert profiler._tick() >= 1
        snap = profiler.snapshot()
        assert snap["samples"] == 1
        (tagged,) = [s for s in snap["stacks"] if s["stack"].startswith("thread:staged;")]
        assert tagged["tags"] == {"stage": "reduce", "phase": "gather", "epoch": "3", "trial": "t9"}
        frames = tagged["stack"].split(";")
        assert any(f.endswith(":staged") for f in frames[:-1]) and frames[-1].startswith("threading:")
        me = threading.current_thread().name
        assert not any(s["stack"].startswith(f"thread:{me};") for s in snap["stacks"])
    finally:
        release.set()
        t.join(timeout=10)
        trace.reset_state()
    assert t.ident not in phases.active_phases()


def test_session_and_pool_worker_profiles(profile_on, monkeypatch, tmp_path):
    """``RSDL_PROFILE`` armed before the session: the session starts the
    driver's sampler, a pool worker runs one and spools its profile at
    the task-done barrier with the worker's phase on its stacks, and the
    session's end stops the driver's and spools it."""
    import torch_port_helpers

    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.telemetry import profiler

    monkeypatch.delenv("RSDL_PROFILE_DIR")
    monkeypatch.setenv("RSDL_PROFILE_HZ", "200")
    ctx = port.runtime.init(num_workers=1)
    spool = os.path.join(ctx.runtime_dir, "profiles")
    try:
        assert profiler.running() and profiler.spool_dir() == spool
        pid = ctx.pool.submit(torch_port_helpers.sleep_in_phase, "map", 0.5).result(timeout=60)
        worker = [r for r in profiler.load_records(spool) if r["source"]["pid"] == pid]
        assert worker and worker[0]["source"]["role"] == "task"
        tags = [s["tags"] for s in worker[0]["stacks"] if s["tags"].get("stage") == "map"]
        assert tags and tags[0]["phase"] == "nap" and tags[0]["epoch"] == "5"
        digest = profiler.digest()
        assert digest["sources"] >= 2 and digest["stages"]["map"] > 0
    finally:
        port.runtime.shutdown()
    assert not profiler.running() and "RSDL_PROFILE_DIR" not in os.environ
