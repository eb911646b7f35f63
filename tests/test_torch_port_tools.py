"""The port's last tools against the JAX package's ``tools/`` scripts, at
tiny shapes on the CPU: ``cached_generate_data`` (one manifest schema for
both packages), ``summarize_sweep`` (the same table), ``shuffle_profile``
(the phase table, the decode sweep's figures, the pipeline's phases under
each forced schedule, the threads sweep's keys) and ``obs_smoke`` (both
gates pass; with the profiler off the default gate fails).

The port's tools are modules of the package (``python -m
ray_shuffling_data_loader_tpu_torch.<tool>``); the JAX tools are loaded
from their files here only, to compare. Every tool that starts a runtime
runs in a process of its own, each under its own deadline."""

import asyncio
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

from ray_shuffling_data_loader_tpu import data_generation as jax_data_generation
from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu.telemetry import export as jax_export
from ray_shuffling_data_loader_tpu_torch import data_generation as port_data_generation
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import shuffle_profile as port_profile
from ray_shuffling_data_loader_tpu_torch import stats as port_stats
from ray_shuffling_data_loader_tpu_torch import summarize_sweep as port_sweep
from ray_shuffling_data_loader_tpu_torch.telemetry import export as port_export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 240
# The pipeline profile's shape: 59,523 rows in 2 files of 2 row groups.
PROFILE_ARGS = ("--gb", "0.01", "--files", "2", "--reducers", "2", "--epochs", "2")


_JAX_TOOLS = {}


def _jax_tool(name):
    if name not in _JAX_TOOLS:
        spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JAX_TOOLS[name] = mod
    return _JAX_TOOLS[name]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RSDL_", "JAX", "XLA"))}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _tool(package, name, *argv, **env):
    """``(exit code, stdout, stderr)`` of a tool run as a user runs it: the
    JAX package's script from ``tools/``, the port's module with ``-m``."""
    cmd = ([sys.executable, os.path.join(REPO, "tools", f"{name}.py")] if package == "jax"
           else [sys.executable, "-m", f"ray_shuffling_data_loader_tpu_torch.{name}"])
    proc = subprocess.run(cmd + list(argv), capture_output=True, text=True, timeout=DEADLINE_S, env=_env(**env),
                          cwd=REPO)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def sessions():
    jax_runtime.init(num_workers=2)
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()
    jax_runtime.shutdown()


def test_tools_load_no_torch_and_no_jax():
    script = (
        f"import sys; sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        "for name in ('shuffle_profile', 'obs_smoke', 'summarize_sweep', 'data_generation'):\n"
        "    importlib.import_module('ray_shuffling_data_loader_tpu_torch.' + name)\n"
        "print('LOADED', sorted({m.split('.')[0] for m in sys.modules} & "
        "{'torch', 'jax', 'flax', 'optax', 'ray_shuffling_data_loader_tpu'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120, env=_env())
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


# -- cached_generate_data ------------------------------------------------------------


def _dataset(directory):
    """Every file's bytes and the manifest's, by name."""
    return {fn: open(os.path.join(directory, fn), "rb").read() for fn in sorted(os.listdir(directory))}


def _mtimes(files):
    return [os.stat(f).st_mtime_ns for f in files]


def test_cached_generate_data_writes_the_jax_dataset_and_manifest(sessions, tmp_path):
    """Into one directory in turn: the same files byte for byte and the
    same manifest; each package's manifest is the other's hit."""
    shape = (3000, 2, 2)
    d = str(tmp_path / "data")
    want = jax_data_generation.cached_generate_data(*shape, d, seed=3)
    jax_bytes = _dataset(d)
    assert sorted(jax_bytes) == ["input_data_0.parquet.snappy", "input_data_1.parquet.snappy", "manifest.json"]
    before = _mtimes(want[0]) + _mtimes([os.path.join(d, "manifest.json")])
    assert port_data_generation.cached_generate_data(*shape, d, seed=3) == tuple(want)
    assert _mtimes(want[0]) + _mtimes([os.path.join(d, "manifest.json")]) == before  # a hit: nothing written
    for fn in os.listdir(d):
        os.remove(os.path.join(d, fn))
    got = port_data_generation.cached_generate_data(*shape, d, seed=3)
    assert got == tuple(want)
    assert _dataset(d) == jax_bytes
    assert json.loads(jax_bytes["manifest.json"]) == {
        "key": {"num_rows": 3000, "num_files": 2, "num_row_groups_per_file": 2, "seed": 3},
        "filenames": want[0], "num_bytes": want[1]}
    before = _mtimes(got[0])
    assert jax_data_generation.cached_generate_data(*shape, d, seed=3) == got
    assert _mtimes(got[0]) == before
    assert port_data_generation.ONE_HOT_COLUMNS == jax_data_generation.ONE_HOT_COLUMNS


@pytest.mark.parametrize("change", ["seed", "corrupt-manifest", "missing-file"])
def test_cached_generate_data_regenerates(sessions, tmp_path, change):
    """A changed seed, a manifest that does not parse and a file gone each
    regenerate, as the JAX package's: the same files again afterwards."""
    shape = (3000, 2, 2)
    d, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    files, _ = port_data_generation.cached_generate_data(*shape, d, seed=3)
    seed = 3
    if change == "seed":
        seed = 4
    elif change == "corrupt-manifest":
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write('{"key": {"num_rows"')
    else:
        os.remove(files[1])
    before = {f: os.stat(f).st_mtime_ns for f in files if os.path.exists(f)}
    got = port_data_generation.cached_generate_data(*shape, d, seed=seed)
    assert all(os.stat(f).st_mtime_ns != t for f, t in before.items())
    want = jax_data_generation.cached_generate_data(*shape, ref, seed=seed)
    assert got[1] == want[1]
    assert [open(f, "rb").read() for f in got[0]] == [open(f, "rb").read() for f in want[0]]
    assert json.load(open(os.path.join(d, "manifest.json")))["key"]["seed"] == seed


# -- summarize_sweep -----------------------------------------------------------------


def _trial(trial, duration, map_s):
    c = port_stats.TrialStatsCollector(2, 2, 8, num_rows=1000, batch_size=100, num_trainers=1, trial=trial)
    for epoch in range(2):
        c.epoch_start(epoch)
        for i in range(2):
            c.map_start(epoch)
            c.map_done(epoch, map_s + i, 0.2)
        for r in range(8):
            c.reduce_start(epoch)
            c.reduce_done(epoch, 0.05 * (r + 1))
            c.consume(0, epoch, 100 * (r + 1))
    c.store_sample(3, 2_500_000_000, 0)
    c.trial_done(duration)
    return asyncio.run(c.get_stats(timeout=1))


def test_summarize_sweep_prints_the_jax_table(tmp_path, monkeypatch, capsys):
    """One ``sweep_results`` tree, the port's ``process_stats`` summaries
    and CSVs in it: the same Markdown table, rows in trainer order."""
    out = tmp_path / "sweep_results"
    for tag, trial in (("t1_r8", _trial(0, 12.5, 0.5)), ("t4_r2", _trial(1, 30.25, 1.5))):
        summary = port_stats.process_stats([trial], stats_dir=str(out / f"stats_{tag}"))
        (out / f"{tag}.json").write_text(json.dumps(summary) + "\n")
    (out / "t2_r4.json").write_text("")  # no summary, no CSV: nan
    (out / "notes.json").write_text("{}")  # not a configuration
    monkeypatch.setattr(port_sweep, "OUT", str(out))
    jax_sweep = _jax_tool("summarize_sweep")
    monkeypatch.setattr(jax_sweep, "OUT", str(out))
    assert port_sweep.main() == 0
    got = capsys.readouterr().out
    jax_sweep.main()
    assert got == capsys.readouterr().out
    lines = got.splitlines()
    assert len(lines) == 5 and lines[2].startswith("| 1 | 8 | 12 | 160 |") and "nan" in lines[3]
    assert lines[4].startswith("| 4 | 2 | 30 | 66 |")


def test_summarize_sweep_reads_the_repos_sweep_results():
    assert port_sweep.OUT == os.path.join(REPO, "tools", "sweep_results") == _jax_tool("summarize_sweep").OUT


# -- shuffle_profile -----------------------------------------------------------------


def test_phase_table_matches_jax():
    flat = {
        "shuffle.phase_seconds{phase=decode:arrow,stage=map}_count": 3.0,
        "shuffle.phase_seconds{phase=decode:arrow,stage=map}_sum": 0.25,
        "shuffle.phase_seconds{phase=decode:arrow,stage=map}_max": 0.125,
        "shuffle.phase_bytes{phase=decode:arrow,stage=map}": 2.0e7,
        "shuffle.phase_seconds{phase=gather,stage=gather-reduce}_count": 2.0,
        "shuffle.phase_seconds{phase=gather,stage=gather-reduce}_sum": 0.0625,
        "shuffle.phase_seconds{phase=plan,stage=plan}_count": 3.0,
        "shuffle.phase_bytes{phase=publish,stage=plan}": 476188.0,
        "shuffle.map_rows": 59523.0,
        "shuffle.phase_seconds{phase=x,stage=map,host=h}_count": 1.0,
    }
    table = port_profile._phase_table(flat)
    assert table == _jax_tool("shuffle_profile")._phase_table(flat)
    assert set(table) == {("map", "decode:arrow"), ("gather-reduce", "gather"), ("plan", "plan"), ("plan", "publish")}
    assert table[("map", "decode:arrow")] == {"count": 3, "total_s": 0.25, "bytes": 2.0e7}


def _profile(package, schedule, tmp_path):
    """One pipeline profile with its metrics spool kept under ``tmp_path``:
    ``(stdout, stderr, the JSON it wrote, the spool's directory)``."""
    spool, out = str(tmp_path / f"spool-{package}-{schedule}"), str(tmp_path / f"{package}-{schedule}.json")
    rc, stdout, stderr = _tool(package, "shuffle_profile", *PROFILE_ARGS, "--schedule", schedule, "--data-dir",
                               str(tmp_path / "data"), "--out", out, RSDL_METRICS_DIR=spool)
    assert rc == 0, stderr[-3000:]
    return stdout, stderr, json.load(open(out)), spool


@pytest.mark.parametrize("schedule", ["mapreduce", "index"])
def test_pipeline_profile_matches_jax(tmp_path, monkeypatch, schedule):
    """Under each forced schedule: the same rows delivered, the same
    ``(stage, phase)`` set with the same task counts and bytes, the same
    schedules run, a non-empty table; the port's prints its pool."""
    runs = {pkg: _profile(pkg, schedule, tmp_path) for pkg in ("jax", "port")}
    tables = {}
    for pkg, export, table_of in (("jax", jax_export, _jax_tool("shuffle_profile")._phase_table),
                                  ("port", port_export, port_profile._phase_table)):
        monkeypatch.setenv("RSDL_METRICS_DIR", runs[pkg][3])
        tables[pkg] = {k: (v["count"], v["bytes"]) for k, v in table_of(export.aggregate(include_local=False)).items()}
    assert tables["port"] == tables["jax"]
    stages = {s for s, _ in tables["port"]}
    assert stages == ({"map", "reduce"} if schedule == "mapreduce" else {"map", "reduce", "plan", "gather-reduce"})
    delivered = {pkg: re.search(r"delivered [0-9.]+ GB \((\d+) rows\)", runs[pkg][0]).group(1) for pkg in runs}
    assert delivered["port"] == delivered["jax"] == str(2 * 59523)
    got, want = runs["port"][2], runs["jax"][2]
    assert got.keys() == want.keys() and got["policy"].keys() == want["policy"].keys()
    assert got["policy"]["schedules_run"] == want["policy"]["schedules_run"] == (
        ["mapreduce", "mapreduce"] if schedule == "mapreduce" else ["mapreduce", "index"])
    assert {(r["stage"], r["phase"]): r["count"] for r in got["phases"]} == {
        (r["stage"], r["phase"]): r["count"] for r in want["phases"]}
    assert got["delivered_gb"] == want["delivered_gb"]
    assert re.search(r"\[profile\] pool: \d+ workers .*ready_s [0-9.]+", runs["port"][1])
    assert "[profile] roofline: single-core memcpy" in runs["port"][0]


def test_pipeline_profile_fails_on_an_empty_table(tmp_path):
    rc, stdout, stderr = _tool("port", "shuffle_profile", "--gb", "0.002", "--files", "2", "--reducers", "2",
                               "--epochs", "1", "--data-dir", str(tmp_path / "data"), RSDL_METRICS="0")
    assert rc == 1 and "no shuffle.phase_* metric" in stderr, stderr[-2000:]


TIMINGS = ("best_s", "gbps", "speedup_vs_1")


def test_decode_sweep_matches_jax(tmp_path):
    """The same decoded and pruned bytes at every thread count, and the
    same selective epochs: groups per reducer, amplification (block:1
    decodes each group once), pruned bytes. The port reads the JAX tool's
    cached dataset through its manifest."""
    argv = ("--decode", "1,2", "--gb", "0.005", "--files", "2", "--reducers", "2", "--data-dir",
            str(tmp_path / "data"))
    results = {}
    for pkg in ("jax", "port"):
        rc, _, stderr = _tool(pkg, "shuffle_profile", *argv, "--out", str(tmp_path / f"{pkg}.json"))
        assert rc == 0, stderr[-3000:]
        results[pkg] = json.load(open(tmp_path / f"{pkg}.json"))
    strip = lambda rows: [{k: v for k, v in r.items() if k not in TIMINGS} for r in rows]  # noqa: E731
    got, want = results["port"], results["jax"]
    assert got.keys() == want.keys()
    assert {k: got[k] for k in ("mode", "shape", "dataset_disk_gb")} == {k: want[k] for k in ("mode", "shape",
                                                                                            "dataset_disk_gb")}
    assert strip(got["sweep"]) == strip(want["sweep"])
    sel, jsel = got["selective_sweep"], want["selective_sweep"]
    assert strip(sel["rows"]) == strip(jsel["rows"])
    assert sel["physical_groups"] == jsel["physical_groups"] == 17  # 2 files of 8 groups and a file of one row
    rowwise, block = sel["rows"]
    assert block["plan"] == "block:1" and block["amplification"] == 1.0 and block["pruned_gb"] > 0
    assert rowwise["amplification"] > 1.0


def test_threads_sweep_keys_match_jax(tmp_path):
    argv = ("--threads", "1,2", "--gb", "0.005", "--files", "2", "--reducers", "2")
    results = {}
    for pkg in ("jax", "port"):
        rc, stdout, stderr = _tool(pkg, "shuffle_profile", *argv, "--out", str(tmp_path / f"{pkg}.json"))
        assert rc == 0, stderr[-3000:]
        results[pkg] = json.load(open(tmp_path / f"{pkg}.json"))
    got, want = results["port"], results["jax"]
    assert got.keys() == want.keys() and got["shape"] == want["shape"]
    assert got["native"] is True
    assert [(r["threads"], r["op"], sorted(r)) for r in got["sweep"]] == [
        (r["threads"], r["op"], sorted(r)) for r in want["sweep"]]
    assert all(r["gbps"] > 0 for r in got["sweep"])


# -- obs_smoke -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["default", "federation"])
def test_obs_smoke_gates_pass(mode):
    rc, stdout, stderr = _tool("port", "obs_smoke", *(["--federation"] if mode == "federation" else []))
    assert rc == 0, stderr[-3000:]
    if mode == "default":
        assert stdout.startswith("obs smoke ok: ") and "'trial.done': 1" in stdout, stdout
    else:
        hosts = re.search(r"hosts=(\[[^\]]*\])", stdout).group(1)
        assert len(json.loads(hosts.replace("'", '"'))) >= 2, stdout


def test_obs_smoke_fails_without_the_profiler():
    rc, stdout, stderr = _tool("port", "obs_smoke", RSDL_PROFILE="0")
    assert rc != 0 and "obs smoke ok" not in stdout
    assert "GateError: the profiler's sampler is not running" in stderr, stderr[-3000:]
