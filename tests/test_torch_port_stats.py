"""The port's stats plane against the JAX package's: the same events give
the same trial, epoch and consume rows and the same CSV headers; a port
shuffle and the resident loader report to a collector actor; the CSVs go
to a local directory or a URI (``memory://`` against the JAX writer,
``file://`` against the local write)."""

import asyncio
import csv
import sys
import time
import uuid

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import stats as jax_stats
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import stats as port_stats
from ray_shuffling_data_loader_tpu_torch.data_generation import KEY_COLUMN, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.resident import DeviceResidentShufflingDataset

NUM_ROWS = 1200


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def files(tmp_path_factory, port_rt):
    names, _ = generate_data(NUM_ROWS, 3, 1, 0.0, str(tmp_path_factory.mktemp("stats")))
    return names


def _drive(mod, audit: bool):
    """One trial's events, the same for either package's collector."""
    c = mod.TrialStatsCollector(2, 2, 3, num_rows=NUM_ROWS, batch_size=100, num_trainers=2, trial=4,
                                num_row_groups_per_file=2, max_concurrent_epochs=2)
    for epoch in range(2):
        c.epoch_start(epoch)
        c.epoch_throttle(epoch, 0.01 * (epoch + 1))
        for i in range(2):
            c.map_start(epoch)
            c.map_done(epoch, 0.5 + i, 0.2 + i)
        for r in range(3):
            c.reduce_start(epoch)
            c.reduce_done(epoch, 0.1 * (r + 1))
            c.consume(r % 2, epoch, 1000 * (r + 1))
    c.report_staging(0, {"bytes_staged": 4_000_000_000, "put_dispatch_s": 2.0, "stall_s": 0.25, "stalls": 2,
                         "peak_device_bytes_in_use": 7})
    c.report_staging(1, {"bytes_staged": 1000, "stall_upstream_s": 0.5})
    c.store_sample(3, 4096, 1024)
    c.store_sample(5, 8192)
    if audit:
        c.audit_epoch(0, {"epoch": 0, "ok": True, "rows_delivered": 600})
        c.audit_epoch(1, {"epoch": 1, "ok": False, "rows_delivered": 599})
    c.metrics_sample(1.0, {"x": 1.0})
    c.trial_done(10.0)
    return asyncio.run(c.get_stats(timeout=1))


# Wall-clock columns: each package measures its own.
CLOCKED = ("duration", "map_stage_duration", "reduce_stage_duration", "consume_stage_duration",
           "time_to_consume", "consume_time", "time_since_epoch_start")


def _comparable(row, trial_duration=False):
    """The row without the clocked columns (a trial's duration is the
    reported one)."""
    return {k: v for k, v in row.items() if not any(c in k for c in CLOCKED) or (trial_duration and k == "duration")}


@pytest.mark.parametrize("audit", [False, True])
def test_collector_rows_match_jax(audit):
    got, want = _drive(port_stats, audit), _drive(jax_stats, audit)
    assert list(got.row()) == list(want.row())
    assert _comparable(got.row(), True) == pytest.approx(_comparable(want.row(), True))
    assert got.row()["audit_mismatch_epochs"] == want.row()["audit_mismatch_epochs"]
    assert len(got.epochs) == len(want.epochs) == 2
    for ge, we in zip(got.epochs, want.epochs):
        assert list(ge.row(got.trial)) == list(we.row(want.trial))
        assert _comparable(ge.row(got.trial)) == pytest.approx(_comparable(we.row(want.trial)))
    assert len(got.metrics_samples) == len(want.metrics_samples) == 1
    assert port_stats.MAX_TIMELINE_SAMPLES == got.store_samples.maxlen == want.store_samples.maxlen


def test_process_stats_writes_the_jax_headers(tmp_path):
    got, want = _drive(port_stats, True), _drive(jax_stats, True)
    summaries = {}
    for name, mod, stats in (("port", port_stats, got), ("jax", jax_stats, want)):
        summaries[name] = mod.process_stats([stats], stats_dir=str(tmp_path / name))
    assert summaries["port"].keys() == summaries["jax"].keys()
    assert summaries["port"]["num_trials"] == 1
    for fname in ("trial_stats.csv", "epoch_stats.csv", "consume_timeline.csv"):
        with open(tmp_path / "port" / fname) as f:
            port_rows = list(csv.reader(f))
        with open(tmp_path / "jax" / fname) as f:
            jax_rows = list(csv.reader(f))
        assert port_rows[0] == jax_rows[0], fname
        assert len(port_rows) == len(jax_rows) > 1, fname


def test_process_stats_appends_and_refuses_a_stale_header(tmp_path):
    stats = _drive(port_stats, False)
    port_stats.process_stats([stats], stats_dir=str(tmp_path))
    port_stats.process_stats([stats], stats_dir=str(tmp_path), overwrite_stats=False)
    with open(tmp_path / "trial_stats.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
    with open(tmp_path / "trial_stats.csv") as f:
        lines = f.read().splitlines()
    with open(tmp_path / "trial_stats.csv", "w") as f:
        f.write("\n".join([",".join(lines[0].split(",")[:-2])] + lines[1:]) + "\n")
    with pytest.raises(ValueError, match="does not match"):
        port_stats.process_stats([stats], stats_dir=str(tmp_path), overwrite_stats=False)


def test_get_stats_times_out_before_done():
    with pytest.raises(asyncio.TimeoutError):
        asyncio.run(port_stats.TrialStatsCollector(1, 1, 1).get_stats(timeout=0.05))


def test_shuffle_reports_to_a_collector_actor(files):
    num_epochs, num_reducers = 2, 3
    collector = port_runtime.spawn_actor(
        port_stats.TrialStatsCollector, num_epochs, len(files), num_reducers, NUM_ROWS, 100, 1,
        name=f"stats-{uuid.uuid4().hex[:8]}",
    )
    collector.wait_ready()
    try:
        ds = ShufflingDataset(files, num_epochs, 1, 100, 0, num_reducers=num_reducers, seed=3,
                              queue_name=f"stats-{uuid.uuid4().hex[:8]}", stats_collector=collector)
        for epoch in range(num_epochs):
            ds.set_epoch(epoch)
            assert sum(b.num_rows for b in ds) == NUM_ROWS
        ds.join(timeout=60)
        stats = collector.call("get_stats", 30)
        assert collector.call("_counts_complete")
    finally:
        collector.terminate()
    assert isinstance(stats, port_stats.TrialStats)
    assert stats.duration > 0 and len(stats.epochs) == num_epochs
    for e in stats.epochs:
        assert len(e.map_durations) == len(e.map_read_durations) == len(files)
        assert len(e.reduce_durations) == len(e.consume_records) == num_reducers
        assert e.duration > 0 and e.map_stage_duration > 0 and e.reduce_stage_duration > 0
        assert all(c.nbytes > 0 and c.rank == 0 for c in e.consume_records)
    assert stats.row()["num_files"] == len(files)


class _InProcess:
    """A collector handle that calls the collector in this process."""

    def __init__(self, collector):
        self.collector = collector

    def call_oneway(self, name, *args):
        getattr(self.collector, name)(*args)


def test_resident_loader_reports_a_trial_row(files):
    num_epochs, batch = 2, 200
    c = port_stats.TrialStatsCollector(num_epochs, 1, 1, num_rows=NUM_ROWS, batch_size=batch)
    ds = DeviceResidentShufflingDataset(files, num_epochs, batch, [KEY_COLUMN], LABEL_COLUMN, seed=3, device="cpu",
                                        stats_collector=_InProcess(c))
    for epoch in range(num_epochs):
        ds.set_epoch(epoch)
        keys = np.concatenate([f[KEY_COLUMN].numpy() for f, _ in ds])
        assert np.array_equal(np.sort(keys), np.arange(NUM_ROWS))
    ds.close()
    stats = asyncio.run(c.get_stats(timeout=5))
    row = stats.row()
    assert row["num_epochs"] == num_epochs and row["duration"] > 0
    assert row["avg_reduce_stage_duration"] > 0
    assert row["total_bytes_staged"] == 2 * 4 * NUM_ROWS
    assert all(len(e.consume_records) == NUM_ROWS // batch for e in stats.epochs)
    assert all(len(e.map_durations) == len(e.reduce_durations) == 1 for e in stats.epochs)


def test_store_sampler(files):
    ref = port_runtime.put_columns({"x": np.arange(1000)})
    try:
        with port_stats.ObjectStoreStatsCollector(sample_period_s=0.05) as sampler:
            time.sleep(0.25)
    finally:
        port_runtime.free(ref)
    assert any(s.total_bytes > 0 for s in sampler.samples)


@pytest.mark.parametrize("num", [0, 950, 999.5, 1500, 2_000_000, 4e11, 7.5e12, -1500])
def test_human_readable_big_num_matches_jax(num):
    assert port_stats.human_readable_big_num(num) == jax_stats.human_readable_big_num(num)


@pytest.mark.parametrize("num", [0, 512, 2048, 1536.4, 3 * 1024**3, 5 * 1024**6])
@pytest.mark.parametrize("precision", [1, 3])
def test_human_readable_size_matches_jax(num, precision):
    assert port_stats.human_readable_size(num, precision) == jax_stats.human_readable_size(num, precision)


def _read_uri(uri):
    import fsspec

    with fsspec.open(uri, "r", newline="") as f:
        return f.read()


CSV_NAMES = ("trial_stats.csv", "epoch_stats.csv", "consume_timeline.csv")


def test_process_stats_to_memory_uri_matches_jax():
    """The same trial through either package's writer to ``memory://``
    gives the same CSVs, byte for byte, and so does an append; a stale
    header refuses the append in both."""
    stats = _drive(port_stats, True)
    run = uuid.uuid4().hex[:8]
    dirs = {"port": f"memory://port-{run}/stats", "jax": f"memory://jax-{run}/stats"}
    for mod, name in ((port_stats, "port"), (jax_stats, "jax")):
        assert mod.process_stats([stats], stats_dir=dirs[name]).keys() == {
            "num_trials", "duration_mean", "duration_std", "row_throughput_mean", "batch_throughput_mean"}
    for fname in CSV_NAMES:
        first = _read_uri(f"{dirs['port']}/{fname}")
        assert first == _read_uri(f"{dirs['jax']}/{fname}") and first.count("\n") > 1, fname
    for mod, name in ((port_stats, "port"), (jax_stats, "jax")):
        mod.process_stats([stats], stats_dir=dirs[name], overwrite_stats=False)
    for fname in CSV_NAMES:
        appended = _read_uri(f"{dirs['port']}/{fname}")
        assert appended == _read_uri(f"{dirs['jax']}/{fname}"), fname
    assert _read_uri(f"{dirs['port']}/trial_stats.csv").count("\r\n") == 3  # the header, the row twice
    import fsspec

    for name in ("port", "jax"):
        text = _read_uri(f"{dirs[name]}/trial_stats.csv")
        header, rest = text.split("\r\n", 1)
        with fsspec.open(f"{dirs[name]}/trial_stats.csv", "w", newline="") as f:
            f.write(",".join(header.split(",")[:-2]) + "\r\n" + rest)
    errors = {}
    for mod, name in ((port_stats, "port"), (jax_stats, "jax")):
        with pytest.raises(ValueError, match="does not match") as exc:
            mod.process_stats([stats], stats_dir=dirs[name], overwrite_stats=False)
        errors[name] = str(exc.value).replace(dirs[name], "<dir>")
    assert errors["port"] == errors["jax"]


def test_process_stats_to_file_uri_is_the_local_write(tmp_path, monkeypatch):
    """``file://`` writes the local directory's CSVs byte for byte, and
    appends as a local write does, with fsspec unimportable."""
    stats = _drive(port_stats, False)
    (tmp_path / "uri").mkdir()
    monkeypatch.setitem(sys.modules, "fsspec", None)
    for overwrite in (True, False):
        port_stats.process_stats([stats], stats_dir=f"file://{tmp_path / 'uri'}", overwrite_stats=overwrite)
        port_stats.process_stats([stats], stats_dir=str(tmp_path / "local"), overwrite_stats=overwrite)
        for fname in CSV_NAMES:
            assert (tmp_path / "uri" / fname).read_bytes() == (tmp_path / "local" / fname).read_bytes(), fname
    with open(tmp_path / "uri" / "trial_stats.csv", newline="") as f:
        assert len(list(csv.DictReader(f))) == 2


def test_process_stats_makes_no_directory_for_a_uri(tmp_path):
    """A URI's directory is the store's (object stores have none): the
    writer makes none, and a missing local one behind ``file://`` raises
    instead of being created."""
    with pytest.raises(OSError):
        port_stats.process_stats([_drive(port_stats, False)], stats_dir=f"file://{tmp_path / 'missing'}")
    assert not (tmp_path / "missing").exists()
