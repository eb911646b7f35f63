"""URI datasets in the port against the JAX package: the resolver, reads,
the shuffle and the resident loader from ``file://`` URIs, generation to a
URI, and Arrow's decode-thread policy.

The port resolves ``file://`` through pyarrow's own ``LocalFileSystem``
where the JAX package goes through fsspec, and imports fsspec only for a
scheme that needs it; so ``file://`` datasets and stats work with fsspec
blocked, in the driver and in every pool worker. As in the JAX package's
tests, only ``memory://`` (in one process) and ``file://`` (across
processes) are used: no cloud and no credentials.
"""

import importlib
import os
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ray_shuffling_data_loader_tpu.utils as jax_utils
from ray_shuffling_data_loader_tpu import data_generation as jax_gen
from ray_shuffling_data_loader_tpu import dataset as jax_dataset
from ray_shuffling_data_loader_tpu.resident import DeviceResidentShufflingDataset as JaxResident
from ray_shuffling_data_loader_tpu.runtime import service as jax_service
import ray_shuffling_data_loader_tpu_torch.utils as port_utils
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, KEY_COLUMN, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.resident import DeviceResidentShufflingDataset, dataset_num_rows
from ray_shuffling_data_loader_tpu_torch.runtime import service as port_service

# The package's ``shuffle`` attribute is the function; the module is imported by name.
jax_shuffle = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")
port_shuffle = importlib.import_module("ray_shuffling_data_loader_tpu_torch.shuffle")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ROWS, NUM_FILES = 4000, 4
FEATURES = [KEY_COLUMN] + [c for c in list(DATA_SPEC)[:3] if c != LABEL_COLUMN]


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def uri_files(port_rt, tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("uri-data")
    filenames, _ = generate_data(NUM_ROWS, NUM_FILES, 2, 0.0, str(data_dir))
    return [f"file://{f}" for f in filenames]


def _qname():
    return f"torch-port-uri-{uuid.uuid4().hex[:8]}"


@pytest.mark.parametrize("path", ["/data/part-0.parquet", "relative/part-0.parquet", "gs://bucket/part-0.parquet",
                                  "file:///data/part-0.parquet", "memory://ds/part-0.parquet"])
def test_is_remote_path_matches_jax(path):
    assert port_utils.is_remote_path(path) == jax_utils.is_remote_path(path)


def test_local_path_passthrough():
    for path in ("/data/part-0.parquet", "relative/part-0.parquet"):
        assert port_utils.parquet_filesystem(path) == jax_utils.parquet_filesystem(path) == (None, path)


def test_file_uri_resolves_through_pyarrow(tmp_path):
    """The port's ``file://`` is pyarrow's LocalFileSystem (the JAX
    package's is fsspec's, wrapped); both name the same path, and a file
    read through either is the local file's bytes."""
    from pyarrow import fs as pafs

    path = tmp_path / "part-0.parquet"
    pq.write_table(pa.table({"key": np.arange(50, dtype=np.int64)}), str(path))
    fs, rel = port_utils.parquet_filesystem(f"file://{path}")
    jfs, jrel = jax_utils.parquet_filesystem(f"file://{path}")
    assert isinstance(fs, pafs.LocalFileSystem) and isinstance(jfs, pafs.PyFileSystem)
    assert rel == jrel == str(path)
    with fs.open_input_file(rel) as f:
        assert f.read() == path.read_bytes()


def test_memory_uri_resolves_as_jax():
    from pyarrow import fs as pafs

    fs, rel = port_utils.parquet_filesystem("memory://ds/part-0.parquet")
    jfs, jrel = jax_utils.parquet_filesystem("memory://ds/part-0.parquet")
    assert isinstance(fs, pafs.PyFileSystem) and isinstance(jfs, pafs.PyFileSystem)
    assert rel == jrel


def test_memory_scheme_read_roundtrip():
    """An fsspec-only scheme (``memory://``, in this process) decodes
    through the port's ``read_parquet_columns`` as through the JAX one."""
    table = pa.table({"key": np.arange(100, dtype=np.int64), "labels": np.ones(100, dtype=np.float64)})
    uri = f"memory://ds-{uuid.uuid4().hex[:8]}/part-0.parquet"
    fs, rel = port_utils.parquet_filesystem(uri)
    pq.write_table(table, rel, filesystem=fs)
    got = port_shuffle.read_parquet_columns(uri)
    want = jax_shuffle.read_parquet_columns(uri)
    assert list(got.columns) == list(want.columns) == ["key", "labels"]
    for name in want.columns:
        np.testing.assert_array_equal(got.columns[name], want.columns[name])
    # A projected read of selected row groups goes through the resolver too.
    part = port_shuffle.read_parquet_columns(uri, columns=["key"], row_groups=[0])
    np.testing.assert_array_equal(part.columns["key"], np.arange(100))


@pytest.mark.parametrize("threads", [False, True])
def test_read_parquet_columns_from_file_uri_matches_jax(uri_files, threads):
    """Threaded and single-threaded decodes of a ``file://`` URI give the
    JAX package's columns and the local path's."""
    got = port_shuffle.read_parquet_columns(uri_files[0], use_threads=threads)
    want = jax_shuffle.read_parquet_columns(uri_files[0], use_threads=threads)
    local = port_shuffle.read_parquet_columns(uri_files[0][len("file://"):])
    assert list(got.columns) == list(want.columns) == list(local.columns)
    for name in want.columns:
        np.testing.assert_array_equal(got.columns[name], want.columns[name])
        np.testing.assert_array_equal(got.columns[name], local.columns[name])


@pytest.mark.parametrize("rowgroup_threads", [1, 2])
def test_row_group_reads_from_file_uri(uri_files, rowgroup_threads):
    """The selective read and its column-striped threads over a URI."""
    sizes = port_shuffle.file_row_group_sizes(uri_files[1])
    assert sizes == jax_shuffle.file_row_group_sizes(uri_files[1]) and len(sizes) == 2
    got = port_shuffle.read_parquet_columns(uri_files[1], columns=FEATURES, row_groups=[1],
                                            rowgroup_threads=rowgroup_threads)
    want = jax_shuffle.read_parquet_columns(uri_files[1], columns=FEATURES, row_groups=[1])
    for name in FEATURES:
        np.testing.assert_array_equal(got.columns[name], want.columns[name])


def _host_keys(ds, epochs):
    out = []
    for epoch in range(epochs):
        ds.set_epoch(epoch)
        out.append([np.array(b[KEY_COLUMN]) for b in ds])
    return out


def test_shuffle_dataset_from_file_uri_matches_jax(local_runtime, uri_files):
    """The map/reduce shuffle where every map (a pool worker of its own
    process) decodes through the resolver: the JAX package's key stream on
    the same seed, every key once an epoch."""
    kwargs = dict(num_reducers=2, seed=11)
    want = _host_keys(jax_dataset.ShufflingDataset(uri_files, 2, 1, 1000, 0, queue_name=_qname(), **kwargs), 2)
    got = _host_keys(ShufflingDataset(uri_files, 2, 1, 1000, 0, queue_name=_qname(), **kwargs), 2)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == 4
        for g, w in zip(g_epoch, w_epoch):
            np.testing.assert_array_equal(g, w)
        assert np.array_equal(np.sort(np.concatenate(g_epoch)), np.arange(NUM_ROWS))


def test_resident_dataset_from_file_uri_matches_jax(local_runtime, uri_files):
    """The resident loader's footer reads and range decodes over URIs: the
    JAX package's batch stream, and the local paths' packed buffer."""
    import jax
    from jax.sharding import Mesh

    assert dataset_num_rows(uri_files) == NUM_ROWS
    kw = dict(num_epochs=1, batch_size=1000, feature_columns=FEATURES, label_column=LABEL_COLUMN, seed=7)
    port = DeviceResidentShufflingDataset(uri_files, device="cpu", **kw)
    local = DeviceResidentShufflingDataset([f[len("file://"):] for f in uri_files], device="cpu", **kw)
    ref = JaxResident(uri_files, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)), **kw)
    try:
        assert port._buf.equal(local._buf)
        port.set_epoch(0)
        ref.set_epoch(0)
        got = [np.asarray(f[KEY_COLUMN]) for f, _ in port]
        want = [np.asarray(f[KEY_COLUMN]) for f, _ in ref]
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert np.array_equal(np.sort(np.concatenate(got)), np.arange(NUM_ROWS))
    finally:
        port.close()
        local.close()
        ref.close()


def test_generate_data_to_file_uri_matches_jax(local_runtime, port_rt, tmp_path):
    """Generation straight to a URI (pool workers resolve it): names that
    keep the scheme, and the JAX package's files byte for byte."""
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    files, nbytes = generate_data(2000, 2, 2, 0.0, f"file://{tmp_path / 'port'}", seed=3)
    jfiles, jbytes = jax_gen.generate_data(2000, 2, 2, 0.0, f"file://{tmp_path / 'jax'}", seed=3)
    assert nbytes == jbytes > 0 and len(files) == len(jfiles) == 2
    assert files == [f.replace("/jax/", "/port/") for f in jfiles]
    assert all(f.startswith("file://") for f in files)
    for f, jf in zip(files, jfiles):
        with open(f[len("file://"):], "rb") as a, open(jf[len("file://"):], "rb") as b:
            assert a.read() == b.read()
    keys = np.concatenate([port_shuffle.read_parquet_columns(f).columns[KEY_COLUMN] for f in files])
    assert np.array_equal(np.sort(keys), np.arange(2000))


def test_service_cache_key_of_a_file_uri_matches_jax(uri_files):
    """A URI's content key keeps the JAX fingerprint: ``os.stat`` of a URI
    fails, so the size and mtime read ``?``."""
    for columns, narrow in ((None, False), (["key", "labels"], True)):
        got = port_service.cache_key(uri_files[0], columns, narrow)
        assert got == jax_service.cache_key(uri_files[0], columns, narrow)
        assert got.split("|")[:2] == [uri_files[0], "?"]


@pytest.mark.parametrize("cores,tasks", [(128, 16), (128, 64), (128, 65), (1, 1), (16, 16), (256, 100000)])
@pytest.mark.parametrize("env", [None, "on", "off"])
def test_decode_threads_policy_matches_jax(monkeypatch, cores, tasks, env):
    """Arrow's threads engage only when the host has idle cores beyond the
    concurrent decodes, and the pool is capped to a task's share; the
    environment forces either way."""
    if env is None:
        monkeypatch.delenv("RSDL_DECODE_THREADS", raising=False)
    else:
        monkeypatch.setenv("RSDL_DECODE_THREADS", env)
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    before = pa.cpu_count()
    try:
        assert port_utils.decode_use_threads(tasks) == jax_utils.decode_use_threads(tasks)
        got = port_utils.arrow_decode_threads(tasks)
        got_cap = pa.cpu_count()
        pa.set_cpu_count(before)
        want = jax_utils.arrow_decode_threads(tasks)
        assert got == want and got_cap == pa.cpu_count()
    finally:
        pa.set_cpu_count(before)


def test_arrow_decode_threads_caps_pool(monkeypatch):
    monkeypatch.delenv("RSDL_DECODE_THREADS", raising=False)
    before = pa.cpu_count()
    try:
        monkeypatch.setattr(os, "cpu_count", lambda: 128)
        assert port_utils.arrow_decode_threads(16) is True
        assert pa.cpu_count() == 8  # 128 cores / 16 concurrent tasks
        pa.set_cpu_count(before)
        monkeypatch.setattr(os, "cpu_count", lambda: 16)
        assert port_utils.arrow_decode_threads(16) is False
        assert pa.cpu_count() == before
    finally:
        pa.set_cpu_count(before)


def test_fsspec_only_scheme_without_fsspec_names_the_scheme(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ImportError, match="memory://"):
        port_utils.parquet_filesystem("memory://ds/part-0.parquet")
    with pytest.raises(ImportError, match="http://"):
        port_utils.parquet_filesystem("http://host/part-0.parquet")
    fs, rel = port_utils.parquet_filesystem(f"file://{tmp_path}/x.parquet")
    assert rel == f"{tmp_path}/x.parquet"


# Run in a fresh interpreter whose every process (the driver, its pool
# workers and actors) finds an ``fsspec`` that refuses to import; the
# driver also blocks it in ``sys.modules``.
NO_FSSPEC_SCRIPT = textwrap.dedent("""
    import csv, os, sys
    sys.modules["fsspec"] = None
    sys.path.insert(0, {repo!r})
    import numpy as np

    def main():
        from ray_shuffling_data_loader_tpu_torch import runtime, stats, utils
        from ray_shuffling_data_loader_tpu_torch.data_generation import KEY_COLUMN, generate_data
        from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset

        work = {work!r}
        runtime.init(num_workers=2)
        try:
            files, _ = generate_data(3000, 3, 1, 0.0, "file://" + work + "/data", seed=2)
            assert all(f.startswith("file://") for f in files), files
            collector = runtime.spawn_actor(stats.TrialStatsCollector, 1, 3, 2, 3000, 500, 1, name="no-fsspec-stats")
            collector.wait_ready()
            ds = ShufflingDataset(files, 1, 1, 500, 0, num_reducers=2, queue_name="no-fsspec",
                                  stats_collector=collector)
            ds.set_epoch(0)
            keys = np.concatenate([np.asarray(b[KEY_COLUMN]) for b in ds])
            assert np.array_equal(np.sort(keys), np.arange(3000))
            ds.join(timeout=60)
            trial = collector.call("get_stats", 30)
            collector.terminate()
            stats.process_stats([trial], stats_dir="file://" + work + "/stats")
            stats.process_stats([trial], stats_dir="file://" + work + "/stats", overwrite_stats=False)
            with open(work + "/stats/trial_stats.csv", newline="") as f:
                assert len(list(csv.DictReader(f))) == 2
            try:
                utils.parquet_filesystem("memory://x/y.parquet")
            except ImportError as exc:
                assert "memory://" in str(exc), exc
            else:
                raise AssertionError("memory:// resolved without fsspec")
            assert sys.modules.get("fsspec") is None
            print("NO_FSSPEC_OK")
        finally:
            runtime.shutdown()

    if __name__ == "__main__":
        main()
""")


def test_file_uris_need_no_fsspec(tmp_path):
    """``file://`` generates, shuffles (maps in pool workers) and writes
    stats with fsspec unimportable in every process of the session."""
    shim = tmp_path / "shim" / "fsspec"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text("raise ImportError('fsspec is blocked in this test')\n")
    for sub in ("data", "stats"):
        (tmp_path / sub).mkdir()
    script = tmp_path / "no_fsspec.py"
    script.write_text(NO_FSSPEC_SCRIPT.format(repo=REPO, work=str(tmp_path)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "shim"), REPO]))
    for name in [k for k in env if k.startswith("RSDL_")]:
        del env[name]
    proc = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "NO_FSSPEC_OK" in proc.stdout, proc.stderr[-3000:]
