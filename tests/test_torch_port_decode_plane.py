"""The shuffle's read plane on the port, against the JAX package: the
JAX package's ``shuffle()`` parameter order, decode pushdown
(``RSDL_DECODE_PUSHDOWN``, ``shuffle(columns=)``) with its estimates,
schedule decisions, pruned bytes and errors, a resume under a
projection, and the shared decode cache (``RSDL_DECODE_CACHE_SHARED``).

The port's pool is spawned before any test sets a knob: its workers'
environments name none, so every stream here also shows that
``shuffle()`` hands its resolved projection to the tasks."""

import collections
import importlib
import inspect
import json

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.runtime.store import is_device_batch as jax_is_device_batch
from ray_shuffling_data_loader_tpu.runtime.store import logical_columns as jax_logical_columns
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, KEY_COLUMN, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod
from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store

# The JAX package's root exports its ``shuffle`` function under the module's name.
jax_sh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

NUM_ROWS, NUM_FILES, ROW_GROUPS, NUM_REDUCERS, SEED = 3000, 3, 5, 4, 17
PROJ = ["key", "labels"]
KNOBS = ("RSDL_DECODE_PUSHDOWN", "RSDL_DECODE_CACHE_SHARED", "RSDL_INDEX_SHUFFLE", "RSDL_SHUFFLE_PLAN",
         "RSDL_SELECTIVE_READS", "RSDL_DECODE_ROWGROUPS", "RSDL_PLAN", "RSDL_JOURNAL", "RSDL_RESUME",
         "RSDL_AUDIT", "RSDL_DEVICE_DIRECT", "RSDL_DISABLE_NATIVE")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    sh.shared_decode_cache_clear()
    yield
    sh.shared_decode_cache_clear(free=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Skewed row groups (odd sizes), as the JAX package's decode-plane
    tests use."""
    port_runtime.init(num_workers=2)
    names, _ = generate_data(NUM_ROWS, NUM_FILES, ROW_GROUPS, 0.5, str(tmp_path_factory.mktemp("decode")))
    yield names
    port_runtime.shutdown()


def _port_columns(cb):
    """A port segment's logical columns (a packed one's batches joined)."""
    if not port_store.is_device_batch(cb):
        return dict(cb.columns)
    views = list(port_store.iter_packed_batches(cb))
    return {k: np.concatenate([v[k] for v in views]) for k in cb.layout["columns"]}


class _Collect(sh.BatchConsumer):
    """Every delivered column, per ``(epoch, rank)``, and whether each
    segment was packed."""

    def __init__(self, fail_at_epoch=None):
        self.cols = collections.defaultdict(lambda: collections.defaultdict(list))
        self.packed = collections.defaultdict(list)
        self.fail_at_epoch = fail_at_epoch

    def consume(self, rank, epoch, batches):
        if epoch == self.fail_at_epoch:
            raise RuntimeError("consumer failed")
        store = port_runtime.get_context().store
        for ref in batches:
            cb = store.get_columns(ref)
            self.packed[(epoch, rank)].append(port_store.is_device_batch(cb))
            for k, v in _port_columns(cb).items():
                self.cols[(epoch, rank)][k].append(np.asarray(v).copy())
        store.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass

    def streams(self):
        return {key: {k: np.concatenate(v) for k, v in cols.items()} for key, cols in self.cols.items()}


class _JaxCollect(jax_sh.BatchConsumer):
    def __init__(self):
        self.cols = collections.defaultdict(lambda: collections.defaultdict(list))
        self.packed = collections.defaultdict(list)

    def consume(self, rank, epoch, batches):
        store = jax_runtime.get_context().store
        for ref in batches:
            cb = store.get_columns(ref)
            self.packed[(epoch, rank)].append(jax_is_device_batch(cb))
            for k, v in jax_logical_columns(cb).items():
                self.cols[(epoch, rank)][k].append(np.asarray(v).copy())
            store.free(ref)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass

    def streams(self):
        return {key: {k: np.concatenate(v) for k, v in cols.items()} for key, cols in self.cols.items()}


def _assert_streams_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key]), key
        for k in want[key]:
            assert got[key][k].dtype == want[key][k].dtype, (key, k)
            np.testing.assert_array_equal(got[key][k], want[key][k], err_msg=f"{key} {k}")


def _port_run(files, consumer=None, num_epochs=2, num_trainers=2, **kwargs):
    consumer = consumer or _Collect()
    log, stats = [], {}
    sh.shuffle(list(files), consumer, num_epochs, NUM_REDUCERS, num_trainers, seed=SEED, schedule_log=log,
               stats=stats, **kwargs)
    return consumer, [s for _, s in log], stats


def _jax_run(files, num_epochs=2, num_trainers=2, **kwargs):
    consumer = _JaxCollect()
    jax_sh.shuffle(list(files), consumer, num_epochs, NUM_REDUCERS, num_trainers, seed=SEED, **kwargs)
    return consumer


# -- the parameter order (Queue 3 (l)) ------------------------------------------------


def test_shuffle_signature_matches_jax():
    """The port's ``shuffle()`` takes the JAX package's parameters, by name,
    order and default, then its own (``stats``) last; so a call that
    passes the JAX package's positionals means the same in both."""
    port = list(inspect.signature(sh.shuffle).parameters.values())
    ref = list(inspect.signature(jax_sh.shuffle).parameters.values())
    assert [p.name for p in port[:len(ref)]] == [p.name for p in ref]
    assert [p.name for p in port[len(ref):]] == ["stats"]
    for p, q in zip(port, ref):
        assert p.kind == q.kind and p.default == q.default, p.name


def test_positional_stats_collector_is_the_collector(files):
    """The JAX package's 7th positional is the stats collector: given so,
    the port's run reports every map and reduce of its one epoch to it
    (where the parent took it for ``start_epoch``)."""
    from ray_shuffling_data_loader_tpu_torch.stats import TrialStatsCollector

    collector = port_runtime.spawn_actor(TrialStatsCollector, 1, NUM_FILES, NUM_REDUCERS, NUM_ROWS, 100, 1,
                                         name="decode-plane-positional")
    consumer = _Collect()
    sh.shuffle(list(files), consumer, 1, NUM_REDUCERS, 1, SEED, collector)
    trial = collector.call("get_stats", 60)
    (epoch,) = trial.epochs
    assert len(epoch.map_durations) == NUM_FILES and len(epoch.reduce_durations) == NUM_REDUCERS
    assert trial.duration > 0
    assert sorted(consumer.streams()[(0, 0)]["key"].tolist()) == list(range(NUM_ROWS))


# -- the projection ----------------------------------------------------------------------


LAYOUT = {"batch": 100, "columns": ["key", "embeddings_name3", "labels"]}


@pytest.mark.parametrize("mode", ["", "auto", "off", "0", "false", "on", "1", "true", "bogus"])
@pytest.mark.parametrize("layout", [None, LAYOUT, {"batch": 8}])
@pytest.mark.parametrize("columns", [None, [], ["labels", "key", "labels"], ("key",)])
def test_pushdown_columns_matches_jax(monkeypatch, mode, layout, columns):
    monkeypatch.setenv("RSDL_DECODE_PUSHDOWN", mode)
    got = sh._pushdown_columns(layout, columns)
    assert got == jax_sh._pushdown_columns(layout, columns)
    if got is not None:
        assert len(got) == len(set(got))


# (RSDL_DECODE_PUSHDOWN, columns=, device_layout): an explicit projection
# under auto and on, the layout's columns under on, and a projection that
# leaves out a layout column (the reducers then write plain segments).
PUSHDOWN_CASES = {
    "auto_explicit": ("auto", PROJ, None),
    "on_explicit": ("on", PROJ, None),
    "auto_explicit_layout": ("auto", PROJ + ["embeddings_name3"], LAYOUT),
    "on_layout": ("on", None, LAYOUT),
    "auto_layout_full": ("auto", None, LAYOUT),
    "on_omits_layout_column": ("on", ["key", "labels"], LAYOUT),
}


@pytest.mark.parametrize("case", sorted(PUSHDOWN_CASES))
def test_projected_streams_match_jax(files, local_runtime, monkeypatch, case):
    """``shuffle(columns=)`` and the layout's projection under ``on``: the
    delivered rows and column set equal the JAX package's, the column set
    is exactly the projection, every key arrives once an epoch, and
    reducers pack where the JAX package's pack."""
    mode, columns, layout = PUSHDOWN_CASES[case]
    monkeypatch.setenv("RSDL_DECODE_PUSHDOWN", mode)
    kwargs = dict(cache_decoded=False, columns=columns, device_layout=layout, narrow_to_32=layout is not None)
    want = _jax_run(files, **kwargs)
    got, _, stats = _port_run(files, **kwargs)
    expect = sh._pushdown_columns(layout, columns)
    assert stats["columns"] == expect
    _assert_streams_equal(got.streams(), want.streams())
    for key, cols in got.streams().items():
        assert sorted(cols) == sorted(expect or DATA_SPEC.keys() | {KEY_COLUMN}), key
    for epoch in range(2):
        keys = np.concatenate([got.streams()[(epoch, r)]["key"] for r in range(2)])
        assert sorted(keys.tolist()) == list(range(NUM_ROWS))
    assert dict(got.packed) == dict(want.packed)
    packed = [p for ps in got.packed.values() for p in ps]
    if layout is None or case == "on_omits_layout_column":
        assert not any(packed)
    else:
        assert any(packed)
    assert (stats["decode_bytes_pruned"] > 0) == (expect is not None)
    assert port_runtime.store_stats().num_objects == 0


def test_staged_tensors_under_pushdown_on_match_jax(files, local_runtime, monkeypatch):
    """``DeviceShufflingDataset`` under ``RSDL_DECODE_PUSHDOWN=on`` decodes
    only its layout's columns, and stages the JAX package's tensors."""
    monkeypatch.setenv("RSDL_DECODE_PUSHDOWN", "on")
    features = ["embeddings_name3", "embeddings_name0", "one_hot1"]
    spec = dict(feature_columns=features, label_column=LABEL_COLUMN, num_reducers=NUM_REDUCERS, seed=SEED,
                cache_decoded=True)
    jds = JaxShufflingDataset(files, 2, 1, 200, 0, queue_name="decode-plane-jax", **spec)
    pds = DeviceShufflingDataset(files, 2, 1, 200, 0, queue_name="decode-plane-port", device="cpu", **spec)
    for epoch in range(2):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        want = [({k: np.asarray(v) for k, v in f.items()}, np.asarray(l)) for f, l in jds]
        got = [(f, l) for f, l in pds]
        assert len(got) == len(want) == NUM_ROWS // 200
        for (gf, gl), (wf, wl) in zip(got, want):
            assert list(gf) == features
            for k in features:
                np.testing.assert_array_equal(gf[k].numpy(), wf[k], err_msg=k)
            np.testing.assert_array_equal(gl.numpy(), wl)
    pds.join()
    stats = pds.dataset.shuffle_stats
    assert stats["columns"] == features + [LABEL_COLUMN]
    assert stats["decode_bytes_pruned"] > 0 and pds.stats.batches_direct > 0


def test_estimates_under_projection_match_jax(files, local_runtime, monkeypatch):
    """The decoded-size estimate, its worker task and the decode-cache
    policy size the projection, as the JAX package's do; a budget between
    the projected and the full estimate caches only the projection."""
    for narrow in (False, True):
        for columns in (None, PROJ, ["labels"]):
            got = sh._dataset_stats_task(list(files), narrow, columns)
            assert got == jax_sh._dataset_stats_task(list(files), narrow, columns)
            assert sh._est_decoded_bytes(list(files), narrow, columns) == jax_sh._est_decoded_bytes(
                list(files), narrow, columns)
    assert sh._dataset_stats_task(list(files), False, PROJ) == (16.0, NUM_ROWS)
    assert sh._dataset_stats_task(list(files), True, PROJ) == (8.0, NUM_ROWS)
    full = sh._est_decoded_bytes(list(files), False)
    proj = sh._est_decoded_bytes(list(files), False, PROJ)
    assert full > 10 * proj
    budget = int((full + proj) / 2 / 0.35)
    monkeypatch.setattr(port_runtime.get_context().store, "capacity_bytes", budget)
    monkeypatch.setattr(jax_runtime.get_context().store, "capacity_bytes", budget)
    for columns, cached in ((None, False), (PROJ, True)):
        for epochs in (1, 2):
            got = sh._decode_cache_auto(list(files), epochs, False, columns)
            assert got == jax_sh._decode_cache_auto(list(files), epochs, False, columns)
            assert got == (cached and epochs >= 2)


@pytest.mark.parametrize("roundtrip", [1e-6, 1e-4, 1e-1])
@pytest.mark.parametrize("num_reducers", [1, 4, 16])
def test_index_schedule_decision_at_injected_figures(files, local_runtime, monkeypatch, roundtrip, num_reducers):
    """``auto`` decides as the JAX package does at the same host figures,
    for the full decode and the projection (whose smaller cache can turn
    the decision to the index schedule); ``on`` and ``off`` decide alone."""
    costs = {"gather_small": 2e9, "gather_large": 1e9, "copy": 1e9, "roundtrip": roundtrip}
    monkeypatch.setattr(sh, "_probed_host_costs", lambda: dict(costs))
    monkeypatch.setattr(jax_sh, "_probed_host_costs", lambda: dict(costs))
    for columns in (None, PROJ):
        got = sh._index_schedule_allowed(list(files), num_reducers, True, columns)
        assert got == jax_sh._index_schedule_allowed(list(files), num_reducers, True, columns)
    for mode, want in (("on", True), ("off", False)):
        monkeypatch.setenv("RSDL_INDEX_SHUFFLE", mode)
        assert sh._index_schedule_allowed(list(files), num_reducers, True, PROJ) is want


def test_projection_that_flips_the_index_decision(files, local_runtime, monkeypatch):
    """At figures where the full cache loses to the materialized schedule
    and the projected one wins, both packages flip together."""
    costs = {"gather_small": 1e9, "gather_large": 1e9, "copy": 1e9, "roundtrip": 0.0}
    full = sh._est_decoded_bytes(list(files), False)
    proj = sh._est_decoded_bytes(list(files), False, PROJ)
    # t_index - t_mat = (4 - 3) est / 1e9 - 3 files x 4 reducers x roundtrip:
    # zero between the two estimates.
    costs["roundtrip"] = (full + proj) / 2 / 1e9 / 12
    monkeypatch.setattr(sh, "_probed_host_costs", lambda: dict(costs))
    monkeypatch.setattr(jax_sh, "_probed_host_costs", lambda: dict(costs))
    for columns, want in ((None, False), (PROJ, True)):
        assert sh._index_schedule_allowed(list(files), NUM_REDUCERS, False, columns) is want
        assert jax_sh._index_schedule_allowed(list(files), NUM_REDUCERS, False, columns) is want


def _jax_pruned_total(monkeypatch, work):
    """The JAX package's ``shuffle.decode_bytes_pruned`` total over the
    in-process calls of ``work``, with its metrics armed as its own
    decode-plane tests arm them."""
    from ray_shuffling_data_loader_tpu.telemetry import export, metrics

    monkeypatch.setenv("RSDL_METRICS", "1")
    metrics.refresh_from_env()
    metrics.reset()
    try:
        work()
        snap = metrics.registry.snapshot()
        return export.labeled_sum(snap, "shuffle.decode_bytes_pruned")[0]
    finally:
        monkeypatch.delenv("RSDL_METRICS")
        metrics.refresh_from_env()
        metrics.reset()


@pytest.mark.parametrize("schedule", ["mapreduce", "selective"])
def test_decode_bytes_pruned_matches_jax_counter(files, local_runtime, monkeypatch, schedule):
    """``stats["decode_bytes_pruned"]`` of a projected run equals the JAX
    package's counter over the same decodes: each file once an epoch in
    the materialized schedule; under ``block:1`` selective, each
    reducer's selection of every file."""
    plan = ("block", 1)
    if schedule == "selective":
        monkeypatch.setenv("RSDL_SHUFFLE_PLAN", "block:1")
        monkeypatch.setenv("RSDL_SELECTIVE_READS", "on")
    _, schedules, stats = _port_run(files, cache_decoded=False, columns=PROJ)
    assert schedules == [schedule] * 2

    def jax_decodes():
        store = jax_runtime.get_context().store
        for epoch in range(2):
            if schedule == "mapreduce":
                for i, f in enumerate(files):
                    store.free(jax_sh.shuffle_map(f, i, NUM_REDUCERS, epoch=epoch, seed=SEED, columns=PROJ))
            else:
                for r in range(NUM_REDUCERS):
                    out = jax_sh.shuffle_selective_reduce(r, epoch, SEED, list(files), NUM_REDUCERS, columns=PROJ,
                                                          plan=plan)
                    store.free(out if isinstance(out, list) else [out])

    want = _jax_pruned_total(monkeypatch, jax_decodes)
    assert stats["decode_bytes_pruned"] == want > 0
    per_file_groups = ROW_GROUPS if schedule == "mapreduce" else None
    if per_file_groups:
        assert stats["decode_rowgroups"] == {0: NUM_FILES * ROW_GROUPS, 1: NUM_FILES * ROW_GROUPS}
        assert stats["decode_bytes"] == {0: 16 * NUM_ROWS, 1: 16 * NUM_ROWS}


def test_projection_errors_match_jax(files, local_runtime):
    """A column the file lacks raises in both packages' decode, with the
    JAX package's message, and so does a projection of no column; a run
    over a missing column fails; ``columns=[]`` decodes everything."""
    for read in (sh.read_parquet_columns, jax_sh.read_parquet_columns):
        for kwargs in ({}, {"row_groups": [0, 2]}, {"rowgroup_threads": 2}):
            with pytest.raises(ValueError, match="projected columns not in .* schema: \\['no_such_column'\\]"):
                read(files[0], columns=["labels", "no_such_column"], **kwargs)
            with pytest.raises(ValueError, match="projection selects no columns"):
                read(files[0], columns=[], **kwargs)
    whole = sh.read_parquet_columns(files[0])
    got = sh.read_parquet_columns(files[0], columns=["labels", "key"])
    assert list(got.columns) == ["labels", "key"]
    for k in got.columns:
        assert got[k].tobytes() == whole[k].tobytes() == jax_sh.read_parquet_columns(files[0], columns=[k])[k].tobytes()
    with pytest.raises(Exception, match="no_such_column"):
        _port_run(files, num_epochs=1, cache_decoded=False, columns=["key", "no_such_column"])
    got, _, stats = _port_run(files, num_epochs=1, cache_decoded=False, columns=[])
    assert stats["columns"] is None and len(got.streams()[(0, 0)]) == len(DATA_SPEC) + 1


@pytest.mark.parametrize("narrow", [False, True])
def test_selective_with_projection_matches_jax(files, local_runtime, monkeypatch, narrow):
    """The selective schedule under ``block:1`` decodes only the projection
    of its row groups and delivers the JAX package's stream."""
    monkeypatch.setenv("RSDL_SHUFFLE_PLAN", "block:1")
    monkeypatch.setenv("RSDL_SELECTIVE_READS", "on")
    kwargs = dict(cache_decoded=False, columns=PROJ, narrow_to_32=narrow)
    want = _jax_run(files, **kwargs)
    got, schedules, stats = _port_run(files, **kwargs)
    assert schedules == ["selective"] * 2
    _assert_streams_equal(got.streams(), want.streams())
    for epoch in range(2):
        decoded = stats["selective_rowgroups"][epoch]
        assert sorted(map(tuple, decoded)) == [(i, g) for i in range(NUM_FILES) for g in range(ROW_GROUPS)]


def test_resume_under_a_projection(files, tmp_path, monkeypatch):
    """The journal's run identity holds the resolved projection: a run
    that failed under one projection resumes under it, matches nothing
    under another with ``auto`` (and shuffles fresh, the same rows), and
    refuses another by path."""
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path))
    failing = _Collect(fail_at_epoch=1)
    with pytest.raises(RuntimeError, match="consumer failed"):
        _port_run(files, failing, num_epochs=2, num_trainers=1, cache_decoded=False, columns=PROJ)
    (path,) = tmp_path.glob("run-*.ndjson")
    assert jmod.load_run(str(path)).identity["columns"] == PROJ
    with pytest.raises(ValueError, match="columns"):
        _port_run(files, num_epochs=2, num_trainers=1, cache_decoded=False, columns=["key"], resume_from=str(path))
    other, _, stats = _port_run(files, num_epochs=2, num_trainers=1, cache_decoded=False, columns=["key"],
                                resume_from="auto")
    assert stats["resume"]["from_run"] is None
    same, _, stats = _port_run(files, num_epochs=2, num_trainers=1, cache_decoded=False, columns=PROJ,
                               resume_from="redeliver")
    # The failed run freed its segments: its stages run again, from the seed.
    assert stats["resume"]["from_run"] == jmod.load_run(str(path)).run_id
    assert stats["resume"]["maps_reexecuted"] > 0
    control, _, _ = _port_run(files, num_epochs=2, num_trainers=1, cache_decoded=False, columns=PROJ)
    _assert_streams_equal(same.streams(), control.streams())
    for key, cols in other.streams().items():
        np.testing.assert_array_equal(cols["key"], control.streams()[key]["key"])
        assert list(cols) == ["key"]
    assert port_runtime.store_stats().num_objects == 0


# -- the shared decode cache ---------------------------------------------------------------


def test_shared_cache_hit_across_runs(files, local_runtime, monkeypatch):
    """Two runs back to back with the shared tier armed and the index
    schedule forced: the second starts cache-hot, decodes no Parquet in
    either epoch, and both deliver the JAX package's stream."""
    monkeypatch.setenv("RSDL_DECODE_CACHE_SHARED", "on")
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", "on")
    want = _jax_run(files, num_trainers=1, cache_decoded=True)
    first, log1, stats1 = _port_run(files, num_trainers=1, cache_decoded=True)
    assert log1 == ["mapreduce", "index"] and stats1["decode_rowgroups"][0] == NUM_FILES * ROW_GROUPS
    assert len(sh._SHARED_CACHE) == NUM_FILES
    refs = list(sh._SHARED_CACHE.values())
    assert all(port_runtime.get_context().store.exists(r) for r in refs)
    second, log2, stats2 = _port_run(files, num_trainers=1, cache_decoded=True)
    assert log2 == ["index", "index"]
    assert sum(stats2["decode_rowgroups"].values()) == 0 and stats2["shared_cache_hits"] == 2 * NUM_FILES
    assert list(sh._SHARED_CACHE.values()) == refs
    _assert_streams_equal(first.streams(), want.streams())
    _assert_streams_equal(second.streams(), want.streams())
    assert port_runtime.store_stats().num_objects == NUM_FILES  # the promoted segments
    sh.shared_decode_cache_clear(free=True)
    assert port_runtime.store_stats().num_objects == 0


def test_shared_cache_freed_segment_decodes_again(files, local_runtime, monkeypatch):
    """A promoted segment that was freed is never handed out: the next run
    drops its entry, decodes again, delivers the same stream, and promotes
    live segments."""
    monkeypatch.setenv("RSDL_DECODE_CACHE_SHARED", "on")
    warm, _, _ = _port_run(files, num_trainers=1, cache_decoded=True)
    store = port_runtime.get_context().store
    stale = list(sh._SHARED_CACHE.values())
    store.free(stale)
    cold, log, stats = _port_run(files, num_epochs=1, num_trainers=1, cache_decoded=True)
    assert log == ["mapreduce"] and stats["decode_rowgroups"][0] == NUM_FILES * ROW_GROUPS
    assert stats["shared_cache_hits"] == 0
    assert cold.streams()[(0, 0)]["key"].tolist() == warm.streams()[(0, 0)]["key"].tolist()
    fresh = list(sh._SHARED_CACHE.values())
    assert len(fresh) == NUM_FILES and not {r.object_id for r in fresh} & {r.object_id for r in stale}
    assert all(store.exists(r) for r in fresh)


def test_shared_cache_off_by_default(files):
    """Unset, a cached run leaves nothing behind: no entry, no segment."""
    _port_run(files, num_trainers=1, cache_decoded=True)
    assert sh._SHARED_CACHE == {} and not sh.shared_decode_cache_enabled()
    assert port_runtime.store_stats().num_objects == 0


def test_shared_cache_keyed_by_projection_and_narrowing(files, local_runtime, monkeypatch):
    """A cache of one projection or narrowing is never read by a run of
    another: each decodes in its epoch 0 and promotes its own segments;
    a run of the same key hits."""
    monkeypatch.setenv("RSDL_DECODE_CACHE_SHARED", "on")
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", "on")
    runs = [dict(), dict(columns=PROJ), dict(narrow_to_32=True), dict(columns=PROJ, narrow_to_32=True)]
    want = _jax_run(files, num_epochs=1, num_trainers=1, cache_decoded=True, columns=PROJ, narrow_to_32=True)
    for n, kwargs in enumerate(runs, start=1):
        _, log, stats = _port_run(files, num_epochs=1, num_trainers=1, cache_decoded=True, **kwargs)
        assert log == ["mapreduce"] and stats["shared_cache_hits"] == 0, kwargs
        assert len(sh._SHARED_CACHE) == n * NUM_FILES
    keys = {(k[2], k[3]) for k in sh._SHARED_CACHE}
    assert keys == {(None, False), (tuple(PROJ), False), (None, True), (tuple(PROJ), True)}
    again, log, stats = _port_run(files, num_epochs=1, num_trainers=1, cache_decoded=True, columns=PROJ,
                                  narrow_to_32=True)
    assert log == ["index"] and stats["shared_cache_hits"] == NUM_FILES
    _assert_streams_equal(again.streams(), want.streams())


def test_shared_cache_survives_a_resumed_run(files, tmp_path, monkeypatch):
    """A journaled run that failed is resumed with the shared tier armed:
    the resume's clean-up of its predecessor spares the promoted
    segments."""
    monkeypatch.setenv("RSDL_DECODE_CACHE_SHARED", "on")
    monkeypatch.setenv("RSDL_JOURNAL", str(tmp_path))
    with pytest.raises(RuntimeError, match="consumer failed"):
        _port_run(files, _Collect(fail_at_epoch=1), num_trainers=1, cache_decoded=True)
    resumed, _, stats = _port_run(files, num_trainers=1, cache_decoded=True, resume_from="redeliver")
    assert stats["resume"]["from_run"] is not None
    refs = list(sh._SHARED_CACHE.values())
    assert len(refs) == NUM_FILES and all(port_runtime.get_context().store.exists(r) for r in refs)
    for epoch in range(2):
        assert sorted(resumed.streams()[(epoch, 0)]["key"].tolist()) == list(range(NUM_ROWS))
    assert json.loads(json.dumps(stats["columns"])) is None
