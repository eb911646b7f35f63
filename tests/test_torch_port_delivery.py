"""Delivery as the JAX package runs it by default, on the port: the decode
cache, the index schedule, the store's budget and packed reducer outputs
staged in one copy, held against the JAX package on the same files and
seeds, bit for bit."""

import importlib
import itertools
import os
import uuid

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from ray_shuffling_data_loader_tpu import dataset as jax_dataset
from ray_shuffling_data_loader_tpu import native as jax_native
from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.runtime import store as jax_store
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle
from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, KEY_COLUMN, LABEL_COLUMN, generate_data
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store

# The JAX package's root exports its ``shuffle`` function under the module's name.
jax_shuffle = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

NUM_ROWS, NUM_REDUCERS, SEED = 8000, 3, 7
# 8 JAX devices divide it; reducers of about 2667 rows each hold whole
# aligned batches and straddle others; 8000 rows leave a final 80.
BATCH = 720
FEATURES = [c for c in DATA_SPEC if c != LABEL_COLUMN] + [KEY_COLUMN]
SPEC = dict(feature_columns=FEATURES, label_column=LABEL_COLUMN, num_reducers=NUM_REDUCERS, seed=SEED)


def _qname():
    return f"delivery-{uuid.uuid4().hex[:8]}"


@pytest.fixture(scope="module")
def port_rt():
    port_runtime.init(num_workers=2)
    yield
    port_runtime.shutdown()


@pytest.fixture(scope="module")
def files(tmp_path_factory, port_rt):
    names, _ = generate_data(NUM_ROWS, 4, 2, 0.0, str(tmp_path_factory.mktemp("data")))
    return names


def _staged_stream(ds, skip):
    out = []
    for epoch in range(2):
        ds.set_epoch(epoch, skip_batches=skip)
        out.append([({k: np.asarray(v) for k, v in f.items()}, np.asarray(l)) for f, l in ds])
    return out


@pytest.fixture(scope="module")
def jax_staged(files, local_runtime):
    """The JAX package's staged tensors under its defaults, per
    ``(drop_last, skip_batches)``, computed once."""
    cache = {}

    def get(drop_last, skip):
        if (drop_last, skip) not in cache:
            ds = JaxShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_qname(), drop_last=drop_last, **SPEC)
            cache[drop_last, skip] = _staged_stream(ds, skip)
        return cache[drop_last, skip]

    return get


def _whole_aligned_batches(files, epoch, batch, num_reducers=NUM_REDUCERS, num_trainers=1):
    """Per rank, the whole batches of its stream inside each of its
    reducers' intervals, from the JAX package's own draw: what packed
    bodies hold."""
    totals = np.zeros(num_reducers, np.int64)
    plan = jax_shuffle.shuffle_plan_spec()
    for i, f in enumerate(files):
        n = pq.ParquetFile(f).metadata.num_rows
        assignment = jax_shuffle._file_assignment(SEED, epoch, i, n, num_reducers, f, plan)
        totals += np.bincount(assignment, minlength=num_reducers)
    counts = []
    for reducers in np.array_split(np.arange(num_reducers), num_trainers):
        count, start = 0, 0
        for total in totals[reducers].tolist():
            h = min(total, (-start) % batch)
            count += (total - h) // batch
            start += total
        counts.append(count)
    return counts


def _logical_columns(cb):
    """A port segment's logical columns: a packed segment's per-batch
    views joined along the rows, else its plain columns."""
    if not port_store.is_device_batch(cb):
        return cb.columns
    views = list(port_store.iter_packed_batches(cb))
    return {k: np.concatenate([v[k] for v in views]) for k in cb.layout["columns"]}


MODES = list(itertools.product(("auto", "off"), ("on", "off"), (True, False)))
# The host kernels on (the default), or their plain numpy versions.
NATIVE = {"native": "", "plain": "1"}


def _host_passes(monkeypatch, native):
    # The JAX package reads the same variable once per process, at its
    # first kernel call: load its kernels first, so that they stay on for
    # the JAX side of every test in this process.
    assert jax_native.native_available()
    monkeypatch.setenv("RSDL_DISABLE_NATIVE", NATIVE[native])
    return native == "native"


@pytest.mark.parametrize("native", sorted(NATIVE))
@pytest.mark.parametrize("skip", [0, 3])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("direct,index,cache", MODES)
def test_staged_tensors_match_jax_in_every_mode(
    files, jax_staged, monkeypatch, direct, index, cache, drop_last, skip, native
):
    """``RSDL_DEVICE_DIRECT`` auto/off x ``RSDL_INDEX_SHUFFLE`` on/off x
    ``cache_decoded`` x ``RSDL_DISABLE_NATIVE``: every staged tensor equals
    the JAX package's, bit for bit; direct batches are exactly the whole
    aligned batches of the reducers' intervals; the index schedule runs
    from epoch 1 exactly when forced with the cache on; every host pass of
    the stage tasks ran the C++ kernels, or with them off numpy."""
    want = jax_staged(drop_last, skip)
    native_on = _host_passes(monkeypatch, native)
    monkeypatch.setenv("RSDL_DEVICE_DIRECT", direct)
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", index)
    ds = DeviceShufflingDataset(
        files, 2, 1, BATCH, 0, queue_name=_qname(), device="cpu", drop_last=drop_last, cache_decoded=cache, **SPEC
    )
    assert (ds.device_layout is not None) == (direct == "auto")
    got, direct_per_epoch = [], []
    for epoch in range(2):
        before = ds.stats.batches_direct
        got += _staged_stream_epoch(ds, epoch, skip)
        direct_per_epoch.append(ds.stats.batches_direct - before)
    ds.join()
    want = [b for epoch in want for b in epoch]
    assert len(got) == len(want) > 0
    for (gf, gl), (wf, wl) in zip(got, want):
        assert list(gf) == FEATURES and set(gf) == set(wf)
        for name in wf:
            assert gf[name].dtype == torch.int32
            np.testing.assert_array_equal(gf[name].numpy(), wf[name], err_msg=name)
        assert gl.dtype == torch.float32
        np.testing.assert_array_equal(gl.numpy(), wl)
    stats = ds.stats
    assert stats.batches_direct + stats.batches_carried == stats.batches_staged == len(got)
    if direct == "off":
        assert stats.batches_direct == 0
    elif skip == 0:
        assert direct_per_epoch == [_whole_aligned_batches(files, e, BATCH)[0] for e in range(2)]
        assert all(n > 0 for n in direct_per_epoch) and stats.batches_carried > 0
    assert ds.dataset.shuffle_stats["cache_decoded"] is cache
    schedules = [s for _, s in ds.dataset.schedule_log]
    assert schedules == (["mapreduce", "index"] if index == "on" and cache else ["mapreduce"] * 2)
    calls = ds.dataset.shuffle_stats
    ran, idle = (calls["native_calls"], calls["plain_calls"]) if native_on else (calls["plain_calls"],
                                                                               calls["native_calls"])
    assert ran["group_rows"] > 0 and ran["narrow"] > 0 and ran["take" if "index" in schedules else "take_multi"] > 0
    assert not any(idle.values())
    assert port_runtime.store_stats().num_objects == 0


def _staged_stream_epoch(ds, epoch, skip):
    ds.set_epoch(epoch, skip_batches=skip)
    return [(f, l) for f, l in ds]


@pytest.mark.parametrize("native", sorted(NATIVE))
@pytest.mark.parametrize("index,cache", list(itertools.product(("on", "off"), (True, False))))
def test_row_stream_with_packed_outputs_matches_jax(files, local_runtime, monkeypatch, index, cache, native):
    """The host stream with a staging layout: the same rows and columns
    as the JAX package's, and packed batches at the same places, with the
    host kernels on or off."""
    _host_passes(monkeypatch, native)
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", index)
    layout = {"batch": BATCH, "columns": [KEY_COLUMN, LABEL_COLUMN]}
    kwargs = dict(num_reducers=NUM_REDUCERS, seed=SEED, narrow_to_32=True, cache_decoded=cache, device_layout=layout)

    def stream(ds):
        out = []
        for epoch in range(2):
            ds.set_epoch(epoch)
            out.append([(b.packed is not None, {k: np.array(v) for k, v in b.items()}) for b in ds])
        return out

    want = stream(jax_dataset.ShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_qname(), **kwargs))
    ds = ShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_qname(), **kwargs)
    got = stream(ds)
    ds.join()
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) > 0
        assert [p for p, _ in g_epoch] == [p for p, _ in w_epoch]
        assert any(p for p, _ in g_epoch)
        for (_, g), (_, w) in zip(g_epoch, w_epoch):
            # The requested columns first, then the rest, in both.
            assert list(g) == list(w)
            for name in w:
                assert g[name].dtype == w[name].dtype, name
                np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_each_rank_packs_at_its_own_batch_grid(files, local_runtime):
    """Two ranks, five reducers: each rank's packed batches are exactly
    the whole aligned batches of its own stream, and the ranks' rows in
    rank order are the JAX package's one-rank stream."""
    layout = {"batch": BATCH, "columns": [KEY_COLUMN]}
    kwargs = dict(num_reducers=5, seed=SEED, narrow_to_32=True, device_layout=layout)
    name = _qname()
    ranks = [ShufflingDataset(files, 2, 2, BATCH, r, queue_name=name, **kwargs) for r in range(2)]
    one_rank = jax_dataset.ShufflingDataset(files, 2, 1, BATCH, 0, queue_name=_qname(), **kwargs)
    for epoch in range(2):
        keys, packed = [], []
        for ds in ranks:
            ds.set_epoch(epoch)
            batches = list(ds)
            keys += [b[KEY_COLUMN] for b in batches]
            packed.append(sum(b.packed is not None for b in batches))
        assert packed == _whole_aligned_batches(files, epoch, BATCH, num_reducers=5, num_trainers=2)
        assert min(packed) > 0
        one_rank.set_epoch(epoch)
        np.testing.assert_array_equal(np.concatenate(keys), np.concatenate([b[KEY_COLUMN] for b in one_rank]))
    ranks[0].join()


@pytest.mark.parametrize(
    "start,total,batch", [(0, 64, 8), (3, 64, 8), (5, 9, 8), (7, 23, 8), (16, 40, 8), (1, 255, 16), (4, 4, 8)]
)
def test_packed_output_geometry_matches_jax(local_runtime, port_rt, start, total, batch):
    """Head, body and tail sizes and the chunks over ``[0, total)`` are
    the JAX package's; what is written through the chunks reads back as
    the same logical columns."""
    layout = {"batch": batch, "columns": ["a", LABEL_COLUMN]}
    outs = []
    for mod, store in ((jax_shuffle, jax_runtime.get_context().store), (port_shuffle, port_runtime.get_context().store)):
        template = {"a": np.zeros(1, np.int32), LABEL_COLUMN: np.zeros(1, np.float32), "b": np.zeros(1, np.int32)}
        outs.append((mod._packed_output(store, (start, layout), total, template), store))
    (jout, jstore), (pout, pstore) = outs
    assert (jout is None) == (pout is None)
    if pout is None:
        return
    assert (pout.h, pout.m, pout.t, pout.names) == (jout.h, jout.m, jout.t, jout.names)
    assert [(lo, hi, list(v)) for lo, hi, v in pout.chunks()] == [(lo, hi, list(v)) for lo, hi, v in jout.chunks()]
    src = np.random.default_rng(start * 1000 + total).integers(0, 1 << 20, total).astype(np.int32)
    got = {}
    for out, store, mod in ((jout, jstore, jax_store), (pout, pstore, port_store)):
        for lo, hi, views in out.chunks():
            views["a"][...] = src[lo:hi]
            views[LABEL_COLUMN][...] = src[lo:hi].astype(np.float32)
            views["b"][...] = -src[lo:hi]
        refs = out.seal()
        read = jax_store.logical_columns if mod is jax_store else _logical_columns
        cols = [read(store.get_columns(r)) for r in refs]
        got[mod] = {k: np.concatenate([np.asarray(c[k]) for c in cols]) for k in ("a", LABEL_COLUMN, "b")}
        if mod is port_store:
            assert port_store.is_device_batch(store.get_columns(refs[1 if out.h else 0]))
        store.free(refs)
    for k in ("a", LABEL_COLUMN, "b"):
        np.testing.assert_array_equal(got[port_store][k], got[jax_store][k])
    np.testing.assert_array_equal(got[port_store]["a"], src)


def test_packed_segment_views_match_jax(tmp_path):
    """The same packed segment read by both packages: the same per-batch
    views and ``.packed`` blocks, which join into the JAX package's logical
    columns."""
    rng = np.random.default_rng(5)
    mat = rng.integers(-1000, 1000, (3, 3, 16)).astype(np.int32)
    layout = {"kind": port_store.DEVICE_BATCH_KIND, "batch": 16, "columns": ["x", "y", "z"],
              "dtypes": ["<i4", "<f4", "<i4"]}
    path = tmp_path / "seg"
    path.write_bytes(jax_store.serialize_columns({jax_store.PACKED_COLUMN: mat}, layout=layout))
    pcb, jcb = port_store.map_segment_file(str(path)), jax_store.map_segment_file(str(path))
    assert pcb.layout == jcb.layout == layout
    assert port_store.is_device_batch(pcb)
    views = list(port_store.iter_packed_batches(pcb))
    assert len(views) == len(list(jax_store.iter_packed_batches(jcb))) == 3
    for p, j in zip(views, jax_store.iter_packed_batches(jcb)):
        np.testing.assert_array_equal(p.packed, j.packed)
        for k in layout["columns"]:
            assert p[k].dtype == j[k].dtype
            np.testing.assert_array_equal(p[k].view(np.int32), j[k].view(np.int32))
    pl, jl = _logical_columns(pcb), jax_store.logical_columns(jcb)
    assert list(pl) == list(jl)
    for k in layout["columns"]:
        assert pl[k].shape == (48,)
        np.testing.assert_array_equal(pl[k].view(np.int32), jl[k].view(np.int32))


CAPACITY_ENVS = [{}, {"RSDL_STORE_CAPACITY_BYTES": "12345"}, {"RSDL_STORE_CAPACITY_BYTES": "0"},
                 {"RSDL_STORE_CAPACITY_FRACTION": "0.5"}]


@pytest.mark.parametrize("env", CAPACITY_ENVS)
def test_default_capacity_matches_jax(tmp_path, monkeypatch, env):
    for k in ("RSDL_STORE_CAPACITY_BYTES", "RSDL_STORE_CAPACITY_FRACTION"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = port_store._default_capacity_bytes(str(tmp_path))
    assert got == jax_store._default_capacity_bytes(str(tmp_path))
    if "RSDL_STORE_CAPACITY_BYTES" not in env:  # a size to read, and none there
        assert port_store._default_capacity_bytes(str(tmp_path / "missing")) is None


def test_decode_cache_policy_matches_jax(local_runtime, port_rt, monkeypatch):
    files = [f"f{i}" for i in range(4)]
    for num_epochs, est, cap in itertools.product((1, 2, 5), (1e6, 3.4e6, 3.6e6), (1e7, None)):
        for mod, ctx in ((jax_shuffle, jax_runtime.get_context()), (port_shuffle, port_runtime.get_context())):
            monkeypatch.setattr(mod, "_est_decoded_bytes", lambda f, n, c=None, est=est: est)
            monkeypatch.setattr(ctx.store, "capacity_bytes", cap)
        want = jax_shuffle._decode_cache_auto(files, num_epochs, True)
        assert port_shuffle._decode_cache_auto(files, num_epochs, True) == want
        assert want == (num_epochs >= 2 and cap is not None and est < 0.35 * cap)


HOSTS = {
    "one_core": {"gather_small": 2.4e9, "gather_large": 0.5e9, "copy": 3.5e9, "roundtrip": 1e-3},
    "many_core": {"gather_small": 60e9, "gather_large": 30e9, "copy": 20e9, "roundtrip": 3e-4},
}


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_index_schedule_policy_matches_jax(local_runtime, port_rt, monkeypatch, mode):
    """On injected host costs and estimates (nothing measured here), the
    port's policy and gather model decide as the JAX package's."""
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", mode)
    decisions = set()
    for host, est, nfiles, reducers in itertools.product(HOSTS, (4e5, 2e7, 25e9), (4, 16), (2, 4, 16)):
        files = [f"f{i}" for i in range(nfiles)]
        for mod in (jax_shuffle, port_shuffle):
            monkeypatch.setattr(mod, "_est_decoded_bytes", lambda f, n, c=None, est=est: est)
            monkeypatch.setitem(mod._PROBE_CACHE, "costs", HOSTS[host])
        want = jax_shuffle._index_schedule_allowed(files, reducers, True)
        assert port_shuffle._index_schedule_allowed(files, reducers, True) == want, (host, est, nfiles, reducers)
        assert port_shuffle._gather_bw_for(est) == jax_shuffle._gather_bw_for(est)
        decisions.add(want)
    assert decisions == ({True, False} if mode == "auto" else {mode == "on"})


def test_over_budget_segments_land_in_the_spill_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("RSDL_SHM_DIR", str(tmp_path / "shm"))
    monkeypatch.setenv("RSDL_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("RSDL_STORE_CAPACITY_BYTES", "20000")
    store = port_store.ObjectStore("rsdl-budget")
    assert store.capacity_bytes == 20000 and store.spill_dir == str(tmp_path / "spill")
    cols = {"v": np.arange(1000, dtype=np.int64)}  # 8000 B of rows
    refs = [store.put_columns(cols) for _ in range(3)]
    placed = [os.path.dirname(store._find_segment(r.object_id)) for r in refs]
    assert placed == [str(tmp_path / "shm")] * 2 + [str(tmp_path / "spill")]
    pending = store.create_columns({"k": ((1000,), np.int64)})
    pending.columns["k"][:] = np.arange(1000)
    windows = pending.publish_slices([(0, 4), (4, 1000)])
    assert all(os.path.dirname(store._find_segment(w.object_id)) == str(tmp_path / "spill") for w in windows)
    np.testing.assert_array_equal(store.get_columns(refs[2])["v"], cols["v"])
    np.testing.assert_array_equal(store.get_columns(windows[1])["k"], np.arange(4, 1000))
    stats = store.store_stats()
    assert stats.num_objects == 5 and 0 < stats.spill_bytes < stats.total_bytes
    store.free([refs[2], *windows])
    assert store.store_stats().spill_bytes == 0 and not store.exists(refs[2])
    store.cleanup()
    assert store.store_stats().num_objects == 0
    # A spill dir that is the shm dir is no spill tier: no budget.
    monkeypatch.setenv("RSDL_SPILL_DIR", str(tmp_path / "shm"))
    assert port_store.ObjectStore("rsdl-budget").capacity_bytes is None


@pytest.mark.parametrize("packed", [False, True])
def test_populated_mapping_reads_what_a_faulted_one_does(tmp_path, monkeypatch, packed):
    """``get_columns(populate=True)``, the consumer's mapping, gives the
    same columns, windows and packed blocks as the plain mapping."""
    monkeypatch.setenv("RSDL_SHM_DIR", str(tmp_path))
    store = port_store.ObjectStore("rsdl-populate")
    rng = np.random.default_rng(11)
    if packed:
        layout = {"kind": port_store.DEVICE_BATCH_KIND, "batch": 16, "columns": ["x", "y"], "dtypes": ["<i4", "<f4"]}
        pending = store.create_columns({port_store.PACKED_COLUMN: ((3, 2, 16), np.dtype(np.int32))}, layout)
        pending.columns[port_store.PACKED_COLUMN][...] = rng.integers(-99, 99, (3, 2, 16))
        refs = [pending.seal()]
    else:
        pending = store.create_columns({"k": ((1000,), np.int64), "v": ((1000,), np.float32)})
        pending.columns["k"][:] = rng.permutation(1000)
        pending.columns["v"][:] = rng.random(1000)
        refs = pending.publish_slices([(0, 0), (0, 300), (300, 1000)])
    for ref in refs:
        plain, full = store.get_columns(ref), store.get_columns(ref, populate=True)
        assert plain.layout == full.layout and list(plain) == list(full) and plain.num_rows == full.num_rows
        for k in plain:
            np.testing.assert_array_equal(plain[k], full[k])
        if packed:
            for a, b in zip(port_store.iter_packed_batches(plain), port_store.iter_packed_batches(full)):
                np.testing.assert_array_equal(a.packed, b.packed)
    store.free(refs)
    store.cleanup()


class _FailingConsumer(port_shuffle.BatchConsumer):
    """Frees what it is given, and raises at its first delivery of
    ``fail_epoch``."""

    def __init__(self, fail_epoch):
        self.fail_epoch = fail_epoch
        self.rows = {}

    def consume(self, rank, epoch, batches):
        store = port_runtime.get_context().store
        for ref in batches:
            cb = store.get_columns(ref)
            rows = port_store.iter_packed_batches(cb) if port_store.is_device_batch(cb) else [cb]
            self.rows[epoch] = self.rows.get(epoch, 0) + sum(b.num_rows for b in rows)
        store.free(batches)
        if epoch == self.fail_epoch:
            raise RuntimeError("consumer failed")

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


@pytest.mark.parametrize("index", ["on", "off"])
def test_store_is_empty_after_a_cached_run_and_a_failed_one(files, monkeypatch, index):
    monkeypatch.setenv("RSDL_INDEX_SHUFFLE", index)
    layout = {"batch": BATCH, "columns": [KEY_COLUMN]}
    done = _FailingConsumer(fail_epoch=None)
    log = []
    seconds = port_shuffle.shuffle(files, done, 3, NUM_REDUCERS, 2, seed=SEED, narrow_to_32=True,
                                   cache_decoded=True, schedule_log=log, device_layout=layout)
    assert seconds > 0 and done.rows == {e: NUM_ROWS for e in range(3)}
    assert [s for _, s in log] == ["mapreduce"] + ["index" if index == "on" else "mapreduce"] * 2
    assert port_runtime.store_stats().num_objects == 0
    failing = _FailingConsumer(fail_epoch=1)
    with pytest.raises(RuntimeError, match="consumer failed"):
        port_shuffle.shuffle(files, failing, 3, NUM_REDUCERS, 2, seed=SEED, narrow_to_32=True,
                             cache_decoded=True, device_layout=layout)
    assert failing.rows[0] == NUM_ROWS
    assert port_runtime.store_stats().num_objects == 0


def test_a_caching_map_that_fails_frees_its_cache_segment(files, monkeypatch):
    """The map publishes the file's cache, then its partitions do not fit:
    it raises and leaves nothing in the store."""
    store = port_runtime.get_context().store
    create = store.create_columns
    calls = []

    def second_does_not_fit(spec, layout=None, **kwargs):
        calls.append(spec)
        if len(calls) == 2:
            raise port_store.StoreFullError(store.shm_dir, 1, 0)
        return create(spec, layout, **kwargs)

    monkeypatch.setattr(store, "create_columns", second_does_not_fit)
    with pytest.raises(port_store.StoreFullError):
        port_shuffle.shuffle_map(files[0], 0, NUM_REDUCERS, 0, SEED, True, None, True)
    assert len(calls) == 2 and port_runtime.store_stats().num_objects == 0
