"""The overlapped reduce (``RSDL_REDUCE_FETCH_OVERLAP``) and the store's
foreign side, against the port's fused path and the JAX package.

* Each reduce output, plain and packed, under ``on`` is bit-identical to
  the port's fused path and to the JAX package's ``shuffle_reduce`` under
  the same setting, for the rowwise and ``block:2`` plans at window depths
  1, 4 and more than the parts; the whole stream under ``on`` equals the
  fused one and the JAX package's for rowwise, ``block:2`` and the
  selective schedule (whose reduce reads Parquet, not windows: the knob
  leaves it as it is, in both packages).
* Foreign windows (another store's segments, fetched through the
  ``remote_fetch`` hook from an in-process store server): the overlapped
  reduce's output is the fused one's, at most ``depth`` windows are
  cached at once, and none is left after.
* ``needs_fetch`` and the ``prefetch`` tombstones behave as the JAX
  store's on the same steps.

Every comparison is exact.
"""

import importlib
import os
import threading

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu import runtime as jax_runtime
from ray_shuffling_data_loader_tpu.runtime import cluster as jax_cluster
from ray_shuffling_data_loader_tpu.runtime import store as jax_store
from ray_shuffling_data_loader_tpu_torch import native
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
from ray_shuffling_data_loader_tpu_torch.runtime import cluster as port_cluster
from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store

jax_sh = importlib.import_module("ray_shuffling_data_loader_tpu.shuffle")

NUM_ROWS, NUM_FILES, ROW_GROUPS, NUM_REDUCERS, SEED, EPOCH = 3000, 5, 4, 3, 23, 1
PLANS = {"rowwise": ("rowwise", 0), "block2": ("block", 2)}
KNOBS = ("RSDL_REDUCE_FETCH_OVERLAP", "RSDL_FETCH_WINDOW_DEPTH", "RSDL_SHUFFLE_PLAN", "RSDL_SELECTIVE_READS",
         "RSDL_INDEX_SHUFFLE", "RSDL_DISABLE_NATIVE", "RSDL_PLAN", "RSDL_AUDIT", "RSDL_JOURNAL")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both packages' sessions and a dataset of skewed row groups."""
    port_runtime.init(num_workers=2)
    fresh_jax = not jax_runtime.is_initialized()
    jax_runtime.init(num_workers=2)
    names, _ = generate_data(NUM_ROWS, NUM_FILES, ROW_GROUPS, 0.5, str(tmp_path_factory.mktemp("overlap")))
    yield names
    port_runtime.shutdown()
    if fresh_jax:
        jax_runtime.shutdown()


def _maps(pkg, files, plan):
    """Each file's map (narrowed, so that reducers can pack) in this
    process: per file, one window ref per reducer."""
    if pkg == "port":
        return [sh.shuffle_map(f, i, NUM_REDUCERS, EPOCH, SEED, True, plan=plan) for i, f in enumerate(files)]
    return [jax_sh.shuffle_map(f, i, NUM_REDUCERS, EPOCH, SEED, narrow_to_32=True, plan=plan)
            for i, f in enumerate(files)]


def _read(store, out):
    """An output's segments, as their raw columns (a packed body as its
    matrix), in delivery order."""
    refs = out if isinstance(out, list) else [out]
    return [{k: np.array(v) for k, v in store.get_columns(r).columns.items()} for r in refs]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _pack(files, packed):
    """A reducer's pack: its start in its rank's stream, off the batch
    grid, and a layout of three 4-byte columns."""
    if not packed:
        return None
    return (37, {"batch": 64, "columns": ["key", "labels", "embeddings_name0"]})


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("depth", [1, 4, NUM_FILES + 3])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_overlap_on_equals_fused_and_jax(files, monkeypatch, plan, depth, packed):
    plan_t = PLANS[plan]
    port_parts, jax_parts = _maps("port", files, plan_t), _maps("jax", files, plan_t)
    port_store_, jax_store_ = port_runtime.get_context().store, jax_runtime.get_context().store
    knobs = {"fetch_window_depth": depth}
    monkeypatch.setenv("RSDL_REDUCE_FETCH_OVERLAP", "on")
    try:
        for r in range(NUM_REDUCERS):
            refs = [p[r] for p in port_parts]
            pack = _pack(files, packed)
            before = native.counts()
            overlapped = sh.shuffle_reduce(r, EPOCH, SEED, refs, pack, knobs=knobs, overlap="on")
            calls = native.counts_since(before)
            fused = sh.shuffle_reduce(r, EPOCH, SEED, refs, pack, knobs=knobs, overlap="off")
            jax_out = jax_sh.shuffle_reduce(r, EPOCH, SEED, [p[r] for p in jax_parts], pack=pack, knobs=knobs)
            got = _read(port_store_, overlapped)
            _assert_same(got, _read(port_store_, fused))
            _assert_same(got, _read(jax_store_, jax_out))
            if packed:
                assert len(got) >= 2 and port_store.PACKED_COLUMN in got[1 if "key" in got[0] else 0]
            # The overlapped path places by scatter, the fused one gathers.
            assert calls["native"]["scatter"] + calls["plain"]["scatter"] > 0
            assert calls["native"]["take_multi"] + calls["plain"]["take_multi"] == 0
            for out in (overlapped, fused):
                port_store_.free(out if isinstance(out, list) else [out])
            jax_store_.free(jax_out if isinstance(jax_out, list) else [jax_out])
    finally:
        for parts in port_parts:
            port_store_.free(parts)
        for parts in jax_parts:
            jax_store_.free(parts)


def test_overlap_mode_parsing(monkeypatch):
    for value, want in (("on", "on"), ("1", "on"), ("TRUE", "on"), ("off", "off"), ("0", "off"), ("auto", "auto"),
                        ("", "auto"), ("junk", "auto")):
        monkeypatch.setenv("RSDL_REDUCE_FETCH_OVERLAP", value)
        assert sh.reduce_fetch_overlap_mode() == want, value
    monkeypatch.delenv("RSDL_REDUCE_FETCH_OVERLAP")
    assert sh.reduce_fetch_overlap_mode() == "auto"
    assert sh._fetch_window_depth() == 4 and sh._fetch_window_depth({"fetch_window_depth": 0}) == 1
    monkeypatch.setenv("RSDL_FETCH_WINDOW_DEPTH", "7")
    assert sh._fetch_window_depth() == 7 == jax_sh._fetch_window_depth()
    assert sh._fetch_window_depth({"fetch_window_depth": 2}) == 2 == jax_sh._fetch_window_depth({"fetch_window_depth": 2})


class _Keys(sh.BatchConsumer):
    def __init__(self, rt):
        self.rt, self.keys = rt, {}

    def consume(self, rank, epoch, batches):
        store = self.rt.get_context().store
        for ref in batches:
            cols = port_store.logical_columns(store.get_columns(ref)) if self.rt is port_runtime else (
                jax_store.logical_columns(store.get_columns(ref)))
            self.keys.setdefault((epoch, rank), []).append(np.array(cols["key"]))
        store.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


@pytest.mark.parametrize("schedule", ["rowwise", "block2", "selective"])
def test_stream_under_overlap_equals_fused_and_jax(files, monkeypatch, schedule):
    """The whole stream (2 epochs, 2 ranks, packed outputs): ``on`` as
    ``off`` and as the JAX package's; the stage tasks take the driver's
    setting (the pool spawned before it was set)."""
    env = {"rowwise": {}, "block2": {"RSDL_SHUFFLE_PLAN": "block:2"},
           "selective": {"RSDL_SHUFFLE_PLAN": "block:2", "RSDL_SELECTIVE_READS": "on"}}[schedule]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    layout = {"batch": 50, "columns": ["key", "labels"]}
    streams, calls = {}, {}
    for mode in ("on", "off"):
        monkeypatch.setenv("RSDL_REDUCE_FETCH_OVERLAP", mode)
        consumer, stats, log = _Keys(port_runtime), {}, []
        sh.shuffle(list(files), consumer, 2, NUM_REDUCERS, 2, seed=SEED, narrow_to_32=True, cache_decoded=False,
                   device_layout=layout, schedule_log=log, stats=stats)
        streams[mode], calls[mode] = consumer.keys, stats["native_calls"]
        assert [s for _, s in log] == (["selective"] * 2 if schedule == "selective" else ["mapreduce"] * 2)
    monkeypatch.delenv("RSDL_REDUCE_FETCH_OVERLAP")
    jax_consumer = _Keys(jax_runtime)
    jax_sh.shuffle(list(files), jax_consumer, 2, NUM_REDUCERS, 2, seed=SEED, narrow_to_32=True,
                   device_layout=layout, cache_decoded=False)
    assert sorted(streams["on"]) == sorted(jax_consumer.keys)
    for key, want in jax_consumer.keys.items():
        np.testing.assert_array_equal(np.concatenate(streams["on"][key]), np.concatenate(want), err_msg=str(key))
        np.testing.assert_array_equal(np.concatenate(streams["off"][key]), np.concatenate(want), err_msg=str(key))
    if schedule != "selective":
        assert calls["on"]["scatter"] > 0 and calls["off"]["scatter"] == 0
    else:  # the selective reduce has no windows to overlap
        assert calls["on"]["scatter"] == calls["off"]["scatter"] == 0


# -- foreign windows ----------------------------------------------------------------------


class _Owner:
    """Another host, in this process: a store on its own directory and a
    store server over it, reached through the reader store's hooks."""

    def __init__(self, tmp_path, store_mod, cluster_mod, name):
        self.dir = str(tmp_path / f"owner-{name}")
        self.store = store_mod.ObjectStore(f"own{name}", shm_dir=self.dir)
        self.store.owner_address = ("tcp", "owner", 1)
        self.server = cluster_mod.StoreServer(self.dir)
        self.freed = []
        self.gate = None  # an Event that fetches wait on, when set

    def fetch(self, ref):
        if self.gate is not None:
            self.gate.wait(30)
        return self.server.fetch(ref.object_id, ref.rows)

    def wire(self, reader):
        reader.owner_address = ("tcp", "reader", 1)
        reader.remote_fetch = self.fetch
        reader.remote_free = lambda ref: self.freed.append(ref.object_id)


def _caches(directory):
    return sorted(n for n in os.listdir(directory) if "-cache-" in n and ".fetch-" not in n)


def test_a_read_waits_for_the_prefetch_of_its_window(tmp_path):
    """A reader that asks for a window while a prefetch of it is in flight
    waits for that pull instead of fetching it again (slow pulls under
    load fetched a window twice and overran the read-ahead's bound)."""
    owner = _Owner(tmp_path, port_store, port_cluster, "w")
    reader = port_store.ObjectStore("rdr", shm_dir=str(tmp_path / "reader"))
    owner.wire(reader)
    calls = []
    fetch = owner.fetch

    def counted(ref):
        calls.append(ref.object_id)
        return fetch(ref)

    reader.remote_fetch = counted
    ref = owner.store.put_columns({"v": np.arange(1000, dtype=np.int64)})
    owner.gate = threading.Event()
    try:
        (pull,) = reader.prefetch([ref])
        got = []
        read = threading.Thread(target=lambda: got.append(reader.get_columns(ref)["v"].copy()))
        read.start()
        read.join(0.3)
        assert read.is_alive()  # waiting on the pull, not fetching
        owner.gate.set()
        read.join(30)
        assert not read.is_alive() and pull.done()
        assert np.array_equal(got[0], np.arange(1000)) and calls == [ref.object_id]
        assert reader.prefetch([ref]) == []  # cached: nothing to pull
    finally:
        owner.gate.set()
        reader.cleanup()
        owner.store.cleanup()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_foreign_windows_overlap_bounded(files, tmp_path, depth):
    """Windows of another store: the overlapped reduce fetches each once,
    caches at most ``depth`` at a time, drops them all, and writes the
    fused path's output."""
    owner = _Owner(tmp_path, port_store, port_cluster, "p")
    ctx = port_runtime.get_context()
    store = ctx.store
    saved = (store.owner_address, store.remote_fetch, store.remote_free)
    owner.wire(store)
    parts = []
    peak = []
    real = store._materialize_remote

    def materialize(ref, path):
        real(ref, path)
        peak.append(sum(len(_caches(d)) for d in (store.shm_dir, store.spill_dir) if os.path.isdir(d)))

    store._materialize_remote = materialize
    try:
        with port_runtime_store_as(owner.store):
            parts = [sh.shuffle_map(f, i, NUM_REDUCERS, EPOCH, SEED, True) for i, f in enumerate(files)]
        refs = [p[0] for p in parts]
        assert all(store.needs_fetch(r) for r in refs)
        knobs = {"fetch_window_depth": depth}
        out = sh.shuffle_reduce(0, EPOCH, SEED, refs, knobs=knobs, overlap="auto")
        fetched = len(peak)
        assert fetched >= len(refs) and max(peak) <= depth, (peak, depth)
        assert not _caches(store.shm_dir)
        got = _read(store, out)
        # The fused path on the owner's own refs (local there).
        with port_runtime_store_as(owner.store):
            want = _read(owner.store, sh.shuffle_reduce(0, EPOCH, SEED, refs, overlap="off"))
        _assert_same(got, want)
        store.free([out])
    finally:
        store._materialize_remote = real
        store.owner_address, store.remote_fetch, store.remote_free = saved
        owner.store.cleanup()


class port_runtime_store_as:
    """Swap the port session's store for ``store`` in this process (the
    stage functions take the session's)."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        ctx = port_runtime.get_context()
        self.saved, ctx.store = ctx.store, self.store

    def __exit__(self, *exc):
        port_runtime.get_context().store = self.saved


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_needs_fetch_and_prefetch_tombstones(tmp_path, pkg):
    """The same steps on either package's store give the same answers,
    listed in ``want``."""
    store_mod, cluster_mod = (port_store, port_cluster) if pkg == "port" else (jax_store, jax_cluster)
    owner = _Owner(tmp_path, store_mod, cluster_mod, pkg)
    reader = store_mod.ObjectStore(f"rd{pkg}", shm_dir=str(tmp_path / f"reader-{pkg}"))
    owner.wire(reader)
    cols = {"k": np.arange(100, dtype=np.int64)}
    ref = owner.store.put_columns(cols)
    win = owner.store.put_columns(cols)
    win = type(win)(win.object_id, win.nbytes, win.session, owner=win.owner, rows=(10, 30))
    local = reader.put_columns(cols)
    seen = [reader.needs_fetch(local), reader.is_foreign(local), reader.needs_fetch(ref), reader.is_foreign(ref)]
    # A read fetches once and caches; a window caches under its own name.
    np.testing.assert_array_equal(reader.get_columns(win)["k"], np.arange(10, 30))
    seen += [reader.needs_fetch(win), reader.needs_fetch(ref), len(_caches(reader.shm_dir))]
    reader.drop_cache([win, local])
    seen += [reader.needs_fetch(win), reader.exists(local), owner.freed == []]
    # A prefetch that lands after the ref was freed discards its copy.
    owner.gate = threading.Event()
    futs = reader.prefetch([ref, local, "not a ref"])
    seen.append(len(futs))
    reader.free([ref])
    owner.gate.set()
    for f in futs:
        f.result(30)
    seen += [_caches(reader.shm_dir), owner.freed == [ref.object_id]]
    # Asked again, the prefetch supersedes the tombstone and lands.
    owner.gate = None
    for f in reader.prefetch([ref]):
        f.result(30)
    seen += [len(_caches(reader.shm_dir)), reader.needs_fetch(ref), reader.prefetch([ref])]
    # A foreign segment that this host can map (a shared directory) needs
    # no fetch.
    shared = store_mod.ObjectStore(f"sh{pkg}", shm_dir=reader.shm_dir)
    shared.owner_address = ("tcp", "owner", 1)
    mapped = shared.put_columns(cols)
    seen += [reader.is_foreign(mapped), reader.needs_fetch(mapped), reader.prefetch([mapped])]
    want = [False, False, True, True, False, True, 1, True, True, True, 1, [], True, 1, False, [], True, False, []]
    assert seen == want
    reader.cleanup()
    owner.store.cleanup()
