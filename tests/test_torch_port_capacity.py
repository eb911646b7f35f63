"""The port's capacity ledger against the JAX package's
``telemetry/capacity.py``, and the port's store hooks.

Parity: seeded op logs (creates and fetches on every tier, hardlinked
segments, deletes of any link, tier transitions, touches, clean-ups,
jobs) through both modules' ``ledger`` (``now`` injected) and
``live_segments``; ``view`` and two ticks of ``publish_metrics``' gauges
over one host sample; the live fold and ``status_section`` over one
spool; and the port's spool records read by the JAX package.

The port alone, as the JAX tests do: the store's publish, read, free and
clean-up hooks with the epoch and tier of each segment (``shm``,
``spill``, ``cache``), hardlinked windows freed at the last link, a read
stamping the segment, a foreign window's fetch and drop; and a metered
shuffle with the shared decode cache whose fold, at the run's end,
holds exactly the bytes the store holds, by tier.

Comparisons are exact."""

import importlib
import os

import numpy as np
import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
ENV = ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_SHM_DIR", "RSDL_SPILL_DIR", "RSDL_TRACE",
       "RSDL_STORE_CAPACITY_BYTES", "RSDL_STORE_CAPACITY_FRACTION", "RSDL_DECODE_CACHE_SHARED", "RSDL_PROFILE",
       "RSDL_TS", "RSDL_INDEX_SHUFFLE")
HOST = {"rss_bytes": 123456789, "shm_free_bytes": 9_000_000, "spill_free_bytes": 50_000_000}


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _refresh():
    for pkg in ROOTS:
        _mod(pkg, "telemetry.metrics").refresh_from_env()
        _mod(pkg, "telemetry.metrics").reset()
        _mod(pkg, "telemetry.capacity").reset()
        _mod(pkg, "telemetry.trace").reset_state()


@pytest.fixture
def spool(monkeypatch, tmp_path):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("RSDL_EVENTS_DIR", str(tmp_path / "events"))
    monkeypatch.setenv("RSDL_SHM_DIR", str(tmp_path / "shm"))
    monkeypatch.setenv("RSDL_SPILL_DIR", str(tmp_path / "spill"))
    _refresh()
    yield str(tmp_path / "metrics")
    monkeypatch.undo()
    _refresh()


def _ops(seed, n=150):
    """A seeded op log: segments of one or three links created or fetched
    on a tier of the three under an epoch (or none) and a job (or none),
    then links deleted, segments moved, touched, and at times a clean-up."""
    rng = np.random.default_rng(seed)
    tiers, out, live, ts = ("shm", "spill", "cache"), [], [], 0.0
    for i in range(n):
        ts += float(rng.uniform(0.01, 1.0))
        r = rng.random()
        if r < 0.4 or not live:
            ids = [f"s{i}l{j}" for j in range(int(rng.choice([1, 3])))]
            rec = {"ts": ts, "op": "fetch" if rng.random() < 0.2 else "create", "id": f"s{i}", "pid": 1,
                   "nbytes": int(rng.integers(1, 1 << 20)), "tier": tiers[int(rng.integers(3))]}
            if len(ids) > 1:
                rec["ids"] = ids
            else:
                ids = [rec["id"]]
            if rng.random() < 0.85:
                rec["epoch"] = int(rng.integers(4))
            if rng.random() < 0.3:
                rec["job"] = f"job-{int(rng.integers(2))}"
            out.append(rec)
            live.append(ids)
        elif r < 0.75:
            ids = live[int(rng.integers(len(live)))]
            link = ids.pop(int(rng.integers(len(ids))))
            if not ids:
                live.remove(ids)
            out.append({"ts": ts, "op": "delete", "id": link, "pid": 2})
        elif r < 0.85:
            ids = live[int(rng.integers(len(live)))]
            out.append({"ts": ts, "op": "transition", "id": ids[0], "pid": 1, "tier": tiers[int(rng.integers(3))]})
        elif r < 0.98:
            ids = live[int(rng.integers(len(live)))]
            out.append({"ts": ts, "op": "touch", "id": ids[-1], "pid": 3})
        else:
            out.append({"ts": ts, "op": "cleanup", "id": "sess", "pid": 1})
            live = []
    out.append({"ts": ts, "op": "delete", "id": "never-made", "pid": 2})
    order = rng.permutation(len(out))  # the fold sorts by time
    return [out[i] for i in order]


@pytest.mark.parametrize("seed", range(4))
def test_fold_matches_jax(seed):
    ops = _ops(seed)
    now = max(r["ts"] for r in ops) + 5.0
    got = {pkg: (_mod(pkg, "telemetry.capacity").ledger(records=ops, now=now),
                 _mod(pkg, "telemetry.capacity").live_segments(records=ops)) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    assert got["port"][0]["ops"] == len(ops)


def test_view_and_gauges_match_jax(spool, monkeypatch):
    ops = _ops(9)
    now = max(r["ts"] for r in ops) + 1.0
    later = ops + [{"ts": now, "op": "cleanup", "id": "sess", "pid": 1}]
    got = {}
    for pkg in ROOTS:
        cap, metrics = _mod(pkg, "telemetry.capacity"), _mod(pkg, "telemetry.metrics")
        monkeypatch.setattr(cap, "host_sample", lambda: dict(HOST))
        first = cap.view(records=ops, now=now)
        cap.publish_metrics(first)
        snap1 = metrics.registry.snapshot()
        second = cap.view(records=later, now=now + 1.0)
        cap.publish_metrics(second)
        got[pkg] = (first, snap1, second, metrics.registry.snapshot())
    assert got["port"] == got["jax"]
    assert 0 < got["port"][0]["shm_used_frac"] < 1 and got["port"][2]["live_segments"] == 0


def test_live_fold_and_status_match_jax(spool, monkeypatch):
    """The port's ledger spool, written by its ``note``/``flush``, read
    live by both packages; and by the JAX package from the path."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

    ops = sorted(_ops(5), key=lambda r: r["ts"])
    for rec in ops:
        capacity.note(rec["op"], rec["id"], nbytes=rec.get("nbytes", 0), tier=rec.get("tier"), ids=rec.get("ids"),
                      epoch=rec.get("epoch"))
    capacity.flush()
    got = {}
    for pkg in ROOTS:
        cap = _mod(pkg, "telemetry.capacity")
        monkeypatch.setattr(cap, "host_sample", lambda: dict(HOST))
        loaded = [{k: v for k, v in r.items() if k != "ts"} for r in cap.load_records()]
        got[pkg] = (loaded, cap.ledger(now=1e10)["totals"], cap.status_section(limit=2))
    assert got["port"] == got["jax"] and len(got["port"][0]) == len(ops)
    jax_cap = _mod("jax", "telemetry.capacity")
    assert len(jax_cap.load_records(path=capacity.spool_dir())) == len(ops)


# -- the port's store hooks ----------------------------------------------------------


def _store(name, **kw):
    from ray_shuffling_data_loader_tpu_torch.runtime.store import ObjectStore

    return ObjectStore(name, **kw)


def test_store_hooks_attribute_epoch_and_tier(spool):
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity, trace

    store = _store("capsess")
    with trace.context(epoch=7):
        ref = store.put_columns({"a": np.arange(16, dtype=np.int32)})
        cached = store.put_columns({"a": np.arange(8, dtype=np.int32)}, ledger_tier="cache")
    store.capacity_bytes = 1  # every later segment spills
    with trace.context(epoch=8):
        spilled = store.put_columns({"a": np.arange(4, dtype=np.int32)})
    assert store.tier_of(os.path.join(store.spill_dir, spilled.object_id)) == "spill"
    folded = capacity.ledger()
    assert folded["epochs"]["7"]["shm"] == {"resident_bytes": ref.nbytes, "segments": 1, "hwm_bytes": ref.nbytes,
                                            "created_bytes": ref.nbytes, "fetched_bytes": 0, "freed_bytes": 0,
                                            "oldest_age_s": folded["epochs"]["7"]["shm"]["oldest_age_s"]}
    assert folded["epochs"]["7"]["cache"]["resident_bytes"] == cached.nbytes
    assert folded["epochs"]["8"]["spill"]["resident_bytes"] == spilled.nbytes
    stats = store.store_stats()
    totals = folded["totals"]
    assert sum(t["resident_bytes"] for t in totals.values()) == stats.total_bytes
    assert totals["spill"]["resident_bytes"] == stats.spill_bytes
    store.free([ref, cached, spilled])
    folded = capacity.ledger()
    assert all(t["resident_bytes"] == 0 for t in folded["totals"].values()) and folded["live_segments"] == 0
    assert folded["epochs"]["7"]["shm"]["freed_bytes"] == ref.nbytes


def test_hardlinked_windows_free_at_the_last_link(spool):
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity, trace

    store = _store("linksess")
    with trace.context(epoch=3):
        pending = store.create_columns({"a": ((9,), np.int32)})
        refs = pending.publish_slices([(0, 3), (3, 6), (6, 9)])
    (seg,) = capacity.live_segments()
    assert seg["ids"] == sorted(r.object_id for r in refs) and seg["epoch"] == "3"
    store.free(refs[1])
    store.free(refs[0])
    assert capacity.ledger()["epochs"]["3"]["shm"]["segments"] == 1
    store.free(refs[2])
    cell = capacity.ledger()["epochs"]["3"]["shm"]
    assert cell["resident_bytes"] == 0 and cell["freed_bytes"] == pending.nbytes
    assert store.store_stats().num_objects == 0


def test_reads_touch_and_cleanup_drops_everything(spool, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

    monkeypatch.setattr(capacity, "_TOUCH_INTERVAL_S", 0.0)
    store = _store("touchsess")
    ref = store.put_columns({"a": np.arange(64, dtype=np.int32)})
    pending = store.create_columns({"b": ((32,), np.int32)})
    sliced = pending.publish_slices([(0, 16), (16, 32)])
    before = {s["id"]: s["last_touch"] for s in capacity.live_segments()}
    assert store.get_columns(ref)["a"][5] == 5 and store.get_columns(sliced[1]).num_rows == 16
    after = {s["id"]: s["last_touch"] for s in capacity.live_segments()}
    assert all(after[k] >= before[k] for k in before)
    assert sum(r["op"] == "touch" for r in capacity.load_records()) == 2
    # Another session's sweep deletes by name and leaves this fold alone.
    other = _store("othersess")
    other.put_columns({"c": np.arange(4, dtype=np.int32)})
    store.cleanup(session="othersess")
    assert capacity.ledger()["live_segments"] == 2
    store.cleanup()
    assert capacity.ledger()["live_segments"] == 0 and store.store_stats().num_objects == 0


def test_foreign_window_fetch_and_drop(spool, tmp_path):
    """A window of another host's segment, pulled into a cache here:
    a ``fetch`` under the reader's cache name, deleted by ``drop_cache``."""
    from ray_shuffling_data_loader_tpu_torch.runtime.store import map_segment_file, serialize_columns
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

    owner = _store("ownersess", shm_dir=str(tmp_path / "owner-shm"))
    owner.owner_address = ("tcp", "owner", 1)
    src = owner.put_columns({"a": np.arange(40, dtype=np.int32)})
    from dataclasses import replace

    window = replace(src, rows=(10, 20))
    reader = _store("readersess")
    reader.owner_address = ("tcp", "reader", 2)

    def fetch(ref):
        cb = map_segment_file(os.path.join(owner.shm_dir, ref.object_id)).slice(*ref.rows)
        return serialize_columns({k: np.ascontiguousarray(v) for k, v in cb.columns.items()})

    reader.remote_fetch = fetch
    assert list(reader.get_columns(window)["a"]) == list(range(10, 20))
    fetched = [r for r in capacity.load_records() if r["op"] == "fetch"]
    assert len(fetched) == 1 and fetched[0]["id"] == reader._cache_name(window)
    cell = capacity.ledger()["totals"]["shm"]
    assert cell["fetched_bytes"] == fetched[0]["nbytes"] == reader.store_stats().total_bytes
    reader.drop_cache(window)
    assert capacity.ledger()["live_segments"] == 1  # the owner's segment, not the cache
    assert reader.store_stats().num_objects == 0
    owner.cleanup()


def test_metered_shuffle_fold_equals_the_store(spool, monkeypatch, tmp_path):
    """A metered two-epoch delivery with the shared decode cache: at the
    run's end the fold's resident bytes, by tier, are the store's, the
    cache tier holds the cache's segments, every epoch has a high
    watermark; once the shared tier is freed, nothing is resident."""
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch import shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

    monkeypatch.setenv("RSDL_DECODE_CACHE_SHARED", "on")
    port.runtime.init(num_workers=2)
    try:
        files, _ = port.generate_data(6000, 3, 1, 0.0, str(tmp_path / "data"))
        ds = port.DeviceShufflingDataset(files, 2, 1, 1000, 0, feature_columns=["key"], label_column=port.LABEL_COLUMN,
                                         num_reducers=2, device="cpu")
        for epoch in range(2):
            ds.set_epoch(epoch)
            keys = np.concatenate([f["key"].numpy() for f, _ in ds])
            assert np.array_equal(np.sort(keys), np.arange(6000))
        ds.join(timeout=60)
        stats = port.runtime.store_stats()
        totals = capacity.ledger()["totals"]
        assert stats.num_objects == len(files) == len(shuffle._shared_cache_spared())
        assert totals["cache"]["resident_bytes"] == stats.total_bytes > 0
        assert totals["cache"]["segments"] == len(files)
        assert totals["shm"]["resident_bytes"] == totals["spill"]["resident_bytes"] == stats.spill_bytes == 0
        epochs = capacity.ledger()["epochs"]
        assert all(epochs[str(e)]["shm"]["hwm_bytes"] > 0 for e in range(2))
        shuffle.shared_decode_cache_clear(free=True)
        assert sum(t["resident_bytes"] for t in capacity.ledger()["totals"].values()) == 0
        assert port.runtime.store_stats().num_objects == 0
    finally:
        shuffle.shared_decode_cache_clear(free=True)
        port.runtime.shutdown()
