"""The audit plane on the port, against the JAX package: the digest math
bit for bit, each plan and schedule's per-epoch verdicts field for field,
the consumed and staged sides through the datasets, the injected fault,
strict mode, the reconcile's edge cases, and the audit switched off.

Each package runs in a session spawned after ``RSDL_AUDIT`` is set, with a
spool of its own. Every digest, row count, plan label and the two sample
figures (adjacent-pair retention, displacement) must be equal exactly
(tolerance 0); the source entropies, sums of logs whose order follows the
spool's record order, within 1e-12."""

import logging
import os
import json
import subprocess
import sys
import textwrap
import uuid

import hypothesis.extra.numpy as hnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_shuffling_data_loader_tpu import dataset as jax_dataset
from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
from ray_shuffling_data_loader_tpu.telemetry import audit as jax_audit
from ray_shuffling_data_loader_tpu_torch import runtime as port_runtime
from ray_shuffling_data_loader_tpu_torch import shuffle as port_shuffle
from ray_shuffling_data_loader_tpu_torch.data_generation import KEY_COLUMN, LABEL_COLUMN
from ray_shuffling_data_loader_tpu_torch.dataset import ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
from ray_shuffling_data_loader_tpu_torch.telemetry import audit as port_audit

import torch_port_helpers as helpers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ROWS, NUM_FILES, ROW_GROUPS, NUM_REDUCERS, NUM_TRAINERS, SEED = 6000, 4, 4, 4, 2, 5
BATCH = 720  # 8 JAX devices divide it, and the 240-row remainder
ENTROPY_TOL = 1e-12
EXACT = ("ok", "mismatch", "rows_mapped", "rows_reduced", "rows_delivered", "rows_consumed", "rows_staged",
         "map_digest", "reduce_digest", "delivered_digest", "delivered_seq", "consumed_digest", "plan",
         "adjacent_pair_retention", "mean_normalized_displacement")
CLOSE = ("source_entropy_mean", "source_entropy_min")


def _qname():
    return f"audit-{uuid.uuid4().hex[:8]}"


def assert_same_verdicts(port_v, jax_v):
    assert [v["epoch"] for v in port_v] == [v["epoch"] for v in jax_v]
    for p, j in zip(port_v, jax_v):
        assert {k: p.get(k) for k in EXACT} == {k: j.get(k) for k in EXACT}
        for k in CLOSE:
            assert (p.get(k) is None) == (j.get(k) is None), k
            if p.get(k) is not None:
                assert abs(p[k] - j[k]) <= ENTROPY_TOL, (k, p[k], j[k])
        assert set(p) == set(j)


# -- the digest math -------------------------------------------------------------------

DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64, np.bool_, np.float32,
          np.float64]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_digest_math_is_the_jax_packages(dtype, data):
    keys = data.draw(hnp.arrays(dtype, st.integers(0, 200)))
    offset = data.draw(st.integers(0, 2**40))
    np.testing.assert_array_equal(port_audit.hash_keys(keys), jax_audit.hash_keys(keys))
    for off in (offset, None):
        p, j = port_audit.StreamDigest(), jax_audit.StreamDigest()
        p.update(keys, offset=off)
        j.update(keys, offset=off)
        assert (p.count, p.xor, p.sum, p.seq, p.hex()) == (j.count, j.xor, j.sum, j.seq, j.hex())
    # Folding two halves at their offsets gives the whole's digest.
    half = len(keys) // 2
    whole, lo, hi = port_audit.StreamDigest(), port_audit.StreamDigest(), port_audit.StreamDigest()
    whole.update(keys, offset=offset)
    lo.update(keys[:half], offset=offset)
    hi.update(keys[half:], offset=offset + half)
    lo.merge(hi)
    assert (lo.count, lo.xor, lo.sum, lo.seq) == (whole.count, whole.xor, whole.sum, whole.seq)


def test_seq_is_order_sensitive():
    """Row-id keys sorted, reversed and with one crossed swap: three seq
    values, none 0. (The position salt is held by the parity above.)"""
    keys = np.arange(1000, dtype=np.int64)
    seqs = {}
    for name, arr in (("sorted", keys), ("reversed", keys[::-1]), ("swapped", keys.copy())):
        if name == "swapped":
            arr[3], arr[700] = arr[700], arr[3]
        d = port_audit.StreamDigest()
        d.update(arr, offset=0)
        seqs[name] = d.seq
    assert seqs["sorted"] != 0
    assert len(set(seqs.values())) == 3


def test_rank_mixing_keeps_ranks_apart():
    """Two ranks whose streams are the same rows in the same order: their
    seq digests are equal and would cancel under XOR, unless each is mixed
    with its rank first. The fold is the JAX package's."""
    d = port_audit.StreamDigest()
    d.update(np.arange(500), offset=0)
    recs = [{"rank": r, "seq": d.seq} for r in (0, 1)]
    assert port_audit._rank_mixed_seq(recs) != 0
    rng = np.random.default_rng(0)
    recs = [{"rank": int(rng.integers(4)), "seq": int(rng.integers(2**63))} for _ in range(20)]
    assert port_audit._rank_mixed_seq(recs) == jax_audit._rank_mixed_seq(recs)


# -- the reconcile on records made here (no spool) -----------------------------------------


@pytest.fixture
def in_memory(monkeypatch):
    """Both audit modules with their records in this process only."""
    monkeypatch.delenv("RSDL_AUDIT_DIR", raising=False)
    monkeypatch.delenv("RSDL_AUDIT_STRICT", raising=False)
    for mod in (port_audit, jax_audit):
        mod.reset()
    yield
    for mod in (port_audit, jax_audit):
        mod.reset()


def _record_epoch(mod, retried: bool):
    """One epoch of 100 keys over 2 files, 2 reducers and one rank; with
    ``retried``, every record of a map, a reduce and a delivery twice (a
    stage that ran again)."""
    keys = np.arange(100, dtype=np.int64)
    times = 2 if retried else 1
    for _ in range(times):
        mod.record_map(0, 0, {"key": keys[:50]}, per_reducer=[20, 30])
        mod.record_reduce(0, 0, {"key": keys[::2]})
        mod.record_deliver(0, 0, 0, {"key": keys[::2]}, 0)
    mod.record_map(0, 1, {"key": keys[50:]}, per_reducer=[30, 20])
    mod.record_reduce(0, 1, {"key": keys[1::2]})
    mod.record_deliver(0, 1, 0, {"key": keys[1::2]}, 50)


def test_retried_records_fold_once(in_memory):
    for mod in (port_audit, jax_audit):
        _record_epoch(mod, retried=True)
    (verdict,) = port_audit.reconcile([0])
    assert verdict["ok"] is True and verdict["rows_mapped"] == verdict["rows_delivered"] == 100
    assert_same_verdicts([verdict], jax_audit.reconcile([0]))
    port_audit.reset()
    _record_epoch(port_audit, retried=False)
    assert port_audit.reconcile([0])[0]["delivered_seq"] == verdict["delivered_seq"]


def test_missing_worker_records_and_empty_epochs_are_not_verified(in_memory):
    port_audit.record_deliver(0, 0, 0, {"key": np.arange(10)}, 0)
    v0, v1 = port_audit.reconcile([0, 1])
    assert v0["ok"] is None and "map/reduce records missing" in v0["detail"] and v0["rows_delivered"] == 10
    assert v1 == {"epoch": 1, "ok": None, "detail": "no records", "rows_mapped": 0, "rows_reduced": 0,
                  "rows_delivered": 0}
    jax_audit.record_deliver(0, 0, 0, {"key": np.arange(10)}, 0)
    assert [v0, v1] == jax_audit.reconcile([0, 1])
    assert port_audit.summary()["ok"] is None


def test_summary_is_none_when_nothing_was_audited(in_memory):
    assert port_audit.summary() == {"ok": None, "mismatch_epochs": [], "epochs": []}
    assert port_audit.summary() == jax_audit.summary()


def test_stats_collector_hears_each_verdict(in_memory):
    heard = []

    class Collector:
        def call_oneway(self, method, *args):
            heard.append((method, *args))

    _record_epoch(port_audit, retried=False)
    (verdict,) = port_audit.reconcile([0], stats_collector=Collector(), plan_label="block:3")
    assert verdict["plan"] == "block:3"
    assert heard == [("audit_epoch", 0, verdict)]


# -- whole runs of both packages ----------------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    yield from helpers.audited_sessions(tmp_path_factory, NUM_ROWS, NUM_FILES, ROW_GROUPS, NUM_REDUCERS,
                                        NUM_TRAINERS, SEED)


LAYOUT = {"batch": 500, "columns": [KEY_COLUMN, LABEL_COLUMN]}
# (id, environment, shuffle() arguments, the port's schedules)
OFF = {"RSDL_INDEX_SHUFFLE": "off"}  # the materialized schedule, not the host probe's choice
RUNS = [
    ("rowwise", OFF, {}, ["mapreduce", "mapreduce"]),
    ("block:2", {**OFF, "RSDL_SHUFFLE_PLAN": "block:2"}, {}, ["mapreduce", "mapreduce"]),
    ("index", {"RSDL_INDEX_SHUFFLE": "on"}, {"cache_decoded": True}, ["mapreduce", "index"]),
    ("selective", {"RSDL_SHUFFLE_PLAN": "block:1", "RSDL_SELECTIVE_READS": "on"}, {"narrow_to_32": True},
     ["selective", "selective"]),
    ("packed", OFF, {"device_layout": LAYOUT, "narrow_to_32": True}, ["mapreduce", "mapreduce"]),
    ("packed_index", {"RSDL_INDEX_SHUFFLE": "on"}, {"device_layout": LAYOUT, "narrow_to_32": True,
                                                    "cache_decoded": True}, ["mapreduce", "index"]),
    ("columns_without_key", OFF, {"columns": [LABEL_COLUMN, "embeddings_name0"]}, ["mapreduce", "mapreduce"]),
]


@pytest.mark.parametrize("env,kwargs,schedules", [r[1:] for r in RUNS], ids=[r[0] for r in RUNS])
def test_verdicts_are_the_jax_packages(both, monkeypatch, env, kwargs, schedules):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax_v, _ = both.run("jax", **kwargs)
    log, stats = [], {}
    port_v, consumer = both.run("port", schedule_log=log, stats=stats, **kwargs)
    assert [s for _, s in log] == schedules
    assert [v["ok"] for v in port_v] == [True, True]
    assert all(v["rows_mapped"] == v["rows_delivered"] == NUM_ROWS for v in port_v)
    assert port_v[1]["adjacent_pair_retention"] is not None
    assert_same_verdicts(port_v, jax_v)
    if "device_layout" in kwargs:
        assert consumer.pieces > 1  # a reducer delivered a packed head, body or tail
    if "columns" in kwargs:
        assert stats["columns"] == [LABEL_COLUMN, "embeddings_name0", KEY_COLUMN]


def test_drop_row_is_caught_in_its_epoch_and_strict_mode_raises(both, monkeypatch):
    for mod in (jax_audit, port_audit):
        mod.inject_fault("drop-row", 1)
    jax_v, _ = both.run("jax")
    port_v, _ = both.run("port")
    assert [v["ok"] for v in port_v] == [True, False]
    assert port_v[1]["mismatch"] == ["delivered"] and port_v[1]["rows_delivered"] == NUM_ROWS - 1
    assert_same_verdicts(port_v, jax_v)
    monkeypatch.setenv("RSDL_AUDIT_STRICT", "1")
    port_audit.inject_fault("drop-row", 0)
    with pytest.raises(port_audit.AuditError, match=r"epoch\(s\) \[0\]"):
        both.run("port", num_epochs=1)


def _iterate(ds, num_epochs=2):
    for epoch in range(num_epochs):
        ds.set_epoch(epoch)
        for _ in ds:
            pass


def test_consumed_side_through_the_shuffling_dataset(both):
    with both.use("jax"):
        jds = jax_dataset.ShufflingDataset(both.files, 2, 1, BATCH, 0, num_reducers=NUM_REDUCERS, seed=SEED,
                                           queue_name=_qname())
        _iterate(jds)
    jax_v = jax_audit.verdicts()
    ds = ShufflingDataset(both.files, 2, 1, BATCH, 0, num_reducers=NUM_REDUCERS, seed=SEED, queue_name=_qname())
    _iterate(ds)
    ds.join()
    port_v = port_audit.verdicts()
    assert [v["rows_consumed"] for v in port_v] == [NUM_ROWS, NUM_ROWS]
    assert all(v["ok"] and v["consumed_digest"] == v["delivered_digest"] for v in port_v)
    assert_same_verdicts(port_v, jax_v)


def test_staged_side_through_the_device_dataset(both):
    spec = dict(feature_columns=[KEY_COLUMN], label_column=LABEL_COLUMN, num_reducers=NUM_REDUCERS, seed=SEED,
                drop_last=False)
    with both.use("jax"):
        jds = JaxShufflingDataset(both.files, 2, 1, BATCH, 0, queue_name=_qname(), **spec)
        _iterate(jds)
    jax_v = jax_audit.verdicts()
    ds = DeviceShufflingDataset(both.files, 2, 1, BATCH, 0, queue_name=_qname(), device="cpu", **spec)
    _iterate(ds)
    ds.join()
    port_v = port_audit.verdicts()
    assert ds.stats.batches_direct > 0  # the packed path's batches were staged and digested too
    assert [(v["ok"], v["rows_staged"], v["rows_consumed"]) for v in port_v] == [(True, NUM_ROWS, NUM_ROWS)] * 2
    assert_same_verdicts(port_v, jax_v)


def test_pool_workers_load_no_torch_with_the_audit_on(both):
    both.run("port", num_epochs=1)
    pool = port_runtime.get_context().pool
    for fut in [pool.submit(helpers.loaded_modules) for _ in range(4)]:
        mods = fut.result(timeout=60)
        assert "ray_shuffling_data_loader_tpu_torch.telemetry.audit" in mods
        assert not [m for m in mods if m == "torch" or m.startswith("torch.")]


def _write_keyless(directory, n=400):
    names = []
    for i in range(2):
        path = os.path.join(directory, f"keyless_{i}.parquet")
        pq.write_table(pa.table({"a": np.arange(i * n, (i + 1) * n, dtype=np.int64),
                                 LABEL_COLUMN: np.zeros(n, np.float64)}), path)
        names.append(path)
    return names


def test_a_keyless_dataset_warns_and_does_not_fail(both, tmp_path, monkeypatch, caplog):
    files = _write_keyless(str(tmp_path))
    monkeypatch.setattr(port_audit, "_warned_no_key", False)
    caplog.set_level(logging.WARNING, logger=port_audit.__name__)
    stats = {}
    with both.use("port"):
        port_shuffle.shuffle(files, helpers.Drain(port_runtime), 1, 2, 1, seed=1, columns=["a"], stats=stats)
    assert stats["columns"] == ["a", KEY_COLUMN]  # appended, and tolerated where the files lack it
    assert [v["ok"] for v in port_audit.verdicts()] == [None]
    assert "key column 'key' not present" in caplog.text
    # Only the audit key is tolerated: any other missing name raises.
    with both.use("port"), pytest.raises(Exception, match="nope"):
        port_shuffle.shuffle(files, helpers.Drain(port_runtime), 1, 2, 1, seed=1, columns=["a", "nope"])


# -- the audit off ------------------------------------------------------------------------


def test_audit_off_does_no_digest_work_and_writes_no_spool(tmp_path):
    """In a fresh interpreter with ``RSDL_AUDIT`` unset and a spool named:
    the trainer's process never hashes a key, no process writes a spool
    file, and the pool's workers load no torch."""
    spool = tmp_path / "spool"
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        import ray_shuffling_data_loader_tpu_torch as port
        from ray_shuffling_data_loader_tpu_torch.telemetry import audit
        import torch_port_helpers

        calls = []

        def counting_hash(arr):
            calls.append(len(arr))
            raise AssertionError("hash_keys called with the audit off")

        if __name__ == "__main__":
            audit.hash_keys = counting_hash
            port.runtime.init(num_workers=2)
            files, _ = port.generate_data(3000, 2, 2, 0.0, {str(tmp_path / "data")!r})
            ds = port.DeviceShufflingDataset(files, 2, 1, 500, 0, feature_columns=["key"],
                                             label_column="labels", num_reducers=2, device="cpu", drop_last=False)
            rows = 0
            for epoch in range(2):
                ds.set_epoch(epoch)
                rows += sum(int(l.shape[0]) for _, l in ds)
            ds.join()
            mods = [port.runtime.get_context().pool.submit(torch_port_helpers.loaded_modules).result()
                    for _ in range(4)]
            print("OUT " + json.dumps({{"rows": rows, "calls": calls, "enabled": audit.enabled(),
                                        "worker_torch": any("torch" in m for m in mods)}}))
            port.runtime.shutdown()
    """)
    path = tmp_path / "off.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RSDL_", "JAX", "XLA"))}
    env["RSDL_AUDIT_DIR"] = str(spool)
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=120, env=env,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("OUT ")][-1]
    assert json.loads(line[4:]) == {"rows": 6000, "calls": [], "enabled": False, "worker_torch": False}
    assert not spool.exists() or not os.listdir(spool)
